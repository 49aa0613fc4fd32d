"""Global prefix index: chained block hash -> worker residency.

A copy of ``dynamo_tpu/kv_router/indexer.py`` (the reference's RadixTree
indexer, lib/llm/src/kv_router/indexer.rs:87-677) on its pure-Python
:class:`PrefixIndex`; the reference's C++ tree (``dynamo_tpu.native``,
behavior-identical) has no counterpart in the port yet. Because block
hashes are *chained* (hash includes the
whole prefix), the radix structure is implicit: looking up a sequence's
k-th chained hash is an O(1) dict probe, and a match at depth k implies
matches at all shallower depths. The index therefore stores a flat
``hash -> node`` map with parent/child links kept only for subtree
removal and per-worker cleanup — same behavior as the reference's tree,
one less traversal.

``KvIndexer`` wraps the structure in a single consumer task fed from the
bus (ref indexer.rs:499 mpsc pattern) so appliers never contend with
lookups; ``ShardedPrefixIndex`` hash-partitions across shards for
parallelism (ref KvIndexerSharded, indexer.rs:677).
"""

from __future__ import annotations

import asyncio
import logging
from collections import OrderedDict, defaultdict
from dataclasses import dataclass, field
from typing import Iterable, Optional

from ..engine.allocator import sequence_block_hashes
from .protocols import KV_EVENT_SUBJECT, RouterEvent

logger = logging.getLogger(__name__)


@dataclass
class OverlapScores:
    """worker_id -> number of consecutive prefix blocks resident
    (ref indexer.rs:239 OverlapScores).

    ``scores`` is tier-inclusive: a worker that demoted part of the
    chain to its host/disk tiers still counts (restore beats recompute
    — that residency is the fleet prefix cache). ``device_scores``
    holds the shallower device-only depth for workers known to have
    demoted inside their match; :meth:`device` falls back to the
    tier-inclusive score for everyone else."""

    scores: dict[int, int] = field(default_factory=dict)
    total_blocks: int = 0
    device_scores: dict[int, int] = field(default_factory=dict)

    def best(self) -> tuple[Optional[int], int]:
        if not self.scores:
            return None, 0
        wid = max(self.scores, key=lambda w: self.scores[w])
        return wid, self.scores[wid]

    def device(self, worker_id: int) -> int:
        return self.device_scores.get(
            worker_id, self.scores.get(worker_id, 0)
        )


@dataclass
class _Node:
    block_hash: int
    parent_hash: Optional[int]
    workers: set[int] = field(default_factory=set)
    children: set[int] = field(default_factory=set)


class PrefixIndex:
    def __init__(self):
        self._nodes: dict[int, _Node] = {}
        self._by_worker: dict[int, set[int]] = defaultdict(set)

    # ---- queries ----
    def find_matches(self, block_hashes: Iterable[int]) -> OverlapScores:
        """Walk the chained hashes in order; per worker, count how deep its
        residency extends (consecutive from the start)."""
        scores = OverlapScores()
        active: Optional[set[int]] = None
        n = 0
        for h in block_hashes:
            n += 1
            node = self._nodes.get(h)
            if node is None:
                break
            workers = node.workers if active is None else (node.workers & active)
            if not workers:
                break
            for w in workers:
                scores.scores[w] = scores.scores.get(w, 0) + 1
            active = set(workers)
        scores.total_blocks = n
        return scores

    @property
    def size(self) -> int:
        return len(self._nodes)

    def workers(self) -> list[int]:
        return sorted(self._by_worker)

    # ---- mutation ----
    def apply_event(self, ev: RouterEvent) -> None:
        kv = ev.event
        if kv.kind == "stored":
            parent = kv.parent_hash
            for blk in kv.blocks:
                node = self._nodes.get(blk.block_hash)
                if node is None:
                    node = self._nodes[blk.block_hash] = _Node(
                        blk.block_hash, parent
                    )
                    if parent is not None and parent in self._nodes:
                        self._nodes[parent].children.add(blk.block_hash)
                node.workers.add(ev.worker_id)
                self._by_worker[ev.worker_id].add(blk.block_hash)
                parent = blk.block_hash
        elif kv.kind == "removed":
            for h in kv.block_hashes:
                self._remove_worker_block(ev.worker_id, h)

    def _remove_worker_block(self, worker_id: int, block_hash: int) -> None:
        # iterative (explicit stack): chains reach thousands of blocks at
        # long context, far past Python's recursion limit
        stack = [block_hash]
        while stack:
            node = self._nodes.get(stack.pop())
            if node is None:
                continue
            node.workers.discard(worker_id)
            self._by_worker[worker_id].discard(node.block_hash)
            # a removed parent means the worker also dropped descendants it held
            for child in node.children:
                cnode = self._nodes.get(child)
                if cnode and worker_id in cnode.workers:
                    stack.append(child)
            if not node.workers:
                self._drop_node(node)

    def _drop_node(self, node: _Node) -> None:
        """Unlink a node and drop its whole subtree (descendants are
        unreachable in a prefix walk once the chain is broken)."""
        if node.parent_hash is not None:
            parent = self._nodes.get(node.parent_hash)
            if parent:
                parent.children.discard(node.block_hash)
        stack = [node]
        while stack:
            n = stack.pop()
            for child in n.children:
                cnode = self._nodes.get(child)
                if cnode is not None:
                    stack.append(cnode)
            for w in n.workers:  # keep per-worker bookkeeping in sync
                self._by_worker[w].discard(n.block_hash)
            self._nodes.pop(n.block_hash, None)

    def remove_worker(self, worker_id: int) -> None:
        """Full cleanup when a worker dies (ref indexer.rs:380)."""
        for h in list(self._by_worker.get(worker_id, ())):
            node = self._nodes.get(h)
            if node is None:
                continue
            node.workers.discard(worker_id)
            if not node.workers:
                # children sharing only this worker die via their own
                # by_worker entries; just unlink this node
                self._drop_node(node)
        self._by_worker.pop(worker_id, None)


class ShardedPrefixIndex:
    """Hash-partitioned by worker id: each worker's residency lives in one
    shard; queries fan out and merge (ref KvIndexerSharded)."""

    def __init__(self, shards: int = 4, factory=None):
        self._shards = [(factory or PrefixIndex)() for _ in range(shards)]

    def _shard(self, worker_id: int) -> PrefixIndex:
        return self._shards[worker_id % len(self._shards)]

    def apply_event(self, ev: RouterEvent) -> None:
        self._shard(ev.worker_id).apply_event(ev)

    def remove_worker(self, worker_id: int) -> None:
        self._shard(worker_id).remove_worker(worker_id)

    def find_matches(self, block_hashes) -> OverlapScores:
        hashes = list(block_hashes)
        merged = OverlapScores(total_blocks=len(hashes))
        for s in self._shards:
            part = s.find_matches(hashes)
            merged.scores.update(part.scores)
        return merged


def make_prefix_index(shards: int = 1):
    """PrefixIndex factory: one tree, or ``shards`` of them."""
    return PrefixIndex() if shards <= 1 else ShardedPrefixIndex(shards)


class KvIndexer:
    """Event-plane consumer: subscribes the component's kv_events subject
    and owns a PrefixIndex behind a queue (ref KvIndexer, indexer.rs:499).

    Tier tracking rides as an overlay, not in the tree: ``demoted``
    events (block left the device cache for the worker's offload tiers)
    flip a ``(worker, hash)`` membership set instead of touching the
    index, so the tree stays tier-blind (as the reference's Python and
    C++ trees both are). ``find_matches`` projects the
    overlay into ``OverlapScores.device_scores``."""

    def __init__(self, drt, component, shards: int = 1):
        self.drt = drt
        self.component = component
        self.index = make_prefix_index(shards=shards)
        self._task: Optional[asyncio.Task] = None
        self.events_applied = 0
        # (worker_id, block_hash) currently resident ONLY in the
        # worker's offload tiers; stored re-promotes, removed drops.
        # Insertion-ordered + capped: the tree's chain-cascade can
        # remove descendants a ``removed`` event never names, leaving
        # their overlay entries behind — stale entries are harmless to
        # correctness (any path that puts (w, h) back in the tree goes
        # through a stored event for exactly that pair, clearing it;
        # an orphaned entry only makes device_scores conservative) but
        # must not grow without bound on a long-lived router
        self._offloaded: "OrderedDict[tuple[int, int], None]" = OrderedDict()
        self._offloaded_cap = 1 << 18
        # per-worker event-id continuity: the publisher stamps a
        # monotonically increasing event_id, so a jump > 1 means the bus
        # dropped events and this router's radix view has silently
        # diverged from the worker's real residency until the next
        # stored/removed pair for the affected chains
        self.event_gaps = 0
        self._last_event_id: dict[int, int] = {}

    async def start(self) -> "KvIndexer":
        sub = self.drt.bus.subscribe(self.component.event_subject(KV_EVENT_SUBJECT))
        ready = getattr(sub, "ready", None)
        if ready is not None:
            await ready
        self._task = self.drt.runtime.spawn(self._consume(sub))
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _consume(self, sub) -> None:
        # apply inline: mutation and lookups share the event loop, so a
        # separate applier task (the reference's mpsc, indexer.rs:499) would
        # only add an unbounded buffer here
        async for msg in sub:
            try:
                self.apply_event(RouterEvent.from_bytes(msg.payload))
            except Exception:  # noqa: BLE001
                logger.exception("bad kv event")

    def apply_event(self, ev: RouterEvent) -> None:
        if ev.event_id:
            last = self._last_event_id.get(ev.worker_id, 0)
            if last and ev.event_id > last + 1:
                self.event_gaps += 1
                logger.debug(
                    "kv event gap from worker %x: %d -> %d",
                    ev.worker_id, last, ev.event_id,
                )
            if ev.event_id > last:
                self._last_event_id[ev.worker_id] = ev.event_id
        kv = ev.event
        if kv.kind == "demoted":
            # overlay-only: the residency stays in the tree (the worker
            # still holds the KV), it just stops counting as device
            for h in kv.block_hashes:
                self._offloaded[(ev.worker_id, h)] = None
                self._offloaded.move_to_end((ev.worker_id, h))
            while len(self._offloaded) > self._offloaded_cap:
                # dropping the oldest entry is safe-conservative: the
                # block reads as device-resident again, which at worst
                # suppresses one redundant prefetch hint
                self._offloaded.popitem(last=False)
            self.events_applied += 1
            return
        if kv.kind == "stored":
            # a restore/commit puts the block back on device
            for blk in kv.blocks:
                self._offloaded.pop((ev.worker_id, blk.block_hash), None)
        elif kv.kind == "removed":
            for h in kv.block_hashes:
                self._offloaded.pop((ev.worker_id, h), None)
        self.index.apply_event(ev)
        self.events_applied += 1

    def find_matches(self, block_hashes) -> OverlapScores:
        hashes = list(block_hashes)
        scores = self.index.find_matches(hashes)
        if self._offloaded:
            for w, k in scores.scores.items():
                for i in range(k):
                    if (w, hashes[i]) in self._offloaded:
                        scores.device_scores[w] = i
                        break
        return scores

    def find_matches_for_tokens(self, tokens, block_size: int) -> OverlapScores:
        hashes = [seq for _loc, seq in sequence_block_hashes(tokens, block_size)]
        return self.find_matches(hashes)

    def remove_worker(self, worker_id: int) -> None:
        self._offloaded = OrderedDict(
            (k, None) for k in self._offloaded if k[0] != worker_id
        )
        # a departed worker's event-id restarts from 1 when it rejoins —
        # carrying the old high-water would count the restart as a gap
        self._last_event_id.pop(worker_id, None)
        self.index.remove_worker(worker_id)
