"""KvRouter: indexer + metrics + scheduler behind one ``schedule`` call,
plus the pipeline operator that routes preprocessed requests to workers.

A copy of ``dynamo_tpu/kv_router/router.py`` (the reference's
lib/llm/src/kv_router.rs:45-143 KvRouter.schedule and the python router
component, examples/llm/components/kv_router.py), without its planner
capacity-watermark and autopilot health subscriptions and without tracing
spans: the router
sits between the preprocessor and the worker client, computes the
request's chained block hashes, scores overlap against the global index,
and pins the request to the chosen worker with ``client.direct``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncIterator, Optional

from ..engine.allocator import model_hash_salt, sequence_block_hashes
from ..protocols.common import PreprocessedRequest
from ..runtime.annotated import Annotated
from ..runtime.component import Client, Component
from ..runtime.engine import AsyncEngine, Context
from ..runtime.store import EventKind
from .indexer import KvIndexer
from .publisher import KvMetricsAggregator
from .scheduler import AllWorkersBusy, KvScheduler, SchedulerConfig

logger = logging.getLogger(__name__)


class KvRouter:
    """ref kv_router.rs:45 KvRouter{indexer, scheduler}."""

    def __init__(
        self,
        drt,
        component: Component,
        block_size: int = 16,
        config: Optional[SchedulerConfig] = None,
        indexer_shards: int = 1,
        model_name: Optional[str] = None,
    ):
        self.drt = drt
        self.component = component
        self.block_size = block_size
        # served model name, stamped into prefetch hints so workers can
        # pre-stage weights (PRESERVE) — None for single-model stacks
        # that never told the router what they serve
        self.model_name = model_name
        self.indexer = KvIndexer(drt, component, shards=indexer_shards)
        self.metrics = KvMetricsAggregator(drt, component)
        self.scheduler = KvScheduler(drt, component, config)
        self._watch_task = None

    async def start(self) -> "KvRouter":
        await self.indexer.start()
        await self.metrics.start()
        # prune dead workers from the index when their discovery keys vanish
        # (lease loss), ref indexer.rs:380 remove_worker wiring
        watcher = self.drt.store.watch_prefix(self.component.etcd_root + "/")
        if asyncio.iscoroutine(watcher):
            watcher = await watcher
        self._watch_task = self.drt.runtime.spawn(self._watch_instances(watcher))
        return self

    async def _watch_instances(self, watcher) -> None:
        async for ev in watcher:
            if ev.kind != EventKind.DELETE:
                continue
            try:
                lease_hex = ev.key.rsplit(":", 1)[1]
                worker_id = int(lease_hex, 16)
            except (IndexError, ValueError):
                continue
            logger.info("pruning dead worker %x from kv index", worker_id)
            self.indexer.remove_worker(worker_id)

    async def schedule(
        self, token_ids: list[int], avoid: frozenset = frozenset(),
        model: str = "",
    ) -> tuple[int, int]:
        """-> (worker_id, overlap_blocks). Raises AllWorkersBusy.

        ``model`` names the requested adapter ("" = base): it salts the
        block-hash chain into the model's namespace (the SAME chain the
        worker's allocator builds, so overlap scoring stays honest and a
        cross-model token-identical prompt scores ZERO overlap), narrows
        selection to workers advertising the model, and rides the
        prefetch hint so the worker pre-stages the adapter's weights."""
        # the BASE model's own name must hash exactly like "" — workers
        # resolve it to the unsalted base lane (engine.py generate), and
        # pre-multi-model fleets whose requests carry the served name
        # must keep their unsalted chains (no hash drift on upgrade)
        salt_name = "" if model == (self.model_name or "") else model
        pairs = sequence_block_hashes(
            token_ids, self.block_size, salt=model_hash_salt(salt_name)
        )
        hashes = [s for _l, s in pairs]
        overlaps = self.indexer.find_matches(hashes)
        # never scrape inline: the aggregator loop refreshes every interval;
        # an empty load set (cold start / all workers gone) raises
        # AllWorkersBusy and the caller falls back to round robin
        worker_id = self.scheduler.select_worker(
            self.metrics.endpoints, overlaps, len(hashes), avoid=avoid,
            model=model,
        )
        overlap = overlaps.scores.get(worker_id, 0)
        # admission hashes prompt[:-1] (the final token always recomputes
        # for fresh logits), so a prompt of exactly N full blocks can only
        # ever claim N-1 — don't hint a block the worker can't claim
        n_hint = (
            len(pairs) - 1 if token_ids and len(token_ids)
            % self.block_size == 0 else len(pairs)
        )
        # compare against the CLAIMABLE chain, on the DEVICE-tier depth:
        # a worker already holding all n_hint claimable blocks on device
        # must not be re-hinted every turn, but a chain the worker
        # demoted to host/disk still wants the hint (it triggers the
        # pre-arrival restore that hides the promotion latency)
        if overlaps.device(worker_id) < n_hint:
            # fleet prefix cache: when a PEER's radix chain covers the
            # prompt deeper than everything the routed worker holds
            # (any tier), name it in the hint — the worker pulls the
            # continuation from the peer's tiers over the transfer
            # plane before the request lands. The chooser prefers the
            # NEAREST adequate peer (same-slice ICI beats a deeper
            # chain across DCN) once the cost model is calibrated;
            # advisory, like the hint itself.
            peer_id, peer_blocks = self.scheduler.choose_peer(
                self.metrics.endpoints, overlaps, worker_id, n_hint
            )
            self.scheduler.emit_prefetch(
                worker_id, pairs[:n_hint],
                peer_worker_id=peer_id,
                peer_blocks=peer_blocks,
                # the REQUEST's model wins (adapter prestage); the
                # router-wide name is the single-model legacy fallback
                model=model or self.model_name,
            )
        return worker_id, overlap

    def request_finished(self, worker_id: int) -> None:
        self.scheduler.request_finished(worker_id)

    def remove_worker(self, worker_id: int) -> None:
        self.indexer.remove_worker(worker_id)


class KvRoutedEngine(AsyncEngine):
    """Routes PreprocessedRequests to the KV-best worker instance
    (falls back to round robin when the router can't decide)."""

    def __init__(self, router: KvRouter, client: Client):
        self.router = router
        self.client = client

    async def generate(self, request: Context) -> AsyncIterator[Annotated]:
        data = request.data
        token_ids = (
            data.token_ids
            if isinstance(data, PreprocessedRequest)
            else (data or {}).get("token_ids", [])
        )
        model = (
            data.model
            if isinstance(data, PreprocessedRequest)
            else (data or {}).get("model", "")
        ) or ""
        payload = data.to_dict() if isinstance(data, PreprocessedRequest) else data
        worker_id: Optional[int] = None
        # workers a migrating request already failed on (resilience/
        # migration.py stamps them on re-dispatch): a killed worker stays
        # leased until its TTL lapses, so routing must steer around it
        # rather than trust discovery
        avoid = frozenset(
            i for i in (request.annotations.get("migration.avoid_workers") or ())
            if isinstance(i, int)
        )
        try:
            worker_id, _overlap = await self.router.schedule(
                token_ids, avoid=avoid, model=model
            )
        except AllWorkersBusy:
            logger.warning("all workers busy; falling back to round robin")
        except Exception:  # noqa: BLE001
            logger.exception("router failure; falling back to round robin")
        if worker_id is None and avoid:
            # router fallback on a re-dispatch: blind round-robin may hand
            # the request straight back to the instance it is fleeing —
            # pin any live instance outside the avoid set instead
            alive = sorted(set(self.client.instance_ids()) - avoid)
            if alive:
                worker_id = alive[0]
        try:
            if worker_id is not None and worker_id in set(self.client.instance_ids()):
                # stamp the pinned instance into the request annotations:
                # the migration layer reads it back on a stream failure to
                # tell lease loss (instance gone from the store watch)
                # from a transient TCP drop (instance still live)
                request.annotations["routed_worker_id"] = worker_id
                stream = await self.client.direct(request.transfer(payload), worker_id)
            else:
                request.annotations.pop("routed_worker_id", None)
                stream = await self.client.round_robin(request.transfer(payload))
            async for item in stream:
                yield item
        finally:
            if worker_id is not None:
                self.router.request_finished(worker_id)
