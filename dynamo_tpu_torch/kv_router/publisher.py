"""Worker-side KV event publication + router-side metrics aggregation.

A copy of two classes of ``dynamo_tpu/kv_router/publisher.py`` (the
reference's lib/llm/src/kv_router/{publisher,metrics_aggregator}.rs):

  * :class:`KvEventPublisher` — hooks the engine's BlockAllocator
    stored/removed/demoted callbacks (and, with KV tiers, the offload
    manager's last-tier drops) and publishes RouterEvents on the
    component's ``kv_events`` subject,
  * :class:`KvMetricsAggregator` — periodically scrapes every worker
    instance's stats endpoint (the engine's ``load_metrics``) into
    :class:`ProcessedEndpoints` for the scheduler.

The reference's ``KvPrefetchListener`` and ``KvPeerServer`` (the
router-hinted prefetch and the fleet pull from the host and disk tiers)
come with ROADMAP A.5 item 2.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time as _time
from typing import Optional

from .protocols import KV_EVENT_SUBJECT, KvCacheEvent, RouterEvent, StoredBlock
from .scheduler import ProcessedEndpoints, WorkerLoad

logger = logging.getLogger(__name__)


class KvEventPublisher:
    """ref publisher.rs:33-73."""

    def __init__(self, drt, component, worker_id: int):
        self.drt = drt
        self.subject = component.event_subject(KV_EVENT_SUBJECT)
        self.worker_id = worker_id
        self._ids = itertools.count(1)

    def publish(self, event: KvCacheEvent) -> None:
        ev = RouterEvent(self.worker_id, event, next(self._ids))
        self.drt.bus.publish(self.subject, ev.to_bytes())

    # -- allocator callback adapters --
    def on_stored(self, block, parent_hash: Optional[int]) -> None:
        self.publish(
            KvCacheEvent.stored(
                parent_hash,
                [StoredBlock(block_hash=block.seq_hash, tokens_hash=block.local_hash)],
            )
        )

    def on_removed(self, block_hashes: list[int]) -> None:
        self.publish(KvCacheEvent.removed(block_hashes))

    def on_demoted(self, block_hashes: list[int]) -> None:
        self.publish(KvCacheEvent.demoted(block_hashes))

    def attach(self, allocator, offload=None) -> None:
        """Wire the allocator's events. Without KV tiers a device eviction
        is a removal. With an ``offload`` manager the residency is tiered:
        a device eviction publishes ``demoted`` (the worker still holds the
        KV one tier down, and the router keeps the radix entry), and the
        real ``removed`` fires from the manager's last-tier drop queue
        (``OffloadManager.flush_dropped``)."""
        allocator.on_stored = self.on_stored
        allocator.on_removed = self.on_removed
        if offload is not None:
            allocator.on_demoted = self.on_demoted
            offload.on_dropped = self.on_removed


class KvMetricsAggregator:
    """ref metrics_aggregator.rs:27-109 collect_endpoints_task."""

    def __init__(self, drt, component, interval: float = 1.0):
        self.drt = drt
        self.component = component
        self.interval = interval
        self.endpoints = ProcessedEndpoints([])
        # last-known load per instance: a worker that misses one scrape
        # window (1s stats timeout on a starved box) keeps its previous
        # snapshot — with its ORIGINAL ts, so the scheduler's load_ttl_s
        # ages it out if it stays silent — instead of vanishing from the
        # routing view for a tick. Departed workers (discovery key gone)
        # still drop immediately.
        self._known: dict[int, WorkerLoad] = {}
        self._task: Optional[asyncio.Task] = None
        #: completed-scrape signal: counter + waiter futures resolved at
        #: the end of every _collect_once. Lets tests (and watchers)
        #: synchronize on SCRAPES OBSERVED rather than wall time — on a
        #: starved box the scrape loop stretches, and a fixed-duration
        #: poll times out while the aggregator has simply not run yet.
        self.scrapes_total = 0
        self._scrape_waiters: list[asyncio.Future] = []

    async def start(self) -> "KvMetricsAggregator":
        await self._collect_once()
        self._task = self.drt.runtime.spawn(self._loop())
        return self

    async def next_scrape(self, timeout: Optional[float] = None) -> int:
        """Resolve after the NEXT completed scrape (an event, not a
        timer); returns the new ``scrapes_total``. With ``timeout``,
        falls through after that many seconds even if no scrape landed —
        callers decide whether a starved loop is an error."""
        fut = asyncio.get_running_loop().create_future()
        self._scrape_waiters.append(fut)
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            pass
        finally:
            if fut in self._scrape_waiters:
                self._scrape_waiters.remove(fut)
        return self.scrapes_total

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                await self._collect_once()
            except Exception:  # noqa: BLE001
                logger.exception("metrics scrape failed")

    async def _collect_once(self) -> None:
        stats = await self.component.scrape_stats(include_missing=True)
        now = _time.monotonic()
        merged: dict[int, WorkerLoad] = {}
        for s in stats:
            d = s.get("data")
            if d is None:
                # discovered but slow: retain the last-known load (stale
                # ts and all) rather than dropping a live worker
                prev = self._known.get(s["instance_id"])
                if prev is not None:
                    merged[s["instance_id"]] = prev
                continue
            # ts stamped at scrape time: the scheduler ages these out
            # (load_ttl_s) instead of trusting a dead worker's last
            # report forever
            merged[s["instance_id"]] = WorkerLoad.from_stats(
                s["instance_id"], d, ts=now
            )
        self._known = merged
        self.endpoints = ProcessedEndpoints(list(merged.values()))
        self.scrapes_total += 1
        waiters, self._scrape_waiters = self._scrape_waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(self.scrapes_total)
