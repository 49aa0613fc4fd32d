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

and the two of the fleet prefix cache:

  * :class:`KvPrefetchListener` — consumes the router's ``kv-prefetch``
    hints addressed to this worker, pulls a peer-held prefix continuation
    over the transfer plane when the hint names a deeper peer, and hands
    the chain to the engine's hinted prefetch (``prefetch_hint``), so the
    restore starts before the request arrives,
  * :class:`KvPeerServer` — the serve side of those pulls: answers
    ``kv-peer-fetch`` requests addressed to this worker by pushing the
    chain's device, host and disk-resident blocks to the requester's
    connect-back address (``disagg/transfer.py`` framing and ack).

Both speak the reference's bus messages and transfer frames, so a port
worker pulls from a JAX peer and serves one.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time as _time
import uuid
from typing import Optional

import torch

from .protocols import (
    KV_EVENT_SUBJECT,
    KV_PEER_FETCH_SUBJECT,
    KV_PREFETCH_SUBJECT,
    KvCacheEvent,
    KvPeerFetchRequest,
    KvPrefetchHint,
    RouterEvent,
    StoredBlock,
)
from .scheduler import ProcessedEndpoints, WorkerLoad

logger = logging.getLogger(__name__)

#: wall bound on one peer prefix pull (bus negotiation + TCP push): past
#: this the hinted request is probably being served already, so the puller
#: abandons the delivery and admission recomputes
PEER_PULL_TIMEOUT_S = 20.0


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


class KvPrefetchListener:
    """Worker-side prefetch-hint consumer: subscribes the component's
    ``kv-prefetch`` subject, keeps the hints addressed to this worker and
    drives the engine's hinted prefetch. Hints are advisory: any failure is
    logged and dropped (the request still serves, it pays the cold restore
    or the recompute).

    Fleet prefix cache: a hint naming a ``peer_worker_id`` whose chain runs
    deeper than this worker's local coverage triggers a peer pull first (a
    ``kv-peer-fetch`` negotiation on the bus, answered by the peer pushing
    the blocks to this listener's transfer server), landed in the host
    staging area, then promoted to the device by the same
    ``engine.prefetch_hint`` that serves locally offloaded chains."""

    def __init__(self, drt, component, worker_id: int, engine,
                 transfer=None, peer_pull: bool = True,
                 pull_timeout: float = PEER_PULL_TIMEOUT_S):
        self.drt = drt
        self.subject = component.event_subject(KV_PREFETCH_SUBJECT)
        self.fetch_subject = component.event_subject(KV_PEER_FETCH_SUBJECT)
        self.worker_id = worker_id
        self.engine = engine
        self.hints_received = 0
        self.blocks_prefetched = 0
        self.peer_pulls = 0
        self.peer_pull_blocks = 0
        self.peer_pull_failures = 0
        #: wall ms of each successful pull (negotiation + push + landing)
        self.pull_ms: list = []
        self.pull_timeout = pull_timeout
        self.peer_pull = peer_pull
        # connect-back target for peer pushes: the disagg decode role shares
        # its KvTransferServer; otherwise the listener owns one
        self._transfer = transfer
        self._own_transfer = False
        self._task: Optional[asyncio.Task] = None
        self._sub = None
        # one task per hint (a dead peer's pull waits out its timeout
        # without blocking later hints); pulls beyond the cap go straight
        # to the local restore, and the restores serialize
        self._hint_tasks: set[asyncio.Task] = set()
        self._restore_lock = asyncio.Lock()
        self._active_pulls = 0
        self.max_concurrent_pulls = 8

    def _pull_ready(self) -> bool:
        return (self.peer_pull and self._transfer is not None
                and getattr(self.engine, "offload", None) is not None)

    async def start(self) -> "KvPrefetchListener":
        if (self.peer_pull and self._transfer is None
                and getattr(self.engine, "offload", None) is not None):
            from ..disagg.transfer import KvTransferServer

            self._transfer = KvTransferServer()
            await self._transfer.start()
            self._own_transfer = True
        sub = self.drt.bus.subscribe(self.subject)
        ready = getattr(sub, "ready", None)
        if ready is not None:
            await ready
        self._sub = sub
        self._task = self.drt.runtime.spawn(self._consume(sub))
        return self

    async def close(self) -> None:
        if self._sub is not None:
            self._sub.unsubscribe()
        if self._task is not None:
            self._task.cancel()
        for t in list(self._hint_tasks):
            t.cancel()
        if self._own_transfer and self._transfer is not None:
            await self._transfer.close()

    async def _consume(self, sub) -> None:
        async for msg in sub:
            try:
                hint = KvPrefetchHint.from_bytes(msg.payload)
                if hint.worker_id != self.worker_id:
                    continue
                self.hints_received += 1
                t = asyncio.get_running_loop().create_task(self._handle_hint(hint))
                self._hint_tasks.add(t)
                t.add_done_callback(self._hint_tasks.discard)
            except Exception:  # noqa: BLE001 — hints are advisory
                logger.debug("prefetch hint failed", exc_info=True)

    async def _handle_hint(self, hint: KvPrefetchHint) -> None:
        try:
            blocks = [(l, s) for l, s in hint.blocks]
            if (hint.peer_worker_id is not None and self._pull_ready()
                    and self._active_pulls < self.max_concurrent_pulls):
                self._active_pulls += 1
                try:
                    await self._maybe_pull(hint, blocks)
                finally:
                    self._active_pulls -= 1
            async with self._restore_lock:
                n = await self.engine.prefetch_hint(blocks)
            self.blocks_prefetched += n
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — hints are advisory
            logger.debug("prefetch hint failed", exc_info=True)

    async def _maybe_pull(self, hint: KvPrefetchHint, blocks: list) -> None:
        """One peer prefix pull: size the remote tail from local coverage,
        negotiate over the bus, await the transfer-plane delivery and land
        it in the host staging area. Best-effort throughout: every failure
        degrades to what would happen without the peer (recompute)."""
        from ..disagg.transfer import KV_QUANT_WIRE_VERSION

        chain = [s for _l, s in blocks]
        cov = self.engine.chain_coverage(chain)
        if cov >= min(hint.peer_blocks, len(chain)):
            return  # local tiers already cover what the peer offers
        tail = chain[cov:]
        request_id = f"peer-pull-{uuid.uuid4().hex}"
        fut = self._transfer.expect(request_id)
        req = KvPeerFetchRequest(
            peer_worker_id=hint.peer_worker_id,
            src_worker_id=self.worker_id,
            request_id=request_id,
            hashes=tail,
            connection=self._transfer.address.to_dict(),
            # this puller normalizes any codec on landing
            accept_quant=KV_QUANT_WIRE_VERSION,
        )
        self.peer_pulls += 1
        t0 = _time.monotonic()
        try:
            self.drt.bus.publish(self.fetch_subject, req.to_bytes())
            delivery = await asyncio.wait_for(fut, self.pull_timeout)
        except Exception:  # noqa: BLE001 — dead peer / timeout / bus trouble:
            # recompute; the abandoned future keeps a late push from landing
            self.peer_pull_failures += 1
            self._transfer.abandon(request_id)
            logger.debug("peer pull %s failed; falling back to recompute",
                         request_id, exc_info=True)
            return
        if delivery.error or not delivery.hashes or delivery.k_data is None:
            self.peer_pull_failures += 1
            return
        # the pull's wall and bytes calibrate the "peer" link class
        cost = getattr(self.engine, "cost", None)
        if cost is not None:
            cost.observe("peer", delivery.k_data.nbytes + delivery.v_data.nbytes,
                         max(_time.monotonic() - t0, 1e-9))
        served = [int(h) for h in delivery.hashes]
        if served != tail[: len(served)]:
            # mislabeled KV must never enter the content-addressed pool
            self.peer_pull_failures += 1
            logger.warning("peer pull %s returned a mismatched chain", request_id)
            return
        try:
            n = await asyncio.get_running_loop().run_in_executor(
                None, self._regroup_and_land, delivery, served)
        except Exception:  # noqa: BLE001 — bad peer metadata
            self.peer_pull_failures += 1
            logger.warning("peer pull %s regroup/landing failed", request_id,
                           exc_info=True)
            return
        self.peer_pull_blocks += n
        self.pull_ms.append((_time.monotonic() - t0) * 1e3)

    def _regroup_and_land(self, delivery, served: list) -> int:
        """Executor thread: permute a foreign kv-head ordering and park the
        chain in the host staging area (a quantized delivery lands with its
        scales, normalized to this worker's codec)."""
        from ..engine.engine import KV_HEAD_LAYOUT, MESH_TP
        from ..ops.kv_rearrange import layout_mismatched, rearrange_for_decode

        k, v = delivery.k_data, delivery.v_data
        if layout_mismatched(delivery.head_layout, delivery.src_tp,
                             KV_HEAD_LAYOUT, MESH_TP):
            k = rearrange_for_decode(k, delivery.src_tp, MESH_TP,
                                     delivery.head_layout, KV_HEAD_LAYOUT)
            v = rearrange_for_decode(v, delivery.src_tp, MESH_TP,
                                     delivery.head_layout, KV_HEAD_LAYOUT)
        return self.engine.offload.land_peer_chain(
            served, k, v, k_scales=delivery.k_scales, v_scales=delivery.v_scales)


class KvPeerServer:
    """Serve side of the fleet prefix cache: answers ``kv-peer-fetch``
    requests addressed to this worker by pushing the requested chain's
    device-, host- and disk-resident blocks to the requester's transfer
    server (the disagg handoff's bulk framing and end-to-end ack). A total
    miss answers with an error delivery so the requester falls back at
    once. Serving is non-destructive, so a requester dying mid-pull leaves
    this worker's tiers untouched."""

    def __init__(self, drt, component, worker_id: int, engine,
                 layer_chunk: int = 4):
        self.drt = drt
        self.subject = component.event_subject(KV_PEER_FETCH_SUBJECT)
        self.worker_id = worker_id
        self.engine = engine
        self.layer_chunk = layer_chunk
        self.fetches_received = 0
        self.blocks_served = 0
        self.misses = 0
        self.serve_errors = 0
        self.serve_rejects = 0
        self._task: Optional[asyncio.Task] = None
        self._sub = None
        self._serves: set[asyncio.Task] = set()
        # a hint storm must not stack unbounded concurrent exports
        self.max_concurrent_serves = 8
        # per-fetch bound on the DEVICE-tier export (under the device lock)
        self.max_d2h_blocks = 128

    async def start(self) -> "KvPeerServer":
        sub = self.drt.bus.subscribe(self.subject)
        ready = getattr(sub, "ready", None)
        if ready is not None:
            await ready
        self._sub = sub
        self._task = self.drt.runtime.spawn(self._consume(sub))
        return self

    async def close(self) -> None:
        if self._sub is not None:
            self._sub.unsubscribe()
        if self._task is not None:
            self._task.cancel()
        for t in list(self._serves):
            t.cancel()

    async def _consume(self, sub) -> None:
        async for msg in sub:
            try:
                req = KvPeerFetchRequest.from_bytes(msg.payload)
                if req.peer_worker_id != self.worker_id:
                    continue
                self.fetches_received += 1
                if len(self._serves) >= self.max_concurrent_serves:
                    # over the cap: answer busy so the puller recomputes now
                    self.serve_rejects += 1
                    t = asyncio.get_running_loop().create_task(self._reject(req))
                else:
                    t = asyncio.get_running_loop().create_task(self._serve(req))
                self._serves.add(t)
                t.add_done_callback(self._serves.discard)
            except Exception:  # noqa: BLE001 — fetches are advisory
                logger.debug("bad kv-peer-fetch request", exc_info=True)

    async def _reject(self, req: KvPeerFetchRequest) -> None:
        from ..disagg.transfer import send_kv_blocks

        try:
            await send_kv_blocks(req.connection, req.request_id, -1, None, None,
                                 error="peer-busy")
        except Exception:  # noqa: BLE001 — the puller's timeout covers us
            logger.debug("peer-busy notify %s failed", req.request_id,
                         exc_info=True)

    def _export_and_merge(self, req: KvPeerFetchRequest, serve_q: str,
                          hashes: list, k, v, dks, dvs) -> tuple:
        """Executor thread: the device run in the wire's codec (the int8
        device codec verbatim when the wire speaks it; a full-width stack,
        already dequantized on the card, quantized here for a quantized
        wire of another codec), then the host / disk run past it, merged.
        Returns (hashes, k, v, ks, vs)."""
        from ..engine import kvquant

        off = self.engine.offload
        ks = vs = None
        if dks is not None and hashes:
            ks, vs = dks, dvs
        elif serve_q != "none" and hashes:
            k, v, ks, vs = kvquant.quantize_stack(k, v, serve_q)
        if off is None:
            return list(hashes), k, v, ks, vs
        h2, k2, v2, ks2, vs2 = off.export_chain_q(
            list(req.hashes[len(hashes):]), quant_ok=serve_q != "none")
        if not h2:
            return list(hashes), k, v, ks, vs
        if not hashes:
            return h2, k2, v2, ks2, vs2
        k, v = torch.cat([k, k2], dim=2), torch.cat([v, v2], dim=2)
        if ks2 is not None:
            ks, vs = torch.cat([ks, ks2], dim=1), torch.cat([vs, vs2], dim=1)
        return list(hashes) + h2, k, v, ks, vs

    async def _serve(self, req: KvPeerFetchRequest) -> None:
        from ..disagg.transfer import send_kv_blocks
        from ..engine.engine import KV_HEAD_LAYOUT, MESH_TP
        from ..resilience import faultpoints

        try:
            # a kill here is a peer dying before the push: no data, no ack,
            # the puller's timeout degrades it to recompute
            await faultpoints.hit("mid_peer_serve", request_id=req.request_id)
            off = getattr(self.engine, "offload", None)
            # serve at the stored codec's width only to a puller that
            # advertised the capability; without a host tier the device
            # cache's own codec (int8 with scales) is the stored one
            dev_q = "int8" if getattr(self.engine, "k_scales", None) is not None else "none"
            serve_q = ((off.kv_quant if off is not None else dev_q)
                       if req.accept_quant >= 1 else "none")
            # device tier first (a bounded, non-destructive d2h), then the
            # host / disk run past the device-resident prefix; an int8 cache
            # ships its codes only to an int8 wire, else the card dequantizes
            hashes, k, v, dks, dvs = await self.engine.export_device_chain(
                req.hashes, max_blocks=self.max_d2h_blocks,
                with_scales=serve_q == "int8")
            hashes, k, v, ks, vs = await asyncio.get_running_loop().run_in_executor(
                None, self._export_and_merge, req, serve_q, hashes, k, v, dks, dvs)
            if not hashes:
                self.misses += 1
                await send_kv_blocks(req.connection, req.request_id, -1, None,
                                     None, error="peer-miss")
                return
            await send_kv_blocks(
                req.connection, req.request_id, -1, k, v,
                layer_chunk=self.layer_chunk, head_layout=KV_HEAD_LAYOUT,
                src_tp=MESH_TP, hashes=hashes,
                kv_quant=serve_q if ks is not None else "none",
                k_scales=ks, v_scales=vs)
            self.blocks_served += len(hashes)
        except Exception:  # noqa: BLE001 — serving is best-effort: the
            # puller's timeout covers us, and a FaultInjected kill must look
            # exactly like a crashed peer (no ack, no retry)
            self.serve_errors += 1
            logger.debug("peer serve %s for worker %x failed", req.request_id,
                         req.src_worker_id, exc_info=True)


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
