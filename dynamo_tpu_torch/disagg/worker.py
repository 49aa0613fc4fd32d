"""Disaggregated serving workers: a port of ``dynamo_tpu/disagg/worker.py``.

``DisaggEngine`` is the decode-side AsyncEngine: per request it consults
the ConditionalDisaggRouter; local prompts flow straight into the wrapped
``TorchEngine``, long prompts get their pages reserved (``begin_remote``),
go on the PrefillQueue, and complete when the prefill worker's KV lands on
the transfer plane.

``PrefillWorker`` is the queue consumer: prefill + first-token sample on
its own engine, then push the KV to the requesting decode worker. Failures
nack the item so it redelivers to another worker.

Both speak the reference's wire (queue items, connection info, stream
frames), so either side may be a JAX worker. Left out: the same-slice
negotiated landing (``disagg/ici.py``): the decode role advertises no
``kv_ici``, and every peer takes the plain streamed path. The reference's
tracing spans are left out too; their numbers (queue wait, compute,
gather, send, exposed and hidden wire time, bytes) land in each side's
``handoffs`` records instead.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import AsyncIterator, Optional, Union

import torch

from ..engine import kvquant
from ..engine.engine import KV_HEAD_LAYOUT, MESH_TP, OutOfBlocks, TorchEngine
from ..models import llama
from ..ops.kv_rearrange import layout_mismatched, rearrange_for_decode
from ..protocols.common import LLMEngineOutput, PreprocessedRequest
from ..resilience import faultpoints
from ..resilience.faultpoints import FaultInjected
from ..runtime.engine import AsyncEngine, AsyncEngineContext, Context
from ..utils.dtypes import dtype_name
from .protocols import RemotePrefillRequest
from .queue import PrefillQueue
from .router import ConditionalDisaggRouter
from .transfer import (
    KV_QUANT_WIRE_VERSION,
    KV_STREAM_BASE_VERSION,
    KV_STREAM_VERSION,
    KvStreamSender,
    KvTransferServer,
    LocalKvPipe,
    SinkClosed,
    TransferError,
    send_kv_blocks,
)

logger = logging.getLogger(__name__)

#: per-segment wall bound for the streamed handoff's socket sends: the
#: sender's backpressure reaches into prefill compute, so a peer that stops
#: reading must fail fast into nack/redelivery
SEGMENT_SEND_TIMEOUT_S = 60.0

#: per-request handoff records each side keeps (newest last)
HANDOFF_RECORDS = 256


class PrefillWorker:
    def __init__(
        self,
        engine: TorchEngine,
        queue: PrefillQueue,
        local_pipe: Optional[LocalKvPipe] = None,
        layer_chunk: int = 4,
        head_layout: Optional[str] = None,
        kv_stream: bool = True,
        segment_blocks: int = 0,
        concurrency: int = 1,
        src_tp: int = MESH_TP,
    ):
        self.engine = engine
        self.queue = queue
        self.local_pipe = local_pipe
        self.layer_chunk = layer_chunk
        # wire-declared kv-head ordering and tp degree; override only when
        # wrapping an engine whose extraction really produces another order
        self.head_layout = head_layout or KV_HEAD_LAYOUT
        self.src_tp = src_tp
        # streamed layer-wise handoff: open the transfer at prefill start,
        # ship each chunk's blocks as its compute lands. Engages only when
        # the decode peer advertised the capability
        self.kv_stream = kv_stream
        self.segment_blocks = segment_blocks
        # per-block wire quantization (the engine's --kv-quant mode): TCP
        # handoffs ship int8/fp8 payloads + scale frames to decode peers
        # that advertised the kv_quant capability; the local pipe stays
        # full width, and legacy peers get full-width bytes
        self.kv_quant = engine.cfg.kv_quant
        # consume-loop fan-out: with the streamed extract taking the device
        # lock per chunk, N concurrent prompts interleave chunk-wise. Each
        # loop owns its item's dequeue -> process -> ack lifecycle
        self.concurrency = max(int(concurrency), 1)
        self._tasks: list[asyncio.Task] = []
        self._stop = asyncio.Event()
        self.stats = {
            "prefills_total": 0, "prefill_errors": 0, "nacks": 0,
            "kv_stream_sends": 0, "kv_stream_segments": 0, "kv_bulk_sends": 0,
            "kv_quant_sends": 0,
        }
        #: one record per completed handoff: queue_wait_ms (from the decode
        #: side's enqueue stamp), compute_ms, gather_ms, send_ms, the
        #: post-compute exposed_ms and the hidden_ms of send activity that
        #: overlapped compute, nbytes, segments, mode
        self.handoffs: deque = deque(maxlen=HANDOFF_RECORDS)

    def _wire_quant(self, connection: dict, local: bool) -> str:
        """Negotiated wire codec for one handoff: this worker's --kv-quant
        mode, IF the channel serializes (never the local pipe) and the
        decode peer advertised the kv_quant capability."""
        if (self.kv_quant != "none" and not local
                and int(connection.get("kv_quant") or 0) >= KV_QUANT_WIRE_VERSION):
            return self.kv_quant
        return "none"

    def start(self) -> None:
        if not self._tasks:
            loop = asyncio.get_running_loop()
            self._tasks = [loop.create_task(self.run())
                           for _ in range(self.concurrency)]

    async def close(self) -> None:
        self._stop.set()
        for t in self._tasks:
            t.cancel()
        self._tasks = []

    MAX_DELIVERIES = 5  # poison-pill cutoff: after this, fail the request

    async def run(self) -> None:
        while not self._stop.is_set():
            try:
                await self._run_once()
            except asyncio.CancelledError:
                return
            except FaultInjected:
                # harness kill: the consume loop DIES (no retry); the
                # un-acked item redelivers to a surviving consumer
                logger.warning("prefill worker killed by fault point")
                self._stop.set()
                return
            except Exception:  # noqa: BLE001 — transient bus/hub error
                logger.exception("prefill consume loop error; retrying")
                await asyncio.sleep(0.5)

    async def _run_once(self) -> None:
        got = await self.queue.dequeue(timeout=0.5)
        if got is None:
            return
        item_id, rpr = got
        try:
            await self._process(rpr)
        except FaultInjected:
            # die like a real crash: no ack, no nack, no notification; the
            # queue's visibility timeout redelivers the item to a survivor
            raise
        except OutOfBlocks:
            # pool full: hand the item back for another worker (or us, once
            # running prefills free their blocks)
            self.stats["nacks"] += 1
            await self.queue.nack(item_id)
            await asyncio.sleep(0.05)
            return
        except TransferError as e:
            # the KV never landed: retriable, unless this item bounced
            # enough to look like a dead decode host
            if self.queue.deliveries(item_id) < self.MAX_DELIVERIES:
                logger.warning("kv transfer failed (%s); redelivering", e)
                self.stats["nacks"] += 1
                await self.queue.nack(item_id)
                await asyncio.sleep(0.1)
                return
            logger.error("kv transfer failed %d times: %s", self.MAX_DELIVERIES, e)
            self.stats["prefill_errors"] += 1
            await self._notify_error(rpr, str(e))
        except Exception as e:  # noqa: BLE001 — a COMPUTE failure is
            # deterministic: notify the decode side and ack
            logger.exception("remote prefill failed: %s (decode engine %x)",
                             rpr.request_id, rpr.engine_id)
            self.stats["prefill_errors"] += 1
            await self._notify_error(rpr, str(e))
        # acked only AFTER the KV handoff committed (or a deterministic
        # failure was delivered): a worker killed above leaves the item in
        # flight and the prefill redelivers
        await self.queue.ack(item_id)

    def _record(self, rpr: RemotePrefillRequest, **fields) -> None:
        self.handoffs.append({"request_id": rpr.request_id, **fields})

    async def _process(self, rpr: RemotePrefillRequest) -> None:
        req = PreprocessedRequest.from_dict(rpr.request)
        ctx = AsyncEngineContext(rpr.request_id)
        # the queue wait, from the decode side's enqueue stamp (another
        # host's wall clock: skew applies)
        waited = (max(time.time() - rpr.enqueue_ts, 0.0) * 1e3
                  if rpr.enqueue_ts else None)
        # in-process pipe => same card: the KV stays on the device end to
        # end; the TCP path needs host bytes anyway. A local-advertising
        # decode may ALSO carry a TCP address, so a pipe-less worker then
        # delivers over TCP
        local = bool(rpr.connection.get("local")) and self.local_pipe is not None
        has_addr = bool(rpr.connection.get("address"))
        if rpr.connection.get("local") and not local and not has_addr:
            # no channel at all: nack/redeliver to a worker that has one
            raise TransferError("local connection without pipe")
        # stream only when the decode peer advertised a version covering
        # the BASE streamed layout; old peers get the bulk protocol
        streamed = (
            self.kv_stream
            and int(rpr.connection.get("kv_stream") or 0) >= KV_STREAM_BASE_VERSION
            and (local or has_addr or not rpr.connection.get("local"))
        )
        if streamed:
            await self._process_streamed(rpr, req, ctx, local, waited)
            return
        timings: dict = {}
        t0 = time.perf_counter()
        first, first_lp, k, v = await self.engine.prefill_extract(
            req, ctx, skip_blocks=rpr.skip_blocks, keep_on_device=local,
            timings=timings)
        compute_ms = (time.perf_counter() - t0) * 1e3 - timings.get("gather_ms", 0.0)
        self.stats["prefills_total"] += 1
        wire_q = self._wire_quant(rpr.connection, local)
        k_scales = v_scales = None
        quant_ms = 0.0
        if wire_q != "none" and k is not None and k.shape[2]:
            # multi-MB per-block quantize on the host: executor thread
            t_q = time.perf_counter()
            k, v, k_scales, v_scales = await asyncio.get_running_loop().run_in_executor(
                None, kvquant.quantize_stack, k, v, wire_q)
            quant_ms = (time.perf_counter() - t_q) * 1e3
            self.stats["kv_quant_sends"] += 1
        await faultpoints.hit("mid_kv_transfer", request_id=rpr.request_id)
        t_s = time.perf_counter()
        try:
            if local:
                await self.local_pipe.deliver(
                    rpr.request_id, first, k, v, head_layout=self.head_layout,
                    src_tp=self.src_tp, first_lp=first_lp)
            else:
                await send_kv_blocks(
                    rpr.connection, rpr.request_id, first, k, v,
                    layer_chunk=self.layer_chunk, head_layout=self.head_layout,
                    src_tp=self.src_tp, first_lp=first_lp, kv_quant=wire_q,
                    k_scales=k_scales, v_scales=v_scales)
        except (TransferError, FaultInjected):
            raise
        except Exception as e:  # noqa: BLE001 — ANY handoff-stage failure
            # means the KV never committed: redeliver, never ack-with-error
            raise TransferError(f"kv handoff failed: {e}") from e
        send_ms = (time.perf_counter() - t_s) * 1e3
        self.stats["kv_bulk_sends"] += 1
        nbytes = 0 if k is None else sum(
            t.nbytes for t in (k, v, k_scales, v_scales) if t is not None)
        # bulk: the whole send sits after prefill, all of it exposed
        self._record(rpr, mode="bulk", queue_wait_ms=waited, compute_ms=compute_ms,
                     gather_ms=timings.get("gather_ms", 0.0), quant_ms=quant_ms,
                     send_ms=send_ms, exposed_ms=send_ms + quant_ms,
                     hidden_ms=0.0, nbytes=nbytes, segments=1 if nbytes else 0,
                     wire=wire_q)

    async def _process_streamed(self, rpr: RemotePrefillRequest,
                                req: PreprocessedRequest, ctx, local: bool,
                                waited: Optional[float]) -> None:
        """Streamed handoff: open the transfer BEFORE prefill compute, pump
        each chunk's blocks through a bounded send queue while the next
        chunk computes, finish with the sampled first token and the
        stream's single ack. Failure semantics match the bulk path."""
        engine = self.engine
        n_prompt = engine.n_prompt_blocks(len(req.token_ids))
        n = max(n_prompt - rpr.skip_blocks, 0)
        kc, vc = engine.k_cache, engine.v_cache
        # the wire codec: negotiated as in bulk, and the receiver must
        # speak the v2 frame layout
        wire_q = self._wire_quant(rpr.connection, local)
        if int(rpr.connection.get("kv_stream") or 0) < KV_STREAM_VERSION:
            wire_q = "none"
        # the payload's dtype: the wire codec's, else the extract's (an int8
        # cache's extract dequantizes to the model's width)
        if wire_q != "none":
            wire_dt = kvquant.quant_dtype(wire_q)
        elif engine.k_scales is not None:
            wire_dt = llama._dtype(engine.cfg.model)
        else:
            wire_dt = kc.dtype
        head = {
            "request_id": rpr.request_id,
            "stream": KV_STREAM_VERSION,
            "n_blocks": n,
            "shape": [kc.shape[0], kc.shape[1], n, kc.shape[3], kc.shape[4]],
            "v_shape": [vc.shape[0], vc.shape[1], n, vc.shape[3], vc.shape[4]],
            "dtype": dtype_name(wire_dt),
            "layer_chunk": self.layer_chunk,
            "head_layout": self.head_layout,
            "src_tp": self.src_tp,
        }
        if wire_q != "none":
            head["kv_quant"] = wire_q
        await faultpoints.hit("mid_kv_transfer", request_id=rpr.request_id)
        # the connection opens at prefill START: segment i's wire time
        # hides behind chunk i+1's compute
        if local:
            stream = await self.local_pipe.open_stream(rpr.request_id, head)
        else:
            stream = await KvStreamSender.open(rpr.connection, rpr.request_id, head)
        sendq: asyncio.Queue = asyncio.Queue(maxsize=2)
        send_ms = 0.0
        quant_ms = 0.0
        nbytes = 0

        async def pump() -> None:
            nonlocal send_ms, nbytes
            while True:
                item = await sendq.get()
                if item is None:
                    return
                t_s = time.perf_counter()
                try:
                    # backpressure reaches into prefill compute: a peer that
                    # stops reading becomes a bounded TransferError
                    await asyncio.wait_for(stream.send_segment(*item),
                                           SEGMENT_SEND_TIMEOUT_S)
                except (TransferError, FaultInjected):
                    raise
                except asyncio.TimeoutError as e:
                    raise TransferError(
                        f"kv segment send stalled > {SEGMENT_SEND_TIMEOUT_S}s") from e
                except Exception as e:  # noqa: BLE001 — an uncommitted segment
                    # must redeliver, never ack-with-error
                    raise TransferError(f"kv segment handoff failed: {e}") from e
                send_ms += (time.perf_counter() - t_s) * 1e3
                nbytes += sum(t.nbytes for t in item[1:])
                self.stats["kv_stream_segments"] += 1

        pump_task = asyncio.get_running_loop().create_task(pump())

        async def put_or_fail(item) -> None:
            # never block on a queue whose consumer died
            put = asyncio.ensure_future(sendq.put(item))
            done, _ = await asyncio.wait({put, pump_task},
                                         return_when=asyncio.FIRST_COMPLETED)
            if put in done:
                return
            put.cancel()
            exc = pump_task.exception()
            raise exc if exc else TransferError("kv stream sender stopped")

        async def on_segment(b0: int, k_seg, v_seg) -> None:
            nonlocal quant_ms
            await faultpoints.hit("mid_kv_transfer", request_id=rpr.request_id)
            if wire_q != "none":
                # the segment's per-block quantize, off the loop
                t_q = time.perf_counter()
                item = (b0,) + await asyncio.get_running_loop().run_in_executor(
                    None, kvquant.quantize_stack, k_seg, v_seg, wire_q)
                quant_ms += (time.perf_counter() - t_q) * 1e3
            else:
                item = (b0, k_seg, v_seg)
            await put_or_fail(item)

        ok = False
        timings: dict = {}
        try:
            t0 = time.perf_counter()
            first, first_lp, _sent = await engine.prefill_extract_stream(
                req, ctx, skip_blocks=rpr.skip_blocks, keep_on_device=local,
                segment_blocks=self.segment_blocks, on_segment=on_segment,
                timings=timings)
            t_done = time.perf_counter()
            self.stats["prefills_total"] += 1
            await put_or_fail(None)
            await pump_task  # drains the tail; raises on send failure
            await stream.finish(first, first_lp)
            ok = True
            self.stats["kv_stream_sends"] += 1
            if wire_q != "none":
                self.stats["kv_quant_sends"] += 1
            # exposed = the post-compute tail (final drain + fin + ack);
            # hidden = send activity that overlapped compute
            exposed_ms = (time.perf_counter() - t_done) * 1e3
            self._record(rpr, mode="stream", queue_wait_ms=waited,
                         compute_ms=(t_done - t0) * 1e3
                         - timings.get("gather_ms", 0.0) - quant_ms,
                         gather_ms=timings.get("gather_ms", 0.0),
                         quant_ms=quant_ms, send_ms=send_ms,
                         exposed_ms=exposed_ms,
                         hidden_ms=max(send_ms - exposed_ms, 0.0),
                         nbytes=nbytes, segments=stream.segments, wire=wire_q)
        finally:
            if not pump_task.done():
                pump_task.cancel()
                # cancel alone is not enough when it lands while the pump
                # awaits an executor hop: feed the shutdown sentinel so a
                # cancel-surviving pump exits, and bound the drain
                while not sendq.empty():
                    sendq.get_nowait()
                try:
                    sendq.put_nowait(None)
                except asyncio.QueueFull:
                    pass
                try:
                    await asyncio.wait_for(pump_task, SEGMENT_SEND_TIMEOUT_S)
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
            if not ok:
                await stream.aclose()

    async def _notify_error(self, rpr: RemotePrefillRequest, message: str) -> None:
        try:
            if rpr.connection.get("local") and self.local_pipe is not None:
                await self.local_pipe.deliver(rpr.request_id, -1, None, None,
                                              error=message)
            elif rpr.connection.get("address"):
                await send_kv_blocks(rpr.connection, rpr.request_id, -1, None,
                                     None, error=message)
        except Exception:  # noqa: BLE001 — the decode side has a timeout too
            logger.exception("error notification failed: %s", rpr.request_id)


class _RemoteScatterSink:
    """Decode-side landing policy for ONE streamed remote prefill: each
    segment scatters into the request's reserved pages the moment it
    arrives (``engine.scatter_remote_segment``), so only the final
    segment's tail can sit on TTFT. A kv-head layout / tp mismatch
    regroups each segment on arrival (the head permutation is
    block-independent); ``begin`` declines (the buffered bulk path then
    surfaces the error) only when no valid regroup exists. ``aclose``
    waits out any in-flight scatter before the caller frees the
    reservation, so an abandoned stream never writes into recycled
    pages."""

    def __init__(self, engine: TorchEngine, handle, stats: dict):
        self._engine = engine
        self._handle = handle
        self._stats = stats
        self._closed = False
        self._lock = asyncio.Lock()
        self._regroup = None  # (src_tp, dst_tp, src_layout, dst_layout)
        self.segments = 0
        #: wall ms of the segments' landings (h2d + scatter launch)
        self.scatter_ms = 0.0

    async def begin(self, head: dict) -> bool:
        if self._closed:
            return False
        layout = head.get("head_layout", "blocked")
        src_tp = head.get("src_tp", 1)
        self._regroup = None
        if layout_mismatched(layout, src_tp, KV_HEAD_LAYOUT, MESH_TP):
            # validate the permutation NOW against both declared head
            # counts (k and v differ for MLA latents)
            shape = tuple(head.get("shape") or ())
            v_shape = tuple(head.get("v_shape") or shape)
            try:
                for hkv in {shape[1], v_shape[1]}:
                    rearrange_for_decode(torch.empty((1, hkv, 0, 1, 1)), src_tp,
                                         MESH_TP, layout, KV_HEAD_LAYOUT)
            except Exception:  # noqa: BLE001 — bad peer metadata
                return False
            self._regroup = (src_tp, MESH_TP, layout, KV_HEAD_LAYOUT)
        # a redelivered stream restarts from block 0: re-scatters over the
        # same uncommitted pages are idempotent
        self.segments = 0
        return True

    async def segment(self, b0: int, k_seg, v_seg, k_scales=None,
                      v_scales=None) -> None:
        async with self._lock:
            if self._closed:
                raise SinkClosed(self._handle.seq.context.id)
            if self._regroup is not None:
                # valid on quantized payloads as they are: the codec's
                # scales are per (layer, block), kv-head-free
                k_seg = rearrange_for_decode(k_seg, *self._regroup)
                v_seg = rearrange_for_decode(v_seg, *self._regroup)
                self._stats["kv_stream_regroups"] += 1
            t0 = time.perf_counter()
            await self._engine.scatter_remote_segment(
                self._handle, b0, k_seg, v_seg, k_scales, v_scales)
            self.scatter_ms += (time.perf_counter() - t0) * 1e3
            self.segments += 1
            self._stats["kv_stream_segments"] += 1

    async def aclose(self) -> None:
        self._closed = True
        async with self._lock:
            pass


class DisaggEngine(AsyncEngine):
    """Decode-side conditional-disaggregation front (AsyncEngine over
    PreprocessedRequest -> LLMEngineOutput stream)."""

    def __init__(
        self,
        engine: TorchEngine,
        router: ConditionalDisaggRouter,
        queue: PrefillQueue,
        transfer: Union[KvTransferServer, LocalKvPipe],
        engine_id: int = 0,
        transfer_timeout: float = 120.0,
        kv_stream: bool = True,
    ):
        self.engine = engine
        self.router = router
        self.queue = queue
        self.transfer = transfer
        self.engine_id = engine_id
        self.transfer_timeout = transfer_timeout
        # advertise the streamed-handoff capability; off = bulk end to end
        self.kv_stream = kv_stream
        # delivery-flavor counters (streamed_deliveries / bulk_deliveries /
        # kv_stream_segments / ici_handoffs are WorkerLoad keys); the rest
        # are handoff diagnostics. No same-slice landing: ici_* stay 0
        self.stats = {
            "remote_prefills": 0, "local_prefills": 0, "remote_errors": 0,
            "streamed_deliveries": 0, "bulk_deliveries": 0,
            "kv_stream_segments": 0, "kv_stream_regroups": 0,
            "ici_handoffs": 0, "ici_segments": 0,
        }
        #: one record per remote request: handoff_ms (enqueue -> delivery),
        #: the landing's scatter_ms, mode and n_blocks
        self.handoffs: deque = deque(maxlen=HANDOFF_RECORDS)

    def _connection(self) -> dict:
        if isinstance(self.transfer, LocalKvPipe):
            conn = {"local": True}
        else:
            conn = self.transfer.address.to_dict()
        if self.kv_stream:
            conn["kv_stream"] = KV_STREAM_VERSION
        # wire-codec capability: this decode side dequantizes (or adopts)
        # int8/fp8 deliveries on landing, whatever its own --kv-quant
        conn["kv_quant"] = KV_QUANT_WIRE_VERSION
        return conn

    async def generate(self, request: Context) -> AsyncIterator[LLMEngineOutput]:
        req = request.data
        if isinstance(req, dict):
            req = PreprocessedRequest.from_dict(req)
            request = request.transfer(req)
        prompt_len = len(req.token_ids or [])
        handle = None
        remote = False
        # a prompt under the threshold can never go remote (a cached prefix
        # only shortens it): skip the reservation and the depth RPC
        if (self.router.config.enabled
                and prompt_len > self.router.config.max_local_prefill_length):
            handle = self.engine.begin_remote(request)
        if handle is not None:
            depth = await self.queue.get_depth()
            remote = self.router.prefill_remote(
                prompt_len, handle.seq.cached_prefix, depth)
        if not remote:
            if handle is not None:
                self.engine.release_remote(handle)
            self.stats["local_prefills"] += 1
            async for out in self.engine.generate(request):
                yield out
            return

        self.stats["remote_prefills"] += 1
        self.engine.start()
        req_id = request.id
        sink = (_RemoteScatterSink(self.engine, handle, self.stats)
                if self.kv_stream else None)
        fut = self.transfer.expect(req_id, sink=sink)
        rpr = RemotePrefillRequest(
            request_id=req_id,
            request=req.to_dict(),
            skip_blocks=handle.skip_blocks,
            connection=self._connection(),
            engine_id=self.engine_id,
            # the prefill worker derives the queue wait from it
            enqueue_ts=time.time(),
        )
        t_handoff = time.perf_counter()
        try:
            await self.queue.enqueue(rpr)
            delivery = await asyncio.wait_for(fut, self.transfer_timeout)
            handoff_ms = (time.perf_counter() - t_handoff) * 1e3
            self.engine.hist["handoff_ms"].observe(handoff_ms)
        except asyncio.CancelledError:
            # caller went away: the sink closes BEFORE abort_remote frees
            # the pages (an in-flight streamed scatter may be writing them)
            self.transfer.abandon(req_id)
            if sink is not None:
                await sink.aclose()
            self.engine.abort_remote(handle, "cancelled")
            raise
        except Exception as e:  # noqa: BLE001 — timeout, enqueue or
            # transfer failure: the pages must return to the pool
            self.transfer.abandon(req_id)
            if sink is not None:
                await sink.aclose()
            self.stats["remote_errors"] += 1
            self.engine.abort_remote(handle, f"remote prefill failed: {e}")
            yield await handle.seq.out_queue.get()
            return
        if delivery.error:
            self.stats["remote_errors"] += 1
            if sink is not None:
                await sink.aclose()
            self.engine.abort_remote(handle, delivery.error)
            yield await handle.seq.out_queue.get()
            return
        self.stats["streamed_deliveries" if delivery.streamed
                   else "bulk_deliveries"] += 1
        if sink is not None:
            # a stale concurrent attempt must not scatter into these pages
            # once they commit: its late segments become discards
            await sink.aclose()
        k_data, v_data = delivery.k_data, delivery.v_data
        if k_data is not None and layout_mismatched(
                delivery.head_layout, delivery.src_tp, KV_HEAD_LAYOUT, MESH_TP):
            try:
                k_data = rearrange_for_decode(k_data, delivery.src_tp, MESH_TP,
                                              delivery.head_layout, KV_HEAD_LAYOUT)
                v_data = rearrange_for_decode(v_data, delivery.src_tp, MESH_TP,
                                              delivery.head_layout, KV_HEAD_LAYOUT)
            except Exception as e:  # noqa: BLE001 — bad peer metadata must
                # not leak the reservation or hang the caller
                self.stats["remote_errors"] += 1
                self.engine.abort_remote(handle, f"kv rearrange failed: {e}")
                yield await handle.seq.out_queue.get()
                return
        t_land = time.perf_counter()
        out_queue = await self.engine.complete_remote(
            handle, delivery.first_token, k_data, v_data,
            first_lp=delivery.first_lp,
            k_scales=delivery.k_scales, v_scales=delivery.v_scales)
        self.handoffs.append({
            "request_id": req_id, "handoff_ms": handoff_ms,
            "scatter_ms": (sink.scatter_ms if delivery.streamed
                           else (time.perf_counter() - t_land) * 1e3),
            "mode": "stream" if delivery.streamed else "bulk",
            "n_blocks": delivery.n_blocks, "wire": delivery.kv_quant,
        })
        while True:
            out = await out_queue.get()
            if out is None:
                return
            yield out
            if out.is_final():
                return
