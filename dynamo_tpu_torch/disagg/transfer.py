"""KV block transfer plane: a port of ``dynamo_tpu/disagg/transfer.py``.

The reference system moves KV with one-sided RDMA writes (NIXL); the
reference package inverts that into a push stream over TCP, and this
module speaks the same bytes. Two wire flavors share the framing (the
two-part codec of ``runtime/codec.py``: header JSON + raw bytes, as on the
response plane):

* **bulk** (``send_kv_blocks``): the prefill worker gathers the whole
  ``[L, Hkv, n, bs, D]`` stack after prefill completes and ships it
  layer-chunked: frame i carries layers [i*c, (i+1)*c) of both K and V.
* **streamed** (``KvStreamSender``): the connection opens at prefill
  *start* (the header declares the total geometry), and each prefill
  chunk's freshly computed blocks ship as a ``(b0, n)`` segment, still
  layer-chunked, the moment the chunk's compute finishes, so the transfer
  hides behind the remaining prefill compute. The final frame carries
  ``first_token`` / ``first_lp``; ONE end-to-end ack covers the whole
  stream, so the prefill queue's ack/redeliver semantics are untouched:
  any mid-stream failure means no ack, and the queue redelivers from
  scratch (segment re-scatters are idempotent: the decode blocks are
  pre-allocated and uncommitted until admission).

Payloads are the reference's numpy byte layout: C-order ``[L, Hkv, n, bs,
D]`` stacks of the dtype the header names (``utils/dtypes.py``: "bfloat16",
"float8_e4m3fn", "int8", "float32", ...), as CPU ``torch`` tensors here
(bf16 and e4m3 have no numpy dtype without ``ml_dtypes``). Quantized
payloads (``kv_quant`` in the header, wire version 2) carry per-frame
``ks``/``vs`` scale slices ([layers, n] f32) in each frame's header.
Receivers ignore header keys they do not know.

The decode side either scatters segments incrementally through a
registered **sink** (``DisaggEngine`` wires the engine's paged-cache
scatter) or, when no sink is registered or the sink declines, assembles
the full stack like the bulk path.

In-process prefill -> decode (both engines in one process) goes through
``LocalKvPipe``: the same streamed semantics, but the segments are the
gather's CUDA tensors, handed straight to the decode scatter with no host
hop and no serialization.
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..runtime.codec import TwoPartMessage, read_frame, write_frame, write_frame_parts
from ..runtime.tcp import ConnectionInfo
from ..utils.dtypes import dtype_name, torch_dtype

logger = logging.getLogger(__name__)

#: streamed-protocol version declared in the stream header. Senders only
#: stream when the decode side advertised the capability in its connection
#: info. v2 adds the quantized-KV scale frames (``kv_quant`` header +
#: per-frame ``ks``/``vs`` slices), additionally gated on the receiver's
#: ``kv_quant`` capability key
KV_STREAM_VERSION = 2

#: minimum peer version the streamed protocol itself requires: the v2 frame
#: layout without scale frames IS the v1 layout
KV_STREAM_BASE_VERSION = 1

#: wire codec capability key (connection info / KvPeerFetchRequest): a
#: receiver advertising ``{"kv_quant": 1}`` accepts int8/fp8 payloads +
#: scale frames and dequantizes on landing; senders ship full-width bytes
#: to peers that don't advertise it
KV_QUANT_WIRE_VERSION = 1

#: seconds a sender waits for the receiver's end-to-end ack
ACK_TIMEOUT_S = 30.0


class TransferError(Exception):
    """KV push failed or was not acknowledged: the queue item should be
    redelivered (nack), not treated as delivered."""


class SinkClosed(Exception):
    """The decode side abandoned the request while a stream was landing:
    remaining segments are drained and discarded, not an error."""


@dataclass
class KvDelivery:
    """What the decode side receives for one remote-prefilled request."""

    request_id: str
    first_token: int
    n_blocks: int
    # [L, Hkv, n_blocks, bs, D] tensors (None when n_blocks == 0): CPU
    # tensors off the wire, CUDA tensors through the local pipe
    k_data: Optional[torch.Tensor]
    v_data: Optional[torch.Tensor]
    error: Optional[str] = None
    # sender's kv-head ordering: the decode side regroups on mismatch
    # (ops/kv_rearrange.py)
    head_layout: str = "blocked"
    src_tp: int = 1
    # first token's logprob entry ({"logprob": f, "top": [[id, lp], ...]})
    # when the request asked for logprobs, computed where the logits are
    first_lp: Optional[dict] = None
    # True when the KV already landed incrementally through a stream sink
    streamed: bool = False
    # chained seq hashes of the shipped blocks, prompt order (fleet
    # prefix-cache pulls: the peer may serve a shorter run than asked)
    hashes: Optional[list] = None
    # quantized wire payload (engine/kvquant.py): codec mode + the [L, n]
    # f32 per-(layer, block) scales; "none" = full-width, scales None
    kv_quant: str = "none"
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None


def _land(dst: torch.Tensor, l0: int, l1: int, buf, offset: int) -> int:
    """Copy the bytes of ``dst[l0:l1]`` (a CPU tensor, layer-major) out of
    the frame buffer ``buf`` at byte ``offset``; returns the bytes taken.
    One copy, no intermediate slice of the payload."""
    raw = dst[l0:l1].view(torch.uint8).numpy().reshape(-1)
    raw[:] = np.frombuffer(buf, np.uint8, raw.size, offset)
    return raw.size


def _scales(sl) -> torch.Tensor:
    """A frame header's KB-sized [layers, n] scale slice."""
    return torch.tensor(sl, dtype=torch.float32)


class _StreamAssembler:
    """Per-attempt landing policy for one streamed handoff, shared by the
    TCP server and the in-process pipe. ``begin()`` decides the mode:

    * **sink**: the registered sink accepted; every full-layer segment
      scatters into the decode cache the moment it lands and the final
      delivery carries no data.
    * **buffer**: no sink, or the sink declined; segments accumulate and
      the delivery is the bulk path's full stack.
    * **discard**: nobody is waiting (the decode side abandoned the
      request); frames are consumed and acked so the sender does not
      retry a transfer whose result nobody wants.

    A redelivered stream gets a FRESH assembler (and a fresh
    ``sink.begin``), so a half-landed first attempt leaves no state."""

    def __init__(self, request_id: str, head: dict, sink, discard: bool):
        self.request_id = request_id
        self.head = head
        self.n = int(head.get("n_blocks") or 0)
        self.kv_quant = str(head.get("kv_quant") or "none")
        self._candidate = sink
        self.sink = None
        self.discard = discard
        self.parts: list[tuple] = []
        self.segments = 0
        self.covered = 0

    async def begin(self) -> None:
        if self.discard:
            return
        if self._candidate is not None and await self._candidate.begin(self.head):
            self.sink = self._candidate

    async def add_segment(self, b0: int, k_seg, v_seg, ks=None, vs=None) -> None:
        """One full-layer segment ([L, Hkv, nseg, bs, D] pair) starting at
        block offset ``b0`` within the shipped range; ``ks``/``vs`` ([L,
        nseg] f32) ride along on quantized streams."""
        if self.discard:
            return
        if b0 != self.covered:
            # segments are emitted in block order; an out-of-order or
            # duplicate b0 could sum to n_blocks with real blocks uncovered
            raise ConnectionError(
                f"kv stream segment out of order: b0={b0}, expected "
                f"{self.covered}"
            )
        if self.kv_quant != "none" and ks is None:
            # landing raw codes as KV would commit garbage with a clean ack
            raise ConnectionError("kv stream quantized segment without scales")
        self.segments += 1
        self.covered += int(k_seg.shape[2])
        if self.sink is not None:
            try:
                if ks is not None:
                    await self.sink.segment(b0, k_seg, v_seg, ks, vs)
                else:
                    await self.sink.segment(b0, k_seg, v_seg)
            except SinkClosed:
                # abandoned mid-stream: drain the rest and ack
                self.sink = None
                self.discard = True
                self.parts.clear()
            return
        self.parts.append((b0, k_seg, v_seg, ks, vs))

    def check_complete(self) -> None:
        """Before the ack: every declared block must have landed (a
        reservation whose missing pages hold recycled KV must never
        commit)."""
        if self.discard:
            return
        if self.covered != self.n:
            raise ConnectionError(
                f"kv stream incomplete: {self.covered}/{self.n} blocks"
            )

    def delivery(self, fin: dict) -> KvDelivery:
        first_token = int(fin.get("first_token", -1))
        first_lp = fin.get("first_lp")
        head = self.head
        if self.sink is not None or self.n == 0:
            return KvDelivery(
                self.request_id, first_token, self.n, None, None,
                head_layout=head.get("head_layout", "blocked"),
                src_tp=head.get("src_tp", 1), first_lp=first_lp,
                streamed=self.sink is not None,
            )
        # add_segment enforced in-order contiguous b0
        k = torch.cat([p[1] for p in self.parts], dim=2)
        v = torch.cat([p[2] for p in self.parts], dim=2)
        ks = vs = None
        if self.kv_quant != "none":
            ks = torch.cat([p[3] for p in self.parts], dim=1)
            vs = torch.cat([p[4] for p in self.parts], dim=1)
        return KvDelivery(
            self.request_id, first_token, self.n, k, v,
            head_layout=head.get("head_layout", "blocked"),
            src_tp=head.get("src_tp", 1), first_lp=first_lp,
            kv_quant=self.kv_quant, k_scales=ks, v_scales=vs,
        )


def _geometry(head: dict, n: int, what: str) -> tuple:
    """(shape, v_shape, dtype) of a header declaring ``n`` blocks, checked:
    rank-5 ``[L, Hkv, n, bs, D]`` and a block dim equal to ``n``, or it is
    not our schema (a drifted header must not read as a zero-block
    delivery)."""
    shape = tuple(head.get("shape") or ())
    v_shape = tuple(head.get("v_shape") or shape)
    if n and (len(shape) != 5 or len(v_shape) != 5 or not head.get("dtype")):
        raise ConnectionError(f"{what} header missing geometry: {head}")
    if shape[2:3] and int(shape[2]) != n:
        raise ConnectionError(f"{what} header geometry mismatch: {head}")
    # resolved lazily: a zero-block delivery ships dtype ""
    return shape, v_shape, torch_dtype(head["dtype"]) if n else None


class KvTransferServer:
    """Decode-side listener. ``expect(request_id)`` registers a pending
    delivery and returns its future; the prefill worker connects back with
    the data. ``expect`` optionally registers a stream *sink*:
    streamed-protocol segments then scatter into the decode cache as they
    arrive instead of buffering the full stack."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 advertise_host: Optional[str] = None):
        self._host = host
        self._port = port
        self._advertise = advertise_host
        self._server: Optional[asyncio.AbstractServer] = None
        self._pending: dict[str, asyncio.Future] = {}
        self._sinks: dict[str, object] = {}

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self._host,
                                                  self._port)
        self._port = self._server.sockets[0].getsockname()[1]

    @property
    def address(self) -> ConnectionInfo:
        """The ADVERTISED address shipped to prefill workers (routable from
        their hosts, not the bind address, which may be 0.0.0.0)."""
        host = self._advertise
        if not host:
            host = self._host
            if host in ("0.0.0.0", "::"):
                import socket

                host = socket.gethostbyname(socket.gethostname())
        return ConnectionInfo(f"{host}:{self._port}", "kv")

    async def close(self) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.cancel()
        self._pending.clear()
        self._sinks.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def expect(self, request_id: str, sink=None) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._pending[request_id] = fut
        if sink is not None:
            self._sinks[request_id] = sink
        return fut

    def abandon(self, request_id: str) -> None:
        self._sinks.pop(request_id, None)
        fut = self._pending.pop(request_id, None)
        if fut is not None and not fut.done():
            fut.cancel()

    def _resolve(self, request_id: str) -> Optional[asyncio.Future]:
        self._sinks.pop(request_id, None)
        return self._pending.pop(request_id, None)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            frame = await read_frame(reader)
            if frame is None:
                return
            head = json.loads(frame.header)
            req_id = head.get("request_id")
            if not req_id:
                raise ConnectionError(
                    f"kv transfer header missing request_id: {head}")
            # look up (don't pop): on a mid-stream failure the future must
            # stay pending for the sender's redelivery
            fut = self._pending.get(req_id)
            if head.get("error"):
                writer.write(b"ok")
                await writer.drain()
                fut = self._resolve(req_id)
                if fut is not None and not fut.done():
                    fut.set_result(
                        KvDelivery(req_id, -1, 0, None, None, error=head["error"]))
                return
            if head.get("stream"):
                await self._handle_stream(reader, writer, head)
                return
            n = int(head.get("n_blocks") or 0)
            shape, v_shape, dt = _geometry(head, n, "kv transfer")
            layer_chunk = int(head.get("layer_chunk") or 1)
            kv_quant = str(head.get("kv_quant") or "none") if n else "none"
            L = shape[0] if shape else 0
            k = torch.empty(shape, dtype=dt) if n else None
            v = torch.empty(v_shape, dtype=dt) if n else None
            ks = vs = None
            if kv_quant != "none":
                ks = torch.empty((L, n), dtype=torch.float32)
                vs = torch.empty((L, n), dtype=torch.float32)
            l0 = 0
            while l0 < L and n:
                part = await read_frame(reader)
                if part is None:
                    raise ConnectionError("kv stream truncated")
                l1 = min(l0 + layer_chunk, L)
                off = _land(k, l0, l1, part.data, 0)
                off += _land(v, l0, l1, part.data, off)
                if off != len(part.data):
                    raise ConnectionError("kv transfer frame size mismatch")
                if kv_quant != "none":
                    h = part.header_json() or {}
                    if h.get("ks") is None or h.get("vs") is None:
                        raise ConnectionError(
                            "kv transfer quantized chunk without scales")
                    ks[l0:l1] = _scales(h["ks"])
                    vs[l0:l1] = _scales(h["vs"])
                l0 = l1
            writer.write(b"ok")
            await writer.drain()
            fut = self._resolve(req_id) or fut
            if fut is not None and not fut.done():
                fut.set_result(KvDelivery(
                    req_id, head["first_token"], n, k, v,
                    head_layout=head.get("head_layout", "blocked"),
                    src_tp=head.get("src_tp", 1),
                    first_lp=head.get("first_lp"),
                    hashes=head.get("hashes"),
                    kv_quant=kv_quant, k_scales=ks, v_scales=vs,
                ))
        except Exception:  # noqa: BLE001 — receive failed mid-stream: no ack
            # is sent, the sender sees a TransferError and redelivers; the
            # pending future survives for that retry
            logger.exception("kv transfer receive failed; awaiting redelivery")
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (OSError, ConnectionError):
                pass

    async def _handle_stream(self, reader, writer, head: dict) -> None:
        """Streamed-protocol receive, header already read. A mid-stream
        failure sends no ack and leaves the pending future for the
        redelivery."""
        req_id = head.get("request_id")
        fut = self._pending.get(req_id)
        asm = _StreamAssembler(req_id, head, self._sinks.get(req_id),
                               discard=fut is None or fut.done())
        await asm.begin()
        n = asm.n
        shape, v_shape, dt = _geometry(head, n, "kv stream")
        L = shape[0] if shape else 0
        quant = asm.kv_quant != "none"
        seg_b0, seg_filled = -1, 0
        seg_k = seg_v = seg_ks = seg_vs = None
        fin: Optional[dict] = None
        # read-ahead: the NEXT frame's socket read overlaps the current
        # segment's scatter
        pending = asyncio.ensure_future(read_frame(reader))
        try:
            while fin is None:
                part = await pending
                if part is None:
                    raise ConnectionError("kv stream truncated")
                h = part.header_json() or {}
                if h.get("fin"):
                    fin = h
                    break
                pending = asyncio.ensure_future(read_frame(reader))
                if asm.discard:
                    continue  # nobody is waiting: consume frames to the ack
                b0, ns, l0, l1 = h.get("b0"), h.get("n"), h.get("l0"), h.get("l1")
                if None in (b0, ns, l0, l1):
                    raise ConnectionError(
                        f"kv stream frame missing segment geometry: {h}")
                if b0 != seg_b0:
                    if seg_k is not None and seg_filled != L:
                        raise ConnectionError("kv stream segment interleaved")
                    seg_b0, seg_filled = b0, 0
                    seg_k = torch.empty((L, shape[1], ns) + shape[3:], dtype=dt)
                    seg_v = torch.empty((L, v_shape[1], ns) + v_shape[3:], dtype=dt)
                    if quant:
                        seg_ks = torch.empty((L, ns), dtype=torch.float32)
                        seg_vs = torch.empty((L, ns), dtype=torch.float32)
                if l0 != seg_filled:
                    # a layer gap would land uninitialized rows
                    raise ConnectionError(
                        f"kv stream layer gap: got [{l0},{l1}) at fill "
                        f"{seg_filled}")
                off = _land(seg_k, l0, l1, part.data, 0)
                off += _land(seg_v, l0, l1, part.data, off)
                if off != len(part.data):
                    raise ConnectionError("kv stream frame size mismatch")
                if quant:
                    if h.get("ks") is None or h.get("vs") is None:
                        raise ConnectionError(
                            "kv stream quantized frame without scales")
                    seg_ks[l0:l1] = _scales(h["ks"])
                    seg_vs[l0:l1] = _scales(h["vs"])
                seg_filled = l1
                if l1 == L:
                    await asm.add_segment(b0, seg_k, seg_v, seg_ks, seg_vs)
                    seg_k = seg_v = seg_ks = seg_vs = None
        finally:
            if not pending.done():
                pending.cancel()
        if seg_k is not None and seg_filled != L:
            raise ConnectionError("kv stream ended mid-segment")
        asm.check_complete()
        writer.write(b"ok")
        await writer.drain()
        fut = self._resolve(req_id) or fut
        if fut is not None and not fut.done():
            fut.set_result(asm.delivery(fin))


async def _connect(connection) -> tuple:
    if isinstance(connection, dict):
        connection = ConnectionInfo.from_dict(connection)
    host, port = connection.address.rsplit(":", 1)
    try:
        return await asyncio.open_connection(host, int(port))
    except OSError as e:
        raise TransferError(f"connect to {connection.address} failed: {e}") from e


async def _close(writer) -> None:
    writer.close()
    try:
        await writer.wait_closed()
    except (OSError, ConnectionError):
        pass


def _scale_header(ks, vs, l0: int, l1: int) -> dict:
    """This chunk's layers' scale slices (f32 -> float round-trips exactly
    in JSON)."""
    return {"ks": ks[l0:l1].float().tolist(), "vs": vs[l0:l1].float().tolist()}


async def send_kv_blocks(
    connection: ConnectionInfo | dict,
    request_id: str,
    first_token: int,
    k_data: Optional[torch.Tensor],
    v_data: Optional[torch.Tensor],
    layer_chunk: int = 4,
    error: Optional[str] = None,
    head_layout: str = "blocked",
    src_tp: int = 1,
    first_lp: Optional[dict] = None,
    hashes: Optional[list] = None,
    kv_quant: str = "none",
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> None:
    """Prefill-side push of one request's KV (CPU tensors) or an error
    notification. ``hashes`` names the shipped blocks' chained seq hashes
    (fleet prefix-cache pulls). ``kv_quant`` + ``k_scales``/``v_scales``
    ([L, n] f32) ship a quantized payload: callers must have checked the
    receiver's ``kv_quant`` capability first."""
    reader, writer = await _connect(connection)
    try:
        n = 0 if k_data is None else int(k_data.shape[2])
        head = {
            "request_id": request_id,
            "first_token": int(first_token),
            "n_blocks": n,
            "shape": [] if k_data is None else list(k_data.shape),
            "v_shape": [] if v_data is None else list(v_data.shape),
            "dtype": "" if k_data is None else dtype_name(k_data.dtype),
            "layer_chunk": layer_chunk,
            "error": error,
            "head_layout": head_layout,
            "src_tp": src_tp,
            "first_lp": first_lp,
        }
        if hashes is not None:
            head["hashes"] = list(hashes)
        if n and kv_quant != "none":
            head["kv_quant"] = kv_quant
        await write_frame(writer, TwoPartMessage(json.dumps(head).encode(), b""))
        if n:
            L = k_data.shape[0]
            k_data, v_data = k_data.contiguous(), v_data.contiguous()
            for l0 in range(0, L, layer_chunk):
                l1 = min(l0 + layer_chunk, L)
                fh = b""
                if kv_quant != "none":
                    fh = json.dumps(_scale_header(k_scales, v_scales, l0, l1)).encode()
                # zero-copy views, one drain per frame: the sender paces
                # itself to the socket
                await write_frame_parts(writer, fh, (k_data[l0:l1], v_data[l0:l1]))
        await writer.drain()
        # require the receiver's ack: anything else (EOF after a receive
        # failure) must surface as a retriable error
        ack = await asyncio.wait_for(reader.readexactly(2), timeout=ACK_TIMEOUT_S)
        if ack != b"ok":
            raise TransferError(f"receiver did not acknowledge (got {ack!r})")
    except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError) as e:
        raise TransferError(str(e)) from e
    finally:
        await _close(writer)


class KvStreamSender:
    """Prefill-side streamed push: opened at prefill START, fed one segment
    per completed prefill chunk, finished with the sampled first token.
    Segment frames are layer-chunked with a per-frame drain; the single
    end-to-end ack arrives in :meth:`finish`."""

    def __init__(self, reader, writer, request_id: str, head: dict):
        self._reader = reader
        self._writer = writer
        self.request_id = request_id
        self._layers = int(head["shape"][0]) if head.get("shape") else 0
        self._layer_chunk = max(int(head.get("layer_chunk") or 1), 1)
        self.segments = 0

    @classmethod
    async def open(cls, connection: ConnectionInfo | dict, request_id: str,
                   head: dict) -> "KvStreamSender":
        """Connect and ship the geometry header (request_id / stream /
        n_blocks / shape / v_shape / dtype / layer_chunk / head_layout /
        src_tp)."""
        reader, writer = await _connect(connection)
        sender = cls(reader, writer, request_id, head)
        try:
            await write_frame(writer, TwoPartMessage(json.dumps(head).encode(), b""))
        except (OSError, ConnectionError) as e:
            await sender.aclose()
            raise TransferError(str(e)) from e
        return sender

    async def send_segment(self, b0: int, k_seg: torch.Tensor,
                           v_seg: torch.Tensor, ks=None, vs=None) -> None:
        """Ship one segment (CPU tensors [L, Hkv, nseg, bs, D]) starting at
        block offset ``b0``; ``ks``/``vs`` ([L, nseg] f32, quantized
        streams only) ride each frame's header."""
        ns = int(k_seg.shape[2])
        k_seg, v_seg = k_seg.contiguous(), v_seg.contiguous()
        try:
            for l0 in range(0, self._layers, self._layer_chunk):
                l1 = min(l0 + self._layer_chunk, self._layers)
                h = {"b0": b0, "n": ns, "l0": l0, "l1": l1}
                if ks is not None:
                    h.update(_scale_header(ks, vs, l0, l1))
                await write_frame_parts(self._writer, json.dumps(h).encode(),
                                        (k_seg[l0:l1], v_seg[l0:l1]))
            self.segments += 1
        except (OSError, ConnectionError) as e:
            raise TransferError(str(e)) from e

    async def finish(self, first_token: int, first_lp: Optional[dict] = None,
                     ack_timeout: float = ACK_TIMEOUT_S) -> None:
        """Fin frame + the stream's single end-to-end ack."""
        try:
            fin = {"fin": 1, "first_token": int(first_token), "first_lp": first_lp}
            await write_frame(self._writer,
                              TwoPartMessage(json.dumps(fin).encode(), b""))
            ack = await asyncio.wait_for(self._reader.readexactly(2),
                                         timeout=ack_timeout)
            if ack != b"ok":
                raise TransferError(f"receiver did not acknowledge (got {ack!r})")
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError) as e:
            raise TransferError(str(e)) from e
        finally:
            await self.aclose()

    async def aclose(self) -> None:
        await _close(self._writer)


class LocalKvPipe:
    """In-process transfer: prefill and decode engines share the process,
    so the tensors handed over are the gather's CUDA tensors (prefill
    extract with ``keep_on_device``) and the whole gather -> deliver ->
    scatter path stays on the card: no host copy, no serialization.
    ``open_stream`` is the streamed equivalent."""

    def __init__(self):
        self._pending: dict[str, asyncio.Future] = {}
        self._sinks: dict[str, object] = {}

    def expect(self, request_id: str, sink=None) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._pending[request_id] = fut
        if sink is not None:
            self._sinks[request_id] = sink
        return fut

    def abandon(self, request_id: str) -> None:
        self._sinks.pop(request_id, None)
        fut = self._pending.pop(request_id, None)
        if fut is not None and not fut.done():
            fut.cancel()

    async def deliver(self, request_id: str, first_token: int, k_data, v_data,
                      error: Optional[str] = None, head_layout: str = "blocked",
                      src_tp: int = 1, first_lp: Optional[dict] = None) -> None:
        self._sinks.pop(request_id, None)
        fut = self._pending.pop(request_id, None)
        if fut is None or fut.done():
            return
        n = 0 if k_data is None else int(k_data.shape[2])
        fut.set_result(KvDelivery(
            request_id, first_token, n, k_data, v_data, error,
            head_layout=head_layout, src_tp=src_tp, first_lp=first_lp,
        ))

    async def open_stream(self, request_id: str, head: dict) -> "LocalKvStream":
        """Streamed in-process handoff: the TCP server's assembler policy
        (sink scatter / buffered fallback / discard), zero serialization."""
        fut = self._pending.get(request_id)
        asm = _StreamAssembler(request_id, head, self._sinks.get(request_id),
                               discard=fut is None or fut.done())
        await asm.begin()
        return LocalKvStream(self, request_id, asm)


class LocalKvStream:
    """One streamed handoff over the in-process pipe: ``send_segment()``
    per completed prefill chunk, then ``finish()`` resolves the decode
    side's delivery future."""

    def __init__(self, pipe: LocalKvPipe, request_id: str, asm: _StreamAssembler):
        self._pipe = pipe
        self.request_id = request_id
        self._asm = asm
        self.segments = 0

    async def send_segment(self, b0: int, k_seg, v_seg, ks=None, vs=None) -> None:
        # the in-process pipe never quantizes: its segments stay on the card
        await self._asm.add_segment(b0, k_seg, v_seg, ks, vs)
        self.segments += 1

    async def finish(self, first_token: int, first_lp: Optional[dict] = None) -> None:
        try:
            self._asm.check_complete()
        except ConnectionError as e:
            # leave the decode future pending for the redelivery, exactly
            # like a TCP truncation: the sender must nack, not ack
            raise TransferError(str(e)) from e
        self._pipe._sinks.pop(self.request_id, None)
        fut = self._pipe._pending.pop(self.request_id, None)
        if fut is None or fut.done():
            return
        fut.set_result(
            self._asm.delivery({"first_token": first_token, "first_lp": first_lp}))

    async def aclose(self) -> None:
        """Abort: the decode side's future stays pending for the queue
        redelivery, mirroring a TCP truncation."""
