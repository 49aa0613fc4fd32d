"""Response data plane: direct TCP connect-back streaming.

A copy of ``dynamo_tpu/runtime/tcp.py`` (the reference's TCP stream
server, lib/runtime/src/pipeline/network/tcp/{server,client}.rs), with the
same frames on the wire and no tracing hooks: the request plane
(bus) only carries small request envelopes; token streams flow on dedicated
TCP connections that the *worker opens back to the caller*, so response
bytes never transit the bus. The caller registers a pending stream and ships
``ConnectionInfo`` inside the request; the worker connects, handshakes with
a prologue naming the stream id, then streams two-part frames. The caller
can send ``stop``/``kill`` control frames upstream on the same connection
(ref pipeline/network.rs:58 ControlMessage) — this is how client
disconnects cancel device work across processes.
"""

from __future__ import annotations

import asyncio
import json
import logging
import uuid
from dataclasses import dataclass
from typing import AsyncIterator, Optional

from .annotated import Annotated
from .codec import TwoPartMessage, read_frame, write_frame
from .engine import AsyncEngineContext

logger = logging.getLogger(__name__)

# frame types
T_PROLOGUE = "prologue"
T_DATA = "data"
T_SENTINEL = "sentinel"
T_CONTROL = "control"
T_ERROR = "error"


@dataclass
class ConnectionInfo:
    address: str  # "host:port"
    stream_id: str

    def to_dict(self) -> dict:
        return {"address": self.address, "stream_id": self.stream_id}

    @staticmethod
    def from_dict(d: dict) -> "ConnectionInfo":
        return ConnectionInfo(d["address"], d["stream_id"])


class _PendingStream:
    def __init__(self, context: AsyncEngineContext):
        self.context = context
        self.queue: asyncio.Queue[Optional[Annotated]] = asyncio.Queue()
        self.connected = asyncio.get_running_loop().create_future()


class TcpStreamServer:
    """Caller-side server accepting worker connect-backs
    (ref tcp/server.rs:74-125)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self._pending: dict[str, _PendingStream] = {}
        self.address: str = ""

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self._host, self._port)
        port = self._server.sockets[0].getsockname()[1]
        self.address = f"{self._host}:{port}"

    async def close(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def register(self, context: AsyncEngineContext) -> ConnectionInfo:
        """Register a pending response stream; returns the ConnectionInfo to
        embed in the outgoing request envelope."""
        stream_id = uuid.uuid4().hex
        self._pending[stream_id] = _PendingStream(context)
        return ConnectionInfo(self.address, stream_id)

    def unregister(self, info: ConnectionInfo) -> None:
        self._pending.pop(info.stream_id, None)

    async def stream(
        self, info: ConnectionInfo, connect_timeout: float = 30.0
    ) -> AsyncIterator[Annotated]:
        """Await the worker connect-back, then yield the Annotated stream."""
        pending = self._pending[info.stream_id]
        try:
            await asyncio.wait_for(asyncio.shield(pending.connected), connect_timeout)
            while True:
                item = await pending.queue.get()
                if item is None:
                    return
                yield item
        finally:
            self._pending.pop(info.stream_id, None)

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        pending: Optional[_PendingStream] = None
        control_task: Optional[asyncio.Task] = None
        try:
            prologue = await read_frame(reader)
            if prologue is None:
                return
            # tolerant reads: newer peers may add header keys (e.g. the
            # trace context) — decode what we know, ignore the rest
            stream_id = prologue.header_field("stream_id", "")
            pending = self._pending.get(stream_id)
            if pending is None or pending.connected.done():
                await write_frame(
                    writer, TwoPartMessage.from_json({"type": T_ERROR, "error": "unknown stream"})
                )
                return
            await write_frame(writer, TwoPartMessage.from_json({"type": T_PROLOGUE, "ok": True}))
            pending.connected.set_result(True)

            # forward stop/kill from the caller's context upstream
            control_task = asyncio.get_running_loop().create_task(
                self._send_control(pending.context, writer)
            )

            ended_clean = False
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    # EOF with NO sentinel: the worker died mid-stream.
                    # Silently ending here would hand the consumer a
                    # truncated stream indistinguishable from a complete
                    # one — it must surface as an error.
                    break
                ftype = frame.header_field("type")
                if ftype == T_DATA:
                    payload = json.loads(frame.data) if frame.data else {}
                    pending.queue.put_nowait(Annotated.from_dict(payload))
                elif ftype == T_SENTINEL:
                    ended_clean = True
                    break
                elif ftype == T_ERROR:
                    ended_clean = True  # error IS a terminal signal
                    pending.queue.put_nowait(Annotated.from_error(
                        frame.header_field("error", "worker error")))
                    break
            if not ended_clean:
                pending.queue.put_nowait(Annotated.from_error(
                    "response stream truncated: worker connection lost "
                    "before the completion sentinel"))
        except (ConnectionResetError, asyncio.IncompleteReadError):
            if pending is not None:
                pending.queue.put_nowait(Annotated.from_error(
                    "response stream truncated: worker connection reset"))
        except Exception as e:  # noqa: BLE001
            logger.warning("response stream error: %s", e)
            if pending is not None:
                pending.queue.put_nowait(Annotated.from_error(str(e)))
        finally:
            if control_task:
                control_task.cancel()
            if pending is not None:
                if not pending.connected.done():
                    pending.connected.set_exception(ConnectionError("worker hung up"))
                pending.queue.put_nowait(None)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass  # peer already gone — the fd is released either way

    @staticmethod
    async def _send_control(context: AsyncEngineContext, writer: asyncio.StreamWriter):
        try:
            await context.stopped()
            msg = "kill" if context.is_killed() else "stop"
            await write_frame(writer, TwoPartMessage.from_json({"type": T_CONTROL, "msg": msg}))
        except Exception:  # noqa: BLE001
            # control is best-effort (the data plane surfaces real
            # failures) — but a silent swallow hid a dead control plane
            # once already, so leave a trace for debugging
            logger.debug("control-frame send failed", exc_info=True)


class ResponseWriter:
    """Worker-side handle for streaming responses back to the caller
    (ref tcp/client.rs:37-75)."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        context: AsyncEngineContext,
    ):
        self._reader = reader
        self._writer = writer
        self.context = context
        self._control_task = asyncio.get_running_loop().create_task(self._recv_control())

    async def _recv_control(self):
        try:
            while True:
                frame = await read_frame(self._reader)
                if frame is None:
                    # caller hung up -> kill generation (ref: disconnect => kill)
                    self.context.kill()
                    return
                if frame.header_field("type") == T_CONTROL:
                    if frame.header_field("msg") == "kill":
                        self.context.kill()
                    else:
                        self.context.stop_generating()
        except Exception:
            self.context.kill()

    async def send(self, item: Annotated) -> None:
        payload = item.to_dict(
            data_to_dict=lambda d: d.to_dict() if hasattr(d, "to_dict") else d
        )
        await write_frame(
            self._writer,
            TwoPartMessage(
                header=json.dumps({"type": T_DATA}).encode(),
                data=json.dumps(payload).encode(),
            ),
        )

    async def error(self, message: str) -> None:
        await write_frame(
            self._writer, TwoPartMessage.from_json({"type": T_ERROR, "error": message})
        )

    async def close(self) -> None:
        self._control_task.cancel()
        try:
            await write_frame(self._writer, TwoPartMessage.from_json({"type": T_SENTINEL}))
        except (ConnectionResetError, BrokenPipeError):
            pass
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass  # peer already gone — the fd is released either way


async def connect_response_stream(
    info: ConnectionInfo, context: AsyncEngineContext, timeout: float = 10.0
) -> ResponseWriter:
    """Worker side: open the connect-back stream to the caller."""
    host, port_s = info.address.rsplit(":", 1)
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, int(port_s)), timeout
    )
    # the reference adds "traceparent" here when tracing is on; peers read
    # header keys tolerantly, so its absence is wire-compatible
    prologue = {"type": T_PROLOGUE, "stream_id": info.stream_id}
    await write_frame(writer, TwoPartMessage.from_json(prologue))
    resp = await read_frame(reader)
    head = (resp.header_json() or {}) if resp else {}
    if not head.get("ok"):
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
        raise ConnectionError(f"handshake rejected: {head}")
    return ResponseWriter(reader, writer, context)
