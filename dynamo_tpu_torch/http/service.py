"""OpenAI-compatible HTTP frontend.

A trimmed copy of ``dynamo_tpu/http/service.py`` (the reference's
lib/llm/src/http/service/{service_v2,openai}.rs): routes
/v1/chat/completions and /v1/completions (streaming and not),
/v1/models, /metrics and /health. The service always streams from the
engine and folds chunks for non-streaming clients; a client disconnect
kills the request context so device work is cancelled end to end. The
reference's admission gate, flight recorder, profiler and tracing
endpoints are not ported yet.
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from ..protocols.aggregator import aggregate_chat_chunks, aggregate_completion_chunks
from ..protocols.openai import ChatCompletionRequest, CompletionRequest, RequestError
from ..protocols.sse import encode_data, encode_done, encode_event
from ..runtime.annotated import Annotated
from ..runtime.engine import AsyncEngine, AsyncEngineContext, Context
from .base import HttpError, HttpServerBase
from .metrics import Metrics

logger = logging.getLogger(__name__)


def _chunk_has_tokens(data) -> bool:
    """True when an SSE chunk carries generated content — finish-only and
    usage-only chunks must not count as tokens for TTFT/ITL."""
    if not isinstance(data, dict):
        return True
    for c in data.get("choices") or []:
        delta = c.get("delta") or {}
        if delta.get("content") or c.get("text"):
            return True
        if (c.get("message") or {}).get("content"):
            return True
    return False


class ModelManager:
    """Model name -> engine (ref http/service.rs:58 ModelManager)."""

    def __init__(self):
        self._chat: dict[str, AsyncEngine] = {}
        self._completion: dict[str, AsyncEngine] = {}

    def add_chat_model(self, name: str, engine: AsyncEngine) -> None:
        self._chat[name] = engine

    def add_completion_model(self, name: str, engine: AsyncEngine) -> None:
        self._completion[name] = engine

    def remove_chat_model(self, name: str) -> None:
        self._chat.pop(name, None)

    def remove_completion_model(self, name: str) -> None:
        self._completion.pop(name, None)

    def chat_engine(self, name: str) -> Optional[AsyncEngine]:
        return self._chat.get(name)

    def completion_engine(self, name: str) -> Optional[AsyncEngine]:
        return self._completion.get(name)

    def model_names(self) -> list[str]:
        return sorted(set(self._chat) | set(self._completion))


class HttpService(HttpServerBase):
    """ref service_v2.rs:24 HttpService."""

    def __init__(
        self,
        model_manager: Optional[ModelManager] = None,
        host: str = "0.0.0.0",
        port: int = 8080,
        metrics: Optional[Metrics] = None,
    ):
        super().__init__(host=host, port=port)
        self.models = model_manager or ModelManager()
        self.metrics = metrics or Metrics()

    async def _route(self, method, path, headers, body, writer) -> None:
        path = path.partition("?")[0]
        if method == "GET":
            if path in ("/health", "/live", "/ready"):
                await self._send_json(writer, 200, {"status": "ok"})
            elif path == "/metrics":
                await self._send_response(
                    writer, 200, self.metrics.render().encode(),
                    content_type="text/plain; version=0.0.4",
                )
            elif path == "/v1/models":
                data = [
                    {"id": name, "object": "model", "owned_by": "dynamo_tpu_torch"}
                    for name in self.models.model_names()
                ]
                await self._send_json(writer, 200, {"object": "list", "data": data})
            else:
                raise HttpError(404, f"no route for GET {path}", "not_found")
        elif method == "POST":
            if path == "/v1/chat/completions":
                await self._openai_endpoint(writer, body, chat=True)
            elif path == "/v1/completions":
                await self._openai_endpoint(writer, body, chat=False)
            else:
                raise HttpError(404, f"no route for POST {path}", "not_found")
        else:
            raise HttpError(405, f"method {method} not allowed")

    async def _openai_endpoint(self, writer, body: bytes, chat: bool) -> None:
        endpoint = "chat_completions" if chat else "completions"
        try:
            payload = json.loads(body or b"{}")
        except json.JSONDecodeError as e:
            raise HttpError(400, f"invalid JSON body: {e}") from None
        try:
            req = (
                ChatCompletionRequest.from_dict(payload)
                if chat
                else CompletionRequest.from_dict(payload)
            )
        except RequestError as e:
            raise HttpError(400, str(e)) from None
        engine = (
            self.models.chat_engine(req.model)
            if chat
            else self.models.completion_engine(req.model)
        )
        if engine is None:
            raise HttpError(404, f"model {req.model!r} not found", "model_not_found")

        guard = self.metrics.inflight_guard(req.model, endpoint)
        context = Context(req, AsyncEngineContext())
        try:
            stream = engine.generate(context)
            if req.stream:
                await self._stream_sse(writer, stream, context, req, guard)
                return
            chunks: list[dict] = []
            error: Optional[str] = None
            async for item in stream:
                ann = item if isinstance(item, Annotated) else Annotated.from_data(item)
                if ann.is_error():
                    error = ann.error or "engine error"
                    break
                if ann.data is not None:
                    if _chunk_has_tokens(ann.data):
                        guard.observe_token()
                    chunks.append(ann.data)
            if error is not None:
                guard.mark("error")
                raise HttpError(500, error, "engine_error")
            if not chunks:
                guard.mark("error")
                raise HttpError(500, "engine produced no output", "engine_error")
            full = (
                aggregate_chat_chunks(chunks)
                if chat
                else aggregate_completion_chunks(chunks)
            )
            self._count_tokens(req.model, full)
            guard.mark_ok()
            await self._send_json(writer, 200, full)
        finally:
            guard.done()

    def _count_tokens(self, model: str, full: dict) -> None:
        usage = full.get("usage") or {}
        if usage.get("prompt_tokens"):
            self.metrics.observe_tokens(model, "prompt", usage["prompt_tokens"])
        if usage.get("completion_tokens"):
            self.metrics.observe_tokens(model, "completion", usage["completion_tokens"])

    async def _stream_sse(self, writer, stream, context: Context, req, guard) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\nTransfer-Encoding: chunked\r\n\r\n"
        )
        await writer.drain()

        async def send(chunk: bytes):
            writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
            await writer.drain()

        include_usage = bool(getattr(req, "stream_options", {}).get("include_usage"))
        ok = True
        try:
            try:
                async for item in stream:
                    ann = item if isinstance(item, Annotated) else Annotated.from_data(item)
                    if ann.is_error():
                        await send(encode_event("error", {"message": ann.error}))
                        ok = False
                        break
                    if ann.event and ann.event != "sentinel":
                        await send(encode_event(
                            ann.event,
                            json.loads(ann.comment[0]) if ann.comment else None,
                        ))
                        continue
                    if ann.data is not None:
                        data = ann.data
                        if isinstance(data, dict) and data.get("usage") is not None:
                            self._count_tokens(req.model, data)
                            if not include_usage:
                                data = {k: v for k, v in data.items() if k != "usage"}
                        if _chunk_has_tokens(data):
                            guard.observe_token()
                        await send(encode_data(data))
            except (ConnectionResetError, BrokenPipeError):
                raise
            except Exception as e:  # noqa: BLE001
                # engine failure mid-stream: the 200 + SSE head is already on
                # the wire, so surface it as an SSE error event
                logger.exception("engine error mid-stream")
                await send(encode_event("error", {"message": str(e)}))
                ok = False
            await send(encode_done())
        except (ConnectionResetError, BrokenPipeError):
            # client went away: kill generation end-to-end
            context.context.kill()
            guard.mark("disconnect")
            return
        try:
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            context.context.kill()
        if ok:
            guard.mark_ok()
