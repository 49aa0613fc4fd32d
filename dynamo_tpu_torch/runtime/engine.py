"""Async engine abstraction: the universal streaming-inference interface.

A copy of ``dynamo_tpu/runtime/engine.py`` (the reference's
lib/runtime/src/engine.rs:47-168): every stage of the serving stack — HTTP
frontend, preprocessor, router, torch worker — implements one interface,
``AsyncEngine.generate(request) -> async stream of responses``, and every
stream carries an ``AsyncEngineContext`` that supports cooperative stop/kill
propagation across process and node boundaries. ``CancellationToken`` is
the runtime's cancellation tree.
"""

from __future__ import annotations

import abc
import asyncio
import logging
import uuid
from typing import Any, AsyncIterator, Callable, Generic, Optional, TypeVar

logger = logging.getLogger(__name__)

Req = TypeVar("Req")
Resp = TypeVar("Resp")


class CancellationToken:
    """Hierarchical cancellation (ref: tokio CancellationToken tree used by
    lib/runtime/src/runtime.rs:38-117).

    Children are cancelled when the parent is; cancelling a child does not
    affect the parent.
    """

    def __init__(self, parent: Optional["CancellationToken"] = None):
        self._event = asyncio.Event()
        self._children: list["CancellationToken"] = []
        self._callbacks: list[Callable[[], None]] = []
        if parent is not None:
            parent._children.append(self)
            if parent.is_cancelled():
                self._event.set()

    def child_token(self) -> "CancellationToken":
        return CancellationToken(parent=self)

    def cancel(self) -> None:
        if self._event.is_set():
            return
        self._event.set()
        for cb in self._callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001 — one bad callback must not
                # stop cancellation fan-out, but it must leave a trace
                logger.debug("cancel callback failed", exc_info=True)
        for child in self._children:
            child.cancel()

    def is_cancelled(self) -> bool:
        return self._event.is_set()

    def on_cancel(self, cb: Callable[[], None]) -> None:
        if self._event.is_set():
            cb()
        else:
            self._callbacks.append(cb)

    async def cancelled(self) -> None:
        await self._event.wait()


class AsyncEngineContext:
    """Per-request stream control (ref: engine.rs:47-85).

    ``stop_generating`` asks the generator to finish gracefully (emit what it
    has, mark finish_reason); ``kill`` tears the stream down immediately.
    Both propagate backwards through pipeline stages and across the network
    via control messages on the response plane.
    """

    def __init__(self, request_id: Optional[str] = None):
        self.id: str = request_id or uuid.uuid4().hex
        self._stop = asyncio.Event()
        self._kill = asyncio.Event()

    # -- control (caller side) --
    def stop_generating(self) -> None:
        self._stop.set()

    def kill(self) -> None:
        self._stop.set()
        self._kill.set()

    # -- observation (generator side) --
    def is_stopped(self) -> bool:
        return self._stop.is_set()

    def is_killed(self) -> bool:
        return self._kill.is_set()

    async def stopped(self) -> None:
        await self._stop.wait()

    async def killed(self) -> None:
        await self._kill.wait()


class Context(Generic[Req]):
    """Request envelope carrying the payload + engine context through pipeline
    stages (ref: pipeline/context.rs).

    ``map`` transforms the payload while preserving identity/control;
    ``transfer`` moves the control context onto a new payload.
    """

    __slots__ = ("data", "context", "annotations")

    def __init__(
        self,
        data: Req,
        context: Optional[AsyncEngineContext] = None,
        annotations: Optional[dict[str, Any]] = None,
    ):
        self.data = data
        self.context = context or AsyncEngineContext()
        self.annotations: dict[str, Any] = annotations or {}

    @property
    def id(self) -> str:
        return self.context.id

    def map(self, fn: Callable[[Req], Any]) -> "Context[Any]":
        return Context(fn(self.data), self.context, self.annotations)

    def transfer(self, data: Any) -> "Context[Any]":
        return Context(data, self.context, self.annotations)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Context(id={self.id!r}, data={type(self.data).__name__})"


class AsyncEngine(abc.ABC, Generic[Req, Resp]):
    """The one interface every serving stage implements
    (ref: engine.rs:104-109 ``AsyncEngine<Req, Resp, E>::generate``)."""

    @abc.abstractmethod
    def generate(self, request: Context[Req]) -> AsyncIterator[Resp]:
        """Return an async iterator of responses for this request.

        Implementations must observe ``request.context`` for stop/kill and
        must raise nothing after the stream completes.
        """

    async def close(self) -> None:  # pragma: no cover - default no-op
        pass


class EngineFn(AsyncEngine[Req, Resp]):
    """Adapter: wrap an async-generator function as an AsyncEngine."""

    def __init__(self, fn: Callable[[Context[Req]], AsyncIterator[Resp]]):
        self._fn = fn

    def generate(self, request: Context[Req]) -> AsyncIterator[Resp]:
        return self._fn(request)


async def collect(stream: AsyncIterator[Resp]) -> list[Resp]:
    """Drain a response stream into a list (test/aggregation helper)."""
    out: list[Resp] = []
    async for item in stream:
        out.append(item)
    return out
