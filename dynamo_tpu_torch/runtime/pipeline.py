"""Typed streaming pipeline graph.

Re-design of the reference's pipeline nodes
(lib/runtime/src/pipeline/nodes.rs:72-210): serving stacks are composed of
stages linked frontend -> ... -> backend where a bidirectional *operator*
(e.g. the preprocessor) transforms the request on the forward edge and the
response stream on the backward edge, in one object, so paired state (like a
request's sampling options needed during post-processing) lives in one
place.

In this asyncio design an operator is simply::

    class Op(Operator[In, Out, RespIn, RespOut]):
        async def generate(self, request: Context[In], next: AsyncEngine[Out, RespIn])
            -> AsyncIterator[RespOut]

i.e. forward transformation, call into the next stage, and backward
transformation are one async generator — the natural Python shape of the
reference's forward_edge/backward_edge pair.
"""

from __future__ import annotations

import abc
from typing import Any, AsyncIterator, Generic, TypeVar

from .engine import AsyncEngine, Context

In = TypeVar("In")
Out = TypeVar("Out")
RIn = TypeVar("RIn")
ROut = TypeVar("ROut")


class Operator(abc.ABC, Generic[In, Out, RIn, ROut]):
    """A bidirectional pipeline stage (ref: nodes.rs:122-210 Operator)."""

    @abc.abstractmethod
    def generate(
        self, request: Context[In], next_engine: AsyncEngine[Out, RIn]
    ) -> AsyncIterator[ROut]:
        ...


class _LinkedEngine(AsyncEngine[In, ROut]):
    def __init__(self, op: Operator[In, Out, RIn, ROut], next_engine: AsyncEngine[Out, RIn]):
        self._op = op
        self._next = next_engine

    def generate(self, request: Context[In]) -> AsyncIterator[ROut]:
        return self._op.generate(request, self._next)

    async def close(self) -> None:
        await self._next.close()


def link(*stages: Any) -> AsyncEngine:
    """Compose ``link(op1, op2, ..., engine)`` into one AsyncEngine.

    The last element must be an AsyncEngine (the backend / ServiceBackend);
    the rest must be Operators. Mirrors the reference's link chain
    (launch/dynamo-run/src/input/http.rs:85-101)::

        frontend -> preprocessor.fwd -> backend.fwd -> engine
                 <- preprocessor.bwd <- backend.bwd <-
    """
    if not stages:
        raise ValueError("link() requires at least one engine")
    engine = stages[-1]
    if not isinstance(engine, AsyncEngine):
        raise TypeError(f"last stage must be an AsyncEngine, got {type(engine)}")
    for op in reversed(stages[:-1]):
        if not isinstance(op, Operator):
            raise TypeError(f"intermediate stages must be Operators, got {type(op)}")
        engine = _LinkedEngine(op, engine)
    return engine


class MapOperator(Operator[In, Out, RIn, ROut]):
    """Stateless operator from a request fn and a response fn."""

    def __init__(self, fwd, bwd=None):
        self._fwd = fwd
        self._bwd = bwd

    async def generate(self, request: Context[In], next_engine: AsyncEngine) -> AsyncIterator:
        mapped = request.map(self._fwd)
        async for resp in next_engine.generate(mapped):
            yield self._bwd(resp) if self._bwd else resp
