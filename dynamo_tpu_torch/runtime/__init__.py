"""Runtime layer: the AsyncEngine/pipeline abstractions every serving stage
implements (a copy of the single-process subset of ``dynamo_tpu.runtime``;
no hub, bus or TCP plane yet)."""

from .annotated import Annotated
from .engine import AsyncEngine, AsyncEngineContext, Context, collect
from .pipeline import Operator, link

__all__ = [
    "Annotated",
    "AsyncEngine",
    "AsyncEngineContext",
    "Context",
    "Operator",
    "collect",
    "link",
]
