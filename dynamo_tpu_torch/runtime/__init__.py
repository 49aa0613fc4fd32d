"""Distributed runtime layer: the port's copy of ``dynamo_tpu.runtime``.

Control-plane store with leases/watch, message bus, TCP response plane,
the TCP hub serving both to other processes, the component model with
lease-backed discovery, and the AsyncEngine/pipeline abstractions every
serving stage implements. Store keys, bus subjects and every frame are the
reference's, so port and reference processes share one hub.
"""

from .annotated import Annotated
from .bus import LocalBus, Message, NoResponders
from .codec import TwoPartMessage, decode_buffer, encode, read_frame, write_frame
from .component import (
    Client,
    Component,
    Endpoint,
    EndpointInfo,
    EngineClient,
    Namespace,
    RequestEnvelope,
    slug,
)
from .engine import (
    AsyncEngine,
    AsyncEngineContext,
    CancellationToken,
    Context,
    EngineFn,
    collect,
)
from .pipeline import MapOperator, Operator, link
from .runtime import DistributedRuntime, Runtime, Worker
from .store import (
    EventKind,
    KeyExists,
    KvEntry,
    LeaseKeeper,
    LocalStore,
    StoreError,
    ValidationFailed,
    WatchEvent,
)
from .tcp import ConnectionInfo, TcpStreamServer, connect_response_stream

__all__ = [
    "Annotated",
    "AsyncEngine",
    "AsyncEngineContext",
    "CancellationToken",
    "Client",
    "Component",
    "ConnectionInfo",
    "Context",
    "DistributedRuntime",
    "Endpoint",
    "EndpointInfo",
    "EngineClient",
    "EngineFn",
    "EventKind",
    "KeyExists",
    "KvEntry",
    "LeaseKeeper",
    "LocalBus",
    "LocalStore",
    "MapOperator",
    "Message",
    "Namespace",
    "NoResponders",
    "Operator",
    "RequestEnvelope",
    "Runtime",
    "StoreError",
    "TcpStreamServer",
    "TwoPartMessage",
    "ValidationFailed",
    "WatchEvent",
    "Worker",
    "collect",
    "connect_response_stream",
    "decode_buffer",
    "encode",
    "link",
    "read_frame",
    "slug",
    "write_frame",
]
