"""Component model: Namespace -> Component -> Endpoint, discovery, clients.

A copy of ``dynamo_tpu/runtime/component.py`` (the reference's component
layer, lib/runtime/src/component.rs, component/{endpoint,client,service}.rs),
with the same store keys, subjects and envelopes and no tracing hooks:

  * store key scheme   ``{ns}/components/{comp}/{endpoint}:{lease_id:x}``
    (ref component.rs:142,234-244) — bound to the worker's primary lease so
    dead workers vanish from discovery automatically,
  * bus subject scheme ``{ns}.{comp}.{endpoint}-{lease_id:x}``
    (ref component.rs:246-257),
  * ``Endpoint.serve(engine)`` = the ingress: subscribe the subject, decode
    the request envelope, run the engine, connect back over TCP and stream
    (ref pipeline/network/ingress/push_endpoint.rs:23-85),
  * ``Client`` = the egress: watch the discovery prefix, keep a live
    instance list, route round_robin/random/direct, push the request and
    await the connect-back stream
    (ref component/client.rs + pipeline/network/egress/push.rs:62-175).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random as _random
import re
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Awaitable, Callable, Optional

from .annotated import Annotated
from .bus import Message, NoResponders
from .engine import AsyncEngine, AsyncEngineContext, Context
from .store import EventKind
from .tcp import ConnectionInfo, connect_response_stream

logger = logging.getLogger(__name__)

_SLUG_RE = re.compile(r"[^a-zA-Z0-9_-]+")


def slug(name: str) -> str:
    """Sanitize a name for bus subjects (ref slug.rs)."""
    return _SLUG_RE.sub("_", name)


@dataclass
class EndpointInfo:
    """Discovery record for one live endpoint instance
    (ref ComponentEndpointInfo, component/endpoint.rs:113-137)."""

    namespace: str
    component: str
    endpoint: str
    lease_id: int
    subject: str
    transport: str = "bus+tcp"

    @property
    def instance_id(self) -> int:
        return self.lease_id

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @staticmethod
    def from_json(raw: bytes) -> "EndpointInfo":
        d = json.loads(raw)
        # ignore unknown keys: a newer peer may advertise fields this
        # process doesn't know yet (version-skew safety)
        fields = EndpointInfo.__dataclass_fields__
        return EndpointInfo(**{k: v for k, v in d.items() if k in fields})


class Namespace:
    def __init__(self, drt, name: str):
        self.drt = drt
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self.drt, self.name, name)


class Component:
    def __init__(self, drt, namespace: str, name: str):
        self.drt = drt
        self.namespace = namespace
        self.name = name

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self.drt, self.namespace, self.name, name)

    @property
    def etcd_root(self) -> str:
        return f"{self.namespace}/components/{self.name}"

    def event_subject(self, event: str) -> str:
        """Subject for component-scoped event planes, e.g. kv_events
        (ref kv_router.rs:41)."""
        return f"{slug(self.namespace)}.{slug(self.name)}.{event}"

    async def scrape_stats(
        self, timeout: float = 1.0, include_missing: bool = False
    ) -> list[dict]:
        """Collect per-instance stats from every live instance of every
        endpoint of this component (ref $SRV stats scrape, component.rs:171).

        With ``include_missing``, an instance that is still discovered but
        missed the reply window (event loop starved on a loaded box) is
        reported with ``data=None`` instead of silently dropped, so callers
        holding a last-known snapshot can tell "slow" from "departed"."""
        entries = self.drt.store.kv_get_prefix(self.etcd_root + "/")
        if asyncio.iscoroutine(entries):
            entries = await entries
        out = []
        for e in entries:
            info = EndpointInfo.from_json(e.value)
            try:
                raw = await self.drt.bus.request(
                    info.subject + ".stats", b"{}", timeout=timeout
                )
                stats = json.loads(raw) if raw else {}
            except NoResponders:
                continue  # instance mid-departure; expected churn
            except asyncio.TimeoutError:
                if include_missing:
                    out.append(
                        {
                            "endpoint": info.endpoint,
                            "instance_id": info.instance_id,
                            "data": None,
                        }
                    )
                continue
            except Exception:  # noqa: BLE001
                logger.exception("bad stats from %s", info.subject)
                continue
            out.append(
                {
                    "endpoint": info.endpoint,
                    "instance_id": info.instance_id,
                    "data": stats,
                }
            )
        return out


@dataclass
class RequestEnvelope:
    """What rides the bus from caller to worker
    (ref RequestControlMessage, egress/push.rs:88-130)."""

    request_id: str
    connection_info: Optional[dict]
    payload: Any
    annotations: dict = field(default_factory=dict)
    # W3C traceparent carrying the caller's trace across the bus hop
    # (absent when tracing is off; decoders must tolerate unknown keys)
    trace: Optional[str] = None

    def to_bytes(self) -> bytes:
        d = {
            "request_id": self.request_id,
            "connection_info": self.connection_info,
            "payload": self.payload,
            "annotations": self.annotations,
        }
        if self.trace is not None:
            d["trace"] = self.trace
        return json.dumps(d).encode()

    @staticmethod
    def from_bytes(raw: bytes) -> "RequestEnvelope":
        d = json.loads(raw)
        return RequestEnvelope(
            d["request_id"], d.get("connection_info"), d.get("payload"),
            d.get("annotations", {}), d.get("trace"),
        )


StatsHandler = Callable[[], dict]


class Endpoint:
    def __init__(self, drt, namespace: str, component: str, name: str):
        self.drt = drt
        self.namespace = namespace
        self.component = component
        self.name = name
        self._serving = False
        self._stats_handler: Optional[StatsHandler] = None
        self._inflight: dict[str, AsyncEngineContext] = {}

    # ---- naming ----
    @property
    def etcd_key(self) -> str:
        return (
            f"{self.namespace}/components/{self.component}/"
            f"{self.name}:{self.drt.primary_lease_id:x}"
        )

    @property
    def discovery_prefix(self) -> str:
        return f"{self.namespace}/components/{self.component}/{self.name}:"

    @property
    def subject(self) -> str:
        return (
            f"{slug(self.namespace)}.{slug(self.component)}."
            f"{slug(self.name)}-{self.drt.primary_lease_id:x}"
        )

    # ---- ingress (worker side) ----
    async def serve(
        self,
        engine: AsyncEngine,
        stats_handler: Optional[StatsHandler] = None,
    ) -> "ServeHandle":
        """Register this endpoint: subscribe its unique subject, advertise in
        the store under the primary lease, handle requests by running the
        engine and streaming responses over the TCP connect-back plane."""
        if self._serving:
            raise RuntimeError(f"endpoint {self.subject} already serving")
        self._serving = True
        self._stats_handler = stats_handler

        bus = self.drt.bus
        sub = bus.subscribe(self.subject, group="workers")
        stats_sub = bus.subscribe(self.subject + ".stats", group="workers")
        # remote bus: wait until subscriptions are confirmed before
        # advertising in discovery, or early requests would hit NoResponders
        for s in (sub, stats_sub):
            ready = getattr(s, "ready", None)
            if ready is not None:
                await ready

        info = EndpointInfo(
            namespace=self.namespace,
            component=self.component,
            endpoint=self.name,
            lease_id=self.drt.primary_lease_id,
            subject=self.subject,
        )
        handle = ServeHandle(self, sub, stats_sub)
        self.drt.runtime.spawn(self._serve_loop(engine, sub), name=f"serve:{self.subject}")
        self.drt.runtime.spawn(self._stats_loop(stats_sub), name=f"stats:{self.subject}")
        created = self.drt.store.kv_create(
            self.etcd_key, info.to_json(), lease_id=self.drt.primary_lease_id
        )
        if asyncio.iscoroutine(created):
            await created
        return handle

    async def _serve_loop(self, engine: AsyncEngine, sub) -> None:
        async for msg in sub:
            self.drt.runtime.spawn(self._handle_request(engine, msg))

    async def _stats_loop(self, sub) -> None:
        async for msg in sub:
            stats = {}
            if self._stats_handler is not None:
                try:
                    stats = self._stats_handler()
                except Exception as e:  # noqa: BLE001
                    stats = {"error": str(e)}
            self.drt.bus.respond(msg, json.dumps(stats).encode())

    async def _handle_request(self, engine: AsyncEngine, msg: Message) -> None:
        """Ingress push handler (ref ingress/push_handler.rs)."""
        writer = None
        env = None
        try:
            env = RequestEnvelope.from_bytes(msg.payload)
            context = AsyncEngineContext(env.request_id)
            self._inflight[env.request_id] = context
            self.drt.bus.respond(msg, b'{"ack":true}')
            request = Context(env.payload, context, env.annotations)
            if env.connection_info is not None:
                info = ConnectionInfo.from_dict(env.connection_info)
                writer = await connect_response_stream(info, context)
                try:
                    async for item in engine.generate(request):
                        if not isinstance(item, Annotated):
                            item = Annotated.from_data(item)
                        await writer.send(item)
                        if context.is_killed():
                            break
                except asyncio.CancelledError:
                    # worker shutdown with this stream mid-flight: the
                    # finally's bare sentinel would hand the caller a
                    # clean-looking TRUNCATED stream — tell the caller
                    # the truth first, then propagate
                    try:
                        await writer.error(
                            "worker shutdown: stream aborted")
                    except Exception:  # noqa: BLE001 - socket may be gone
                        logger.debug(
                            "abort notice lost (socket gone)", exc_info=True
                        )
                    raise
                except Exception as e:  # noqa: BLE001
                    logger.exception("engine error for %s", env.request_id)
                    await writer.error(str(e))
            else:
                # fire-and-forget (no response plane requested)
                async for _ in engine.generate(request):
                    pass
        except Exception as e:  # noqa: BLE001
            logger.exception("ingress failure: %s", e)
        finally:
            if writer is not None:
                # ResponseWriter.close() is async and awaits the
                # transport's wait_closed() itself (runtime/tcp.py)
                await writer.close()
            if env is not None:
                self._inflight.pop(env.request_id, None)

    # ---- client ----
    def client(self) -> "Client":
        return Client(self)


class ServeHandle:
    def __init__(self, endpoint: Endpoint, sub, stats_sub):
        self._endpoint = endpoint
        self._subs = [sub, stats_sub]

    @property
    def endpoint(self) -> Endpoint:
        return self._endpoint

    def inflight_count(self) -> int:
        """Requests this endpoint's ingress is currently streaming."""
        return len(self._endpoint._inflight)

    async def deregister(self) -> None:
        """Graceful-drain step 1 (resilience/drain.py): delete the
        discovery key so routers stop picking this instance, while the
        subject subscription stays live — in-flight streams keep their
        control plane and racing requests still get an honest bounce
        from the draining engine instead of NoResponders."""
        ep = self._endpoint
        deleted = ep.drt.store.kv_delete(ep.etcd_key)
        if asyncio.iscoroutine(deleted):
            await deleted

    async def stop(self) -> None:
        ep = self._endpoint
        deleted = ep.drt.store.kv_delete(ep.etcd_key)
        if asyncio.iscoroutine(deleted):
            await deleted
        for s in self._subs:
            s.unsubscribe()
        ep._serving = False


class Client:
    """Discovery-driven client for one endpoint (ref component/client.rs)."""

    def __init__(self, endpoint: Endpoint):
        self.endpoint = endpoint
        self.drt = endpoint.drt
        self._instances: dict[int, EndpointInfo] = {}
        self._rr = 0
        self._watch_task: Optional[asyncio.Task] = None
        self._instances_changed = asyncio.Event()
        self._started = False

    async def start(self) -> "Client":
        if self._started:
            return self
        self._started = True
        watcher = self.drt.store.watch_prefix(self.endpoint.discovery_prefix)
        if asyncio.iscoroutine(watcher):
            watcher = await watcher
        self._watcher = watcher
        for entry in watcher.snapshot:
            info = EndpointInfo.from_json(entry.value)
            self._instances[info.instance_id] = info
        if self._instances:
            self._instances_changed.set()
        self._watch_task = self.drt.runtime.spawn(self._watch(watcher))
        return self

    async def _watch(self, watcher) -> None:
        async for ev in watcher:
            if ev.kind == EventKind.PUT:
                info = EndpointInfo.from_json(ev.value)
                self._instances[info.instance_id] = info
            elif ev.kind == EventKind.RESUMED:
                # post-reconnect reconcile finished (hub.py): the missed
                # deletes/puts were replayed just above, so the instance
                # map is consistent again — wake any parked waiters
                pass
            else:
                # key format ...{endpoint}:{lease:x}
                try:
                    lease_hex = ev.key.rsplit(":", 1)[1]
                    self._instances.pop(int(lease_hex, 16), None)
                except (IndexError, ValueError):
                    pass
            self._instances_changed.set()

    def stop(self) -> None:
        """Tear down the discovery watch (watcher + task)."""
        if getattr(self, "_watcher", None) is not None:
            self._watcher.cancel()
            self._watcher = None
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None
        self._started = False

    def instance_ids(self) -> list[int]:
        return sorted(self._instances)

    async def wait_for_instances(self, timeout: float = 30.0) -> list[int]:
        deadline = asyncio.get_running_loop().time() + timeout
        while not self._instances:
            if asyncio.get_running_loop().time() >= deadline:
                raise TimeoutError(
                    f"no instances for {self.endpoint.discovery_prefix} after {timeout}s"
                )
            self._instances_changed.clear()
            try:
                await asyncio.wait_for(self._instances_changed.wait(), 0.05)
            except asyncio.TimeoutError:
                pass
        return self.instance_ids()

    # ---- routing policies (ref client.rs:181-244) ----
    def _pick_round_robin(self) -> EndpointInfo:
        ids = self.instance_ids()
        if not ids:
            raise NoResponders(self.endpoint.discovery_prefix)
        info = self._instances[ids[self._rr % len(ids)]]
        self._rr += 1
        return info

    def _pick_random(self) -> EndpointInfo:
        ids = self.instance_ids()
        if not ids:
            raise NoResponders(self.endpoint.discovery_prefix)
        return self._instances[_random.choice(ids)]

    def _pick_direct(self, instance_id: int) -> EndpointInfo:
        info = self._instances.get(instance_id)
        if info is None:
            raise NoResponders(f"instance {instance_id:x} not found")
        return info

    # ---- egress (ref egress/push.rs AddressedPushRouter) ----
    async def generate(
        self,
        request: Context,
        instance_id: Optional[int] = None,
        policy: str = "round_robin",
    ) -> AsyncIterator[Annotated]:
        if instance_id is not None:
            info = self._pick_direct(instance_id)
        elif policy == "random":
            info = self._pick_random()
        else:
            info = self._pick_round_robin()
        return await self._push(info, request)

    async def direct(self, request: Context, instance_id: int) -> AsyncIterator[Annotated]:
        return await self.generate(request, instance_id=instance_id)

    async def round_robin(self, request: Context) -> AsyncIterator[Annotated]:
        return await self.generate(request, policy="round_robin")

    async def random(self, request: Context) -> AsyncIterator[Annotated]:
        return await self.generate(request, policy="random")

    async def _push(self, info: EndpointInfo, request: Context) -> AsyncIterator[Annotated]:
        tcp = await self.drt.tcp_server()
        conn = tcp.register(request.context)
        env = RequestEnvelope(
            request_id=request.id,
            connection_info=conn.to_dict(),
            payload=request.data,
            annotations=request.annotations,
            # no tracing here: the field stays None and is left out of
            # the envelope, as the reference sends it with tracing off
            trace=None,
        )
        try:
            await self.drt.bus.request(info.subject, env.to_bytes(), timeout=10.0)
        except Exception:
            tcp.unregister(conn)
            raise
        return tcp.stream(conn)


class EngineClient(AsyncEngine):
    """Adapter presenting a remote Client as a local AsyncEngine, so remote
    endpoints compose into pipelines transparently (ref dyn:// engines)."""

    def __init__(self, client: Client, policy: str = "round_robin"):
        self._client = client
        self._policy = policy

    async def generate(self, request: Context) -> AsyncIterator[Annotated]:
        stream = await self._client.generate(request, policy=self._policy)
        async for item in stream:
            yield item
