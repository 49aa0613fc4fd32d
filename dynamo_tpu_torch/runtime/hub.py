"""Control/request-plane hub: the store + bus served over TCP.

A copy of ``dynamo_tpu/runtime/hub.py``, speaking the same protocol, so a
port process and a reference process can share one hub. The reference
runs etcd (discovery/leases) and NATS (request plane) as external services
(lib/runtime/src/transports/{etcd,nats}.rs); this framework ships its own
single-process hub instead of requiring external infrastructure: :class:`HubServer` exposes a LocalStore + LocalBus over one
TCP port using the two-part codec; :class:`RemoteStore`/:class:`RemoteBus`
are drop-in (awaitable) implementations of the same interfaces, so
``DistributedRuntime`` works identically in-process, multi-process on one
host, or multi-host over DCN.

Wire protocol: two-part frames. header = JSON ``{"op": ..., "id": ...,
**args}``; data = opaque payload bytes (values, messages). Server->client
pushes (watch events, bus messages) carry a subscription id instead of a
request id.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import random as _random
from typing import Any, Optional

from .bus import LocalBus, Message, NoResponders, QueueItem, Subscription
from .codec import TwoPartMessage, read_frame, write_frame
from .store import (
    EventKind,
    KeyExists,
    KvEntry,
    LocalStore,
    StoreError,
    ValidationFailed,
    WatchEvent,
    Watcher,
)

logger = logging.getLogger(__name__)

_ERRORS = {
    "KeyExists": KeyExists,
    "ValidationFailed": ValidationFailed,
    "NoResponders": NoResponders,
    "StoreError": StoreError,
}


class HubServer:
    """Serve a LocalStore + LocalBus to remote processes."""

    def __init__(
        self,
        store: Optional[LocalStore] = None,
        bus: Optional[LocalBus] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        data_dir: Optional[str] = None,
    ):
        # data_dir makes BOTH planes durable: the store snapshots+WALs
        # its KV/leases (store.py _restore) and the bus WALs its work
        # queues — a hub restart then loses neither discovery state nor
        # queued work
        self.store = store or LocalStore(data_dir=data_dir)
        self.bus = bus or LocalBus(data_dir=data_dir)
        self._host, self._port = host, port
        self._server: Optional[asyncio.base_events.Server] = None
        self.address = ""
        self._writers: set[asyncio.StreamWriter] = set()

    async def start(self) -> None:
        self.store.start()
        self._server = await asyncio.start_server(self._handle, self._host, self._port)
        port = self._server.sockets[0].getsockname()[1]
        self.address = f"{self._host}:{port}"

    async def close(self) -> None:
        if self._server:
            self._server.close()
            # drop live client connections — wait_closed() (3.12) blocks
            # until every handler ends, and clients that died without a
            # clean close (killed worker host) would hang it forever;
            # abort() skips the write-buffer drain a dead peer never ACKs
            for w in list(self._writers):
                w.transport.abort()
            await self._server.wait_closed()
            self._server = None
        await self.store.close()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        session = _Session(self, writer)
        self._writers.add(writer)
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                try:
                    head = frame.header_json() or {}
                    session.spawn(session.dispatch(head, frame.data))
                except Exception as e:  # noqa: BLE001
                    logger.warning("hub dispatch error: %s", e)
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            self._writers.discard(writer)
            await session.cleanup()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass  # peer already gone — the fd is released either way


class _Session:
    """Per-connection state on the server: its watchers and
    subscriptions (connection-scoped; torn down on disconnect). Leases
    are NOT revoked on disconnect: liveness is the lease TTL alone — a
    dead client stops keepaliving and expires a TTL later, while a
    RECONNECTING client (hub restart, network blip) resumes keepalives
    on its old lease id with its keys intact (etcd semantics,
    transports/etcd.rs:38; eager revoke would delete a live worker's
    registrations the moment the hub bounced)."""

    def __init__(self, hub: HubServer, writer: asyncio.StreamWriter):
        self.hub = hub
        self.writer = writer
        self.watchers: dict[int, Watcher] = {}
        self.subs: dict[int, Subscription] = {}
        self.tasks: set[asyncio.Task] = set()
        self._wlock = asyncio.Lock()

    async def send(self, head: dict, data: bytes = b"") -> None:
        async with self._wlock:
            # this lock exists to serialize whole frames onto ONE stream
            # (interleaved writes would corrupt the framing) — unlike a
            # state lock, holding it across the write is the point
            await write_frame(
                self.writer, TwoPartMessage(json.dumps(head).encode(), data)
            )

    async def reply(self, req_id: int, result: Any = None, data: bytes = b"") -> None:
        await self.send({"op": "reply", "id": req_id, "result": result}, data)

    async def reply_err(self, req_id: int, err: Exception) -> None:
        await self.send(
            {"op": "reply", "id": req_id, "error": str(err), "etype": type(err).__name__}
        )

    def spawn(self, coro) -> None:
        t = asyncio.get_running_loop().create_task(coro)
        self.tasks.add(t)
        t.add_done_callback(self.tasks.discard)

    async def cleanup(self) -> None:
        for t in self.tasks:
            t.cancel()
        for w in self.watchers.values():
            w.cancel()
        for s in self.subs.values():
            s.unsubscribe()

    async def dispatch(self, head: dict, data: bytes) -> None:
        op = head.get("op", "")
        req_id = head.get("id", 0)
        store, bus = self.hub.store, self.hub.bus
        try:
            # ---- store ops ----
            if op == "grant_lease":
                await self.reply(req_id, store.grant_lease(head["ttl"]))
            elif op == "keep_alive":
                await self.reply(req_id, store.keep_alive(head["lease"]))
            elif op == "revoke_lease":
                store.revoke_lease(head["lease"])
                await self.reply(req_id, True)
            elif op in ("kv_put", "kv_create", "kv_create_or_validate"):
                getattr(store, op)(head["key"], data, head.get("lease", 0))
                await self.reply(req_id, True)
            elif op == "kv_get":
                entry = store.kv_get(head["key"])
                if entry is None:
                    await self.reply(req_id, None)
                else:
                    await self.reply(
                        req_id, {"key": entry.key, "lease": entry.lease_id}, entry.value
                    )
            elif op == "kv_get_prefix":
                entries = store.kv_get_prefix(head["prefix"])
                payload = json.dumps(
                    [
                        {"key": e.key, "lease": e.lease_id, "value": e.value.hex()}
                        for e in entries
                    ]
                ).encode()
                await self.reply(req_id, len(entries), payload)
            elif op == "kv_delete":
                await self.reply(req_id, store.kv_delete(head["key"]))
            elif op == "kv_delete_prefix":
                await self.reply(req_id, store.kv_delete_prefix(head["prefix"]))
            elif op == "watch":
                w = store.watch_prefix(head["prefix"])
                wid = head["watch_id"]
                self.watchers[wid] = w
                snap = json.dumps(
                    [
                        {"key": e.key, "lease": e.lease_id, "value": e.value.hex()}
                        for e in w.snapshot
                    ]
                ).encode()
                await self.reply(req_id, wid, snap)
                self.spawn(self._pump_watch(wid, w))
            elif op == "watch_cancel":
                w = self.watchers.pop(head["watch_id"], None)
                if w:
                    w.cancel()
                await self.reply(req_id, True)
            # ---- bus ops ----
            elif op == "publish":
                n = bus.publish(
                    head["subject"], data, head.get("headers") or {}, head.get("reply")
                )
                await self.reply(req_id, n)
            elif op == "subscribe":
                sub = bus.subscribe(head["subject"], head.get("group"))
                sid = head["sub_id"]
                self.subs[sid] = sub
                await self.reply(req_id, sid)
                self.spawn(self._pump_sub(sid, sub))
            elif op == "unsubscribe":
                sub = self.subs.pop(head["sub_id"], None)
                if sub:
                    sub.unsubscribe()
                await self.reply(req_id, True)
            elif op == "request":
                self.spawn(self._do_request(req_id, head, data))
            elif op == "respond":
                bus.respond(
                    Message(head.get("subject", ""), b"", reply=head["reply"]), data
                )
                await self.reply(req_id, True)
            elif op == "queue_push":
                q = bus.work_queue(head["queue"], head.get("redeliver_after", 30.0))
                await self.reply(req_id, q.push(data))
            elif op == "queue_pop":
                self.spawn(self._do_queue_pop(req_id, head))
            elif op == "queue_ack":
                q = bus.work_queue(head["queue"])
                await self.reply(req_id, q.ack(head["item_id"]))
            elif op == "queue_nack":
                q = bus.work_queue(head["queue"])
                await self.reply(req_id, q.nack(head["item_id"]))
            elif op == "queue_depth":
                await self.reply(req_id, bus.work_queue(head["queue"]).depth)
            elif op == "object_put":
                bus.object_put(head["bucket"], head["name"], data, head.get("ttl"))
                await self.reply(req_id, True)
            elif op == "object_get":
                obj = bus.object_get(head["bucket"], head["name"])
                await self.reply(req_id, obj is not None, obj or b"")
            elif op == "object_list":
                await self.reply(req_id, bus.object_list(head["bucket"]))
            else:
                await self.reply_err(req_id, StoreError(f"unknown op {op!r}"))
        except Exception as e:  # noqa: BLE001
            await self.reply_err(req_id, e)

    async def _do_request(self, req_id: int, head: dict, data: bytes) -> None:
        try:
            result = await self.hub.bus.request(
                head["subject"], data, head.get("timeout", 30.0), head.get("headers") or {}
            )
            await self.reply(req_id, True, result)
        except Exception as e:  # noqa: BLE001
            await self.reply_err(req_id, e)

    async def _do_queue_pop(self, req_id: int, head: dict) -> None:
        try:
            q = self.hub.bus.work_queue(head["queue"], head.get("redeliver_after", 30.0))
            item = await q.pop(head.get("timeout"))
            if item is None:
                await self.reply(req_id, None)
            else:
                await self.reply(
                    req_id, {"item_id": item.id, "deliveries": item.deliveries}, item.payload
                )
        except Exception as e:  # noqa: BLE001
            await self.reply_err(req_id, e)

    async def _pump_watch(self, wid: int, w: Watcher) -> None:
        try:
            async for ev in w:
                await self.send(
                    {"op": "watch_event", "watch_id": wid, "kind": ev.kind.value,
                     "key": ev.key, "lease": ev.lease_id},
                    ev.value,
                )
        except (ConnectionResetError, asyncio.CancelledError):
            pass

    async def _pump_sub(self, sid: int, sub: Subscription) -> None:
        try:
            async for msg in sub:
                await self.send(
                    {"op": "bus_msg", "sub_id": sid, "subject": msg.subject,
                     "headers": msg.headers, "reply": msg.reply},
                    msg.payload,
                )
        except (ConnectionResetError, asyncio.CancelledError):
            pass


class _HubConnection:
    """One TCP connection to the hub, shared by RemoteStore + RemoteBus.

    SURVIVES hub restarts (a mid-life hub bounce would otherwise orphan
    every watcher/subscription with no re-establishment):
    when the read loop sees the connection drop, a background redial
    loop takes over — new ``call``s queue on the connected-event instead
    of failing — and once the new connection is up the session is
    re-established server-side: every live subscription re-subscribes
    under its old sub id and every watcher re-watches under its old
    watch id, with the fresh snapshot RECONCILED against what the
    watcher had already delivered (missed deletes surface as synthetic
    DELETE events, current keys re-PUT — consumers like ModelWatcher
    apply events idempotently). Requests that were in flight AT the
    drop fail with ConnectionError (their server-side effects are
    unknowable); the durable hub's store revives leases so resumed
    keepalives (LeaseKeeper retries through ConnectionError) keep
    registrations alive across the bounce."""

    def __init__(self, address: str, reconnect: bool = True):
        self.address = address
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._watch_queues: dict[int, asyncio.Queue] = {}
        self._sub_queues: dict[int, asyncio.Queue] = {}
        # live session state for re-establishment after a hub bounce
        self._watchers: dict[int, "RemoteWatcher"] = {}
        self._subs: dict[int, tuple[str, Optional[str]]] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._reconnect_task: Optional[asyncio.Task] = None
        self._wlock = asyncio.Lock()
        self._bg_tasks: set[asyncio.Task] = set()
        self._reconnect = reconnect
        self._closing = False
        self._connected = asyncio.Event()

    async def connect(self, timeout: float = 15.0) -> None:
        """Dial the hub, retrying connection refusals with backoff until
        ``timeout``: components of one deployment start concurrently, and
        a worker/frontend may reach its dial before the hub process has
        bound its listener (the reference's runtime retries its etcd/NATS
        connects the same way)."""
        await self._dial(timeout)
        self._reader_task = asyncio.get_running_loop().create_task(self._read_loop())
        self._connected.set()

    async def _dial(self, timeout: float) -> None:
        host, port = self.address.rsplit(":", 1)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        delay = 0.1
        while True:
            try:
                # per-attempt cap: a black-holed address otherwise blocks
                # in the OS connect far past the retry budget
                self._reader, self._writer = await asyncio.wait_for(
                    asyncio.open_connection(host, int(port)),
                    max(deadline - loop.time(), 0.05),
                )
                return
            except (ConnectionRefusedError, OSError, asyncio.TimeoutError):
                if loop.time() >= deadline:
                    raise
                await asyncio.sleep(delay)
                delay = min(delay * 2, 1.0)

    async def close(self) -> None:
        self._closing = True
        # release callers parked on the connected-event (call() re-checks
        # _closing after the wait and raises instead of hanging forever)
        self._connected.set()
        if self._reader_task:
            self._reader_task.cancel()
        if self._reconnect_task:
            self._reconnect_task.cancel()
        if self._writer:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass  # peer already gone — the fd is released either way

    async def _read_loop(self) -> None:
        try:
            while True:
                frame = await read_frame(self._reader)
                if frame is None:
                    break
                head = frame.header_json() or {}
                op = head.get("op")
                if op == "reply":
                    fut = self._pending.pop(head.get("id"), None)
                    if fut and not fut.done():
                        if "error" in head:
                            exc = _ERRORS.get(head.get("etype"), StoreError)(
                                head.get("error", "hub error")
                            )
                            fut.set_exception(exc)
                        else:
                            fut.set_result((head.get("result"), frame.data))
                elif op == "watch_event":
                    w = self._watchers.get(head.get("watch_id"))
                    if w is not None:
                        w._track(head.get("kind"), head.get("key"))
                    q = self._watch_queues.get(head.get("watch_id"))
                    if q:
                        q.put_nowait((head, frame.data))
                elif op == "bus_msg":
                    q = self._sub_queues.get(head.get("sub_id"))
                    if q:
                        q.put_nowait((head, frame.data))
        except (ConnectionResetError, asyncio.CancelledError, OSError):
            pass
        finally:
            self._connected.clear()
            # in-flight requests die with the old connection either way
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("hub connection lost"))
            self._pending.clear()
            if self._closing or not self._reconnect:
                for q in self._watch_queues.values():
                    q.put_nowait(None)
                for q in self._sub_queues.values():
                    q.put_nowait(None)
            elif self._reconnect_task is None or self._reconnect_task.done():
                self._reconnect_task = asyncio.get_running_loop().create_task(
                    self._re_establish()
                )

    async def _re_establish(self) -> None:
        """Redial forever (exponential backoff with jitter), then rebuild
        the session; a bounce DURING rebuild just starts the loop over.

        The jitter matters at fleet scale: a hub restart disconnects
        every worker at the same instant, and un-jittered backoff would
        have the whole fleet redial in synchronized waves (thundering
        herd against a half-started listener)."""
        delay = 0.2
        while not self._closing:
            try:
                await self._dial(timeout=5.0)
            except (OSError, asyncio.TimeoutError):
                await asyncio.sleep(delay * (0.5 + _random.random()))
                delay = min(delay * 2, 5.0)
                continue
            logger.info(
                "hub %s: reconnected; re-establishing session", self.address
            )
            # the read loop must NOT respawn this task while it is the
            # one driving the rebuild — it checks reconnect_task.done()
            self._reader_task = asyncio.get_running_loop().create_task(
                self._read_loop()
            )
            self._connected.set()
            try:
                for sid, (subject, group) in list(self._subs.items()):
                    await self.call(
                        {"op": "subscribe", "subject": subject,
                         "group": group, "sub_id": sid}
                    )
                for wid, w in list(self._watchers.items()):
                    _, snap = await self.call(
                        {"op": "watch", "prefix": w.prefix, "watch_id": wid}
                    )
                    w._reconcile(json.loads(snap))
                return
            except (ConnectionError, OSError) as e:
                logger.warning(
                    "hub session rebuild interrupted (%s); retrying", e
                )
                await asyncio.sleep(delay * (0.5 + _random.random()))

    async def call(self, head: dict, data: bytes = b"") -> tuple[Any, bytes]:
        if not self._connected.is_set() and not self._closing:
            # hub bouncing: queue behind the redial instead of failing
            await self._connected.wait()
        if self._closing:
            raise ConnectionError("hub connection closed")
        req_id = next(self._ids)
        head["id"] = req_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        async with self._wlock:
            # frame-serialization lock (see _Session.send): held across
            # the write by design so frames never interleave
            await write_frame(
                self._writer, TwoPartMessage(json.dumps(head).encode(), data)
            )
        return await fut

    def call_nowait(self, head: dict, data: bytes = b"") -> asyncio.Task:
        """Fire a call in the background with a strong reference held and
        failures logged (asyncio keeps only weak refs to bare tasks)."""
        task = asyncio.get_running_loop().create_task(self.call(head, data))
        self._bg_tasks.add(task)

        def _done(t: asyncio.Task) -> None:
            self._bg_tasks.discard(t)
            if not t.cancelled() and t.exception() is not None:
                logger.warning("hub %s failed: %s", head.get("op"), t.exception())

        task.add_done_callback(_done)
        return task


class RemoteWatcher:
    def __init__(self, conn: _HubConnection, wid: int, prefix: str, snapshot: list[KvEntry]):
        self._conn = conn
        self._wid = wid
        self.prefix = prefix
        self.snapshot = snapshot
        self._queue: asyncio.Queue = asyncio.Queue()
        # keys this watcher currently believes exist — the baseline the
        # post-reconnect snapshot reconciles against
        self._seen: set[str] = {e.key for e in snapshot}
        conn._watch_queues[wid] = self._queue
        conn._watchers[wid] = self

    def _track(self, kind: str, key: str) -> None:
        (self._seen.add if kind == "put" else self._seen.discard)(key)

    def _reconcile(self, snap: list[dict]) -> None:
        """Feed the post-reconnect snapshot as synthetic events: keys
        that vanished while disconnected become DELETEs, current keys
        re-PUT (consumers apply watch events idempotently — discovery
        overwrites by key)."""
        current = {d["key"] for d in snap}
        for key in sorted(self._seen - current):
            self._queue.put_nowait(
                ({"kind": "delete", "key": key, "lease": 0}, b"")
            )
        for d in snap:
            self._queue.put_nowait(
                ({"kind": "put", "key": d["key"], "lease": d.get("lease", 0)},
                 bytes.fromhex(d["value"]))
            )
        self._seen = current
        # reconcile done: surface a watch_resumed marker so dependents
        # with state DERIVED from the event stream (instance lists,
        # model registries) know a gap just closed and can re-list —
        # before this, a consumer that missed the window could sit on
        # silently-stale state until the next organic event
        self._queue.put_nowait(
            ({"kind": "resumed", "key": self.prefix, "lease": 0}, b"")
        )

    def cancel(self) -> None:
        self._conn._watch_queues.pop(self._wid, None)
        self._conn._watchers.pop(self._wid, None)
        self._queue.put_nowait(None)

    def __aiter__(self):
        return self

    async def __anext__(self):
        item = await self._queue.get()
        if item is None:
            raise StopAsyncIteration
        head, data = item
        return WatchEvent(EventKind(head["kind"]), head["key"], data, head.get("lease", 0))


class RemoteSubscription:
    def __init__(self, conn: _HubConnection, sid: int, subject: str, group):
        self._conn = conn
        self._sid = sid
        self.subject = subject
        self.group = group
        self._queue: asyncio.Queue = asyncio.Queue()
        conn._sub_queues[sid] = self._queue
        conn._subs[sid] = (subject, group)

    def unsubscribe(self) -> None:
        self._conn._sub_queues.pop(self._sid, None)
        self._conn._subs.pop(self._sid, None)
        self._queue.put_nowait(None)
        self._conn.call_nowait({"op": "unsubscribe", "sub_id": self._sid})

    async def next(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            item = await asyncio.wait_for(self._queue.get(), timeout)
        except asyncio.TimeoutError:
            return None
        if item is None:
            return None
        return self._to_msg(item)

    @staticmethod
    def _to_msg(item) -> Message:
        head, data = item
        return Message(head["subject"], data, head.get("headers") or {}, head.get("reply"))

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        item = await self._queue.get()
        if item is None:
            raise StopAsyncIteration
        return self._to_msg(item)


class RemoteStore:
    """Store interface over the hub connection (awaitable variants)."""

    def __init__(self, conn: _HubConnection):
        self._conn = conn
        self._ids = itertools.count(1)

    def start(self) -> None:  # parity with LocalStore
        pass

    async def close(self) -> None:
        pass

    async def grant_lease(self, ttl: float) -> int:
        result, _ = await self._conn.call({"op": "grant_lease", "ttl": ttl})
        return result

    async def keep_alive(self, lease_id: int) -> bool:
        result, _ = await self._conn.call({"op": "keep_alive", "lease": lease_id})
        return bool(result)

    async def revoke_lease(self, lease_id: int) -> None:
        await self._conn.call({"op": "revoke_lease", "lease": lease_id})

    async def kv_put(self, key: str, value: bytes, lease_id: int = 0) -> None:
        await self._conn.call({"op": "kv_put", "key": key, "lease": lease_id}, value)

    async def kv_create(self, key: str, value: bytes, lease_id: int = 0) -> None:
        await self._conn.call({"op": "kv_create", "key": key, "lease": lease_id}, value)

    async def kv_create_or_validate(self, key: str, value: bytes, lease_id: int = 0) -> None:
        await self._conn.call(
            {"op": "kv_create_or_validate", "key": key, "lease": lease_id}, value
        )

    async def kv_get(self, key: str) -> Optional[KvEntry]:
        result, data = await self._conn.call({"op": "kv_get", "key": key})
        if result is None:
            return None
        return KvEntry(result["key"], data, result.get("lease", 0))

    async def kv_get_prefix(self, prefix: str) -> list[KvEntry]:
        _, data = await self._conn.call({"op": "kv_get_prefix", "prefix": prefix})
        return [
            KvEntry(d["key"], bytes.fromhex(d["value"]), d.get("lease", 0))
            for d in json.loads(data)
        ]

    async def kv_delete(self, key: str) -> bool:
        result, _ = await self._conn.call({"op": "kv_delete", "key": key})
        return bool(result)

    async def kv_delete_prefix(self, prefix: str) -> int:
        result, _ = await self._conn.call({"op": "kv_delete_prefix", "prefix": prefix})
        return int(result)

    async def watch_prefix(self, prefix: str) -> RemoteWatcher:
        wid = next(self._ids)
        _, snap = await self._conn.call({"op": "watch", "prefix": prefix, "watch_id": wid})
        snapshot = [
            KvEntry(d["key"], bytes.fromhex(d["value"]), d.get("lease", 0))
            for d in json.loads(snap)
        ]
        return RemoteWatcher(self._conn, wid, prefix, snapshot)


class RemoteBus:
    """Bus interface over the hub connection."""

    def __init__(self, conn: _HubConnection):
        self._conn = conn
        self._ids = itertools.count(1)

    def subscribe(self, subject: str, group: Optional[str] = None) -> RemoteSubscription:
        sid = next(self._ids)
        sub = RemoteSubscription(self._conn, sid, subject, group)
        # `ready` lets callers (Endpoint.serve) await subscription
        # confirmation before advertising themselves in discovery
        sub.ready = self._conn.call_nowait(
            {"op": "subscribe", "subject": subject, "group": group, "sub_id": sid}
        )
        return sub

    def publish(
        self,
        subject: str,
        payload: bytes,
        headers: Optional[dict] = None,
        reply: Optional[str] = None,
    ) -> None:
        self._conn.call_nowait(
            {"op": "publish", "subject": subject, "headers": headers, "reply": reply},
            payload,
        )

    async def request(
        self,
        subject: str,
        payload: bytes,
        timeout: float = 30.0,
        headers: Optional[dict] = None,
    ) -> bytes:
        _, data = await self._conn.call(
            {"op": "request", "subject": subject, "timeout": timeout, "headers": headers},
            payload,
        )
        return data

    def respond(self, msg: Message, payload: bytes) -> None:
        if not msg.reply:
            return
        self._conn.call_nowait({"op": "respond", "reply": msg.reply}, payload)

    def work_queue(self, name: str, redeliver_after: float = 30.0) -> "RemoteWorkQueue":
        return RemoteWorkQueue(self._conn, name, redeliver_after)

    async def object_put(
        self, bucket: str, name: str, data: bytes, ttl: Optional[float] = None
    ) -> None:
        await self._conn.call(
            {"op": "object_put", "bucket": bucket, "name": name, "ttl": ttl}, data
        )

    async def object_get(self, bucket: str, name: str) -> Optional[bytes]:
        found, data = await self._conn.call(
            {"op": "object_get", "bucket": bucket, "name": name}
        )
        return data if found else None

    async def object_list(self, bucket: str) -> list[str]:
        result, _ = await self._conn.call({"op": "object_list", "bucket": bucket})
        return result


class RemoteWorkQueue:
    def __init__(self, conn: _HubConnection, name: str, redeliver_after: float):
        self._conn = conn
        self.name = name
        self.redeliver_after = redeliver_after

    async def push(self, payload: bytes) -> int:
        result, _ = await self._conn.call(
            {"op": "queue_push", "queue": self.name,
             "redeliver_after": self.redeliver_after},
            payload,
        )
        return result

    async def pop(self, timeout: Optional[float] = None):
        result, data = await self._conn.call(
            {"op": "queue_pop", "queue": self.name, "timeout": timeout,
             "redeliver_after": self.redeliver_after}
        )
        if result is None:
            return None
        return QueueItem(result["item_id"], data, result["deliveries"])

    async def ack(self, item_id: int) -> bool:
        result, _ = await self._conn.call(
            {"op": "queue_ack", "queue": self.name, "item_id": item_id}
        )
        return bool(result)

    async def nack(self, item_id: int) -> bool:
        result, _ = await self._conn.call(
            {"op": "queue_nack", "queue": self.name, "item_id": item_id}
        )
        return bool(result)

    async def depth(self) -> int:
        result, _ = await self._conn.call({"op": "queue_depth", "queue": self.name})
        return int(result)


async def connect_hub(address: str) -> tuple[RemoteStore, RemoteBus, _HubConnection]:
    """Connect to a hub; returns (store, bus, connection)."""
    conn = _HubConnection(address)
    await conn.connect()
    return RemoteStore(conn), RemoteBus(conn), conn
