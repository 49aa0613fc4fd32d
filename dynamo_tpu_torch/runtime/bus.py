"""Request-plane message bus: subjects, queue groups, work queues, objects.

A copy of ``dynamo_tpu/runtime/bus.py`` (the reference's NATS layer,
lib/runtime/src/transports/nats.rs + JetStream uses): the serving stack
needs four messaging shapes, all provided here behind one interface:

  * **publish/subscribe** on hierarchical subjects — KV events, hit-rate
    events (ref kv_router.rs:41 ``kv_events`` subject),
  * **request/reply to a queue group** — the addressed request plane: each
    worker endpoint subscribes its unique subject; the router publishes a
    request envelope and gets an ack (the real response rides the TCP
    response plane, see tcp.py),
  * **durable work queue** with pull + ack + redelivery — the prefill queue
    (ref examples/llm/utils/nats_queue.py:27-142),
  * **object store** buckets with TTL — model deployment cards
    (ref model_card/model.rs:42-49).

:class:`LocalBus` is the in-process implementation and the state machine
behind the TCP hub server (hub.py).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import itertools
import json
import os
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Awaitable, Callable, Optional


class BusError(Exception):
    pass


class NoResponders(BusError):
    """No subscriber on the requested subject (ref NATS no-responders)."""


@dataclass
class Message:
    subject: str
    payload: bytes
    headers: dict[str, str] = field(default_factory=dict)
    reply: Optional[str] = None


@dataclass
class QueueItem:
    id: int
    payload: bytes
    deliveries: int = 0


class Subscription:
    def __init__(self, bus: "LocalBus", subject: str, group: Optional[str]):
        self.subject = subject
        self.group = group
        self._queue: asyncio.Queue[Optional[Message]] = asyncio.Queue()
        self._bus = bus

    def _push(self, msg: Message) -> None:
        self._queue.put_nowait(msg)

    async def next(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            msg = await asyncio.wait_for(self._queue.get(), timeout)
        except asyncio.TimeoutError:
            return None
        return msg

    def unsubscribe(self) -> None:
        self._bus._unsubscribe(self)
        self._queue.put_nowait(None)

    def __aiter__(self) -> AsyncIterator[Message]:
        return self

    async def __anext__(self) -> Message:
        msg = await self._queue.get()
        if msg is None:
            raise StopAsyncIteration
        return msg


def _subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style matching: '*' one token, '>' tail wildcard."""
    if pattern == subject:
        return True
    pt, st = pattern.split("."), subject.split(".")
    for i, p in enumerate(pt):
        if p == ">":
            return True
        if i >= len(st):
            return False
        if p != "*" and p != st[i]:
            return False
    return len(pt) == len(st)


class _WorkQueue:
    """Durable FIFO with ack + visibility-timeout redelivery (JetStream
    work-queue semantics, ref nats_queue.py).

    With ``wal_path``, every push/ack appends one fsync'd JSONL record, so
    a hub restart replays unacked items instead of silently dropping
    queued prefills (the reference gets this from JetStream's file-backed
    streams). In-flight-at-crash items replay as ready — at-least-once,
    like an expired visibility timeout. The log self-compacts once dead
    records dominate."""

    def __init__(
        self,
        name: str,
        redeliver_after: float = 30.0,
        wal_path: Optional[str] = None,
    ):
        self.name = name
        self.redeliver_after = redeliver_after
        self._ready: asyncio.Queue[QueueItem] = asyncio.Queue()
        self._inflight: dict[int, tuple[QueueItem, float]] = {}
        self._wal_path = wal_path
        self._wal = None
        self._dead_records = 0
        self._fsync_pending = False
        next_id = 1
        if wal_path:
            next_id = self._replay_wal()
            self._wal = open(wal_path, "ab")
        self._ids = itertools.count(next_id)

    def _replay_wal(self) -> int:
        """Load surviving (pushed, never acked) items; returns next id."""
        max_id = 0
        items: dict[int, bytes] = {}
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail write from a crash
                    max_id = max(max_id, rec["id"])
                    if rec["op"] == "push":
                        items[rec["id"]] = base64.b64decode(rec["p"])
                    else:  # ack
                        items.pop(rec["id"], None)
        for item_id in sorted(items):
            self._ready.put_nowait(QueueItem(item_id, items[item_id]))
        # start from a clean, compacted log
        self._rewrite_wal(items)
        return max_id + 1

    def _rewrite_wal(self, items: dict[int, bytes]) -> None:
        tmp = self._wal_path + ".tmp"
        with open(tmp, "wb") as f:
            for item_id in sorted(items):
                rec = {"op": "push", "id": item_id,
                       "p": base64.b64encode(items[item_id]).decode()}
                f.write(json.dumps(rec).encode() + b"\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._wal_path)
        self._dead_records = 0

    def _wal_append(self, rec: dict, durable: bool = True) -> None:
        """Append + flush; fsync is batched off-loop (one per event-loop
        tick) so disk latency never stalls unrelated bus traffic. Acks
        skip fsync entirely — losing one means a redelivery, not data
        loss. Crash window: records flushed to the page cache but not yet
        fsynced (one tick)."""
        self._wal.write(json.dumps(rec).encode() + b"\n")
        self._wal.flush()
        if durable:
            self._schedule_fsync()

    def _schedule_fsync(self) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            os.fsync(self._wal.fileno())
            return
        if self._fsync_pending:
            return
        self._fsync_pending = True

        def _sync(fd=self._wal.fileno()):
            try:
                os.fsync(fd)
            except OSError:
                pass

        def _done(_fut):
            self._fsync_pending = False

        loop.run_in_executor(None, _sync).add_done_callback(_done)

    def _maybe_compact(self) -> None:
        live = self.depth
        if self._dead_records < 256 or self._dead_records < 4 * max(live, 1):
            return
        items = {i.id: i.payload for i in list(self._ready._queue)}  # type: ignore[attr-defined]
        items.update({i.id: i.payload for i, _ in self._inflight.values()})
        self._wal.close()
        self._rewrite_wal(items)
        self._wal = open(self._wal_path, "ab")

    def push(self, payload: bytes) -> int:
        item = QueueItem(next(self._ids), payload)
        if self._wal is not None:
            self._wal_append(
                {"op": "push", "id": item.id,
                 "p": base64.b64encode(payload).decode()}
            )
        self._ready.put_nowait(item)
        return item.id

    async def pop(self, timeout: Optional[float]) -> Optional[QueueItem]:
        self._redeliver_expired()
        try:
            item = await asyncio.wait_for(self._ready.get(), timeout)
        except asyncio.TimeoutError:
            return None
        item.deliveries += 1
        self._inflight[item.id] = (item, time.monotonic() + self.redeliver_after)
        # active redelivery: a consumer already blocked in pop() must still
        # see this item again if the holder crashes without ack
        asyncio.get_running_loop().call_later(
            max(self.redeliver_after, 0.001), self._redeliver_one, item.id
        )
        return item

    def _redeliver_one(self, item_id: int) -> None:
        entry = self._inflight.get(item_id)
        if entry is None:
            return
        item, deadline = entry
        if deadline <= time.monotonic():
            del self._inflight[item_id]
            self._ready.put_nowait(item)

    def ack(self, item_id: int) -> bool:
        if self._inflight.pop(item_id, None) is None:
            return False
        if self._wal is not None:
            self._wal_append({"op": "ack", "id": item_id}, durable=False)
            self._dead_records += 2  # the push + this ack are both dead
            self._maybe_compact()
        return True

    def nack(self, item_id: int) -> bool:
        entry = self._inflight.pop(item_id, None)
        if entry is None:
            return False
        self._ready.put_nowait(entry[0])
        return True

    def _redeliver_expired(self) -> None:
        now = time.monotonic()
        for item_id, (item, deadline) in list(self._inflight.items()):
            if deadline <= now:
                del self._inflight[item_id]
                self._ready.put_nowait(item)

    @property
    def depth(self) -> int:
        self._redeliver_expired()
        return self._ready.qsize() + len(self._inflight)


@dataclass
class _ObjectEntry:
    data: bytes
    expires_at: Optional[float]


class LocalBus:
    """In-process bus implementation. ``data_dir`` enables write-ahead
    logging of work queues (one JSONL per queue) so a hub restart doesn't
    drop queued work — the JetStream-durability equivalent."""

    def __init__(self, data_dir: Optional[str] = None):
        self._subs: list[Subscription] = []
        self._rr: dict[tuple[str, str], int] = {}  # queue-group round robin
        self._inboxes: dict[str, asyncio.Future] = {}
        self._inbox_ids = itertools.count(1)
        self._queues: dict[str, _WorkQueue] = {}
        self._objects: dict[str, dict[str, _ObjectEntry]] = {}
        # request handlers registered as service endpoints (fast path)
        self._handlers: dict[str, Callable[[Message], Awaitable[bytes]]] = {}
        self._data_dir = data_dir
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)

    # ---- pub/sub ----
    def subscribe(self, subject: str, group: Optional[str] = None) -> Subscription:
        sub = Subscription(self, subject, group)
        self._subs.append(sub)
        return sub

    def _unsubscribe(self, sub: Subscription) -> None:
        if sub in self._subs:
            self._subs.remove(sub)

    def publish(
        self,
        subject: str,
        payload: bytes,
        headers: Optional[dict[str, str]] = None,
        reply: Optional[str] = None,
    ) -> int:
        """Deliver to all plain subscribers and one member per queue group.
        Returns the number of deliveries."""
        msg = Message(subject, payload, headers or {}, reply)
        matched = [s for s in self._subs if _subject_matches(s.subject, subject)]
        delivered = 0
        groups: dict[str, list[Subscription]] = {}
        for s in matched:
            if s.group is None:
                s._push(msg)
                delivered += 1
            else:
                groups.setdefault(s.group, []).append(s)
        for group, members in groups.items():
            idx = self._rr.get((subject, group), 0) % len(members)
            self._rr[(subject, group)] = idx + 1
            members[idx]._push(msg)
            delivered += 1
        return delivered

    # ---- request/reply ----
    async def request(
        self,
        subject: str,
        payload: bytes,
        timeout: float = 30.0,
        headers: Optional[dict[str, str]] = None,
    ) -> bytes:
        handler = self._handlers.get(subject)
        if handler is not None:
            return await asyncio.wait_for(
                handler(Message(subject, payload, headers or {})), timeout
            )
        inbox = f"_inbox.{next(self._inbox_ids)}"
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._inboxes[inbox] = fut
        try:
            n = self.publish(subject, payload, headers, reply=inbox)
            if n == 0:
                raise NoResponders(subject)
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._inboxes.pop(inbox, None)

    def respond(self, msg: Message, payload: bytes) -> None:
        if not msg.reply:
            return
        fut = self._inboxes.get(msg.reply)
        if fut is not None and not fut.done():
            fut.set_result(payload)

    def register_handler(
        self, subject: str, handler: Callable[[Message], Awaitable[bytes]]
    ) -> None:
        """Direct-call service endpoint (in-process fast path)."""
        self._handlers[subject] = handler

    def unregister_handler(self, subject: str) -> None:
        self._handlers.pop(subject, None)

    def handler_subjects(self) -> list[str]:
        return list(self._handlers)

    # ---- work queues ----
    def work_queue(self, name: str, redeliver_after: float = 30.0) -> _WorkQueue:
        q = self._queues.get(name)
        if q is None:
            wal = None
            if self._data_dir:
                # short hash keeps distinct names distinct even when the
                # readable prefix sanitizes identically ('a.b' vs 'a_b')
                safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in name)
                digest = hashlib.sha1(name.encode()).hexdigest()[:8]
                wal = os.path.join(
                    self._data_dir, f"queue-{safe}-{digest}.jsonl"
                )
            q = self._queues[name] = _WorkQueue(name, redeliver_after, wal_path=wal)
        return q

    # ---- object store ----
    def object_put(
        self, bucket: str, name: str, data: bytes, ttl: Optional[float] = None
    ) -> None:
        expires = time.monotonic() + ttl if ttl else None
        self._objects.setdefault(bucket, {})[name] = _ObjectEntry(data, expires)

    def object_get(self, bucket: str, name: str) -> Optional[bytes]:
        entry = self._objects.get(bucket, {}).get(name)
        if entry is None:
            return None
        if entry.expires_at is not None and entry.expires_at <= time.monotonic():
            del self._objects[bucket][name]
            return None
        return entry.data

    def object_list(self, bucket: str) -> list[str]:
        now = time.monotonic()
        out = []
        for name, entry in list(self._objects.get(bucket, {}).items()):
            if entry.expires_at is not None and entry.expires_at <= now:
                del self._objects[bucket][name]
            else:
                out.append(name)
        return sorted(out)
