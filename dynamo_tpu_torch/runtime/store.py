"""Control-plane KV store: discovery, leases/liveness, dynamic config.

A copy of ``dynamo_tpu/runtime/store.py`` (the reference's etcd
transport, lib/runtime/src/transports/etcd.rs:38-346 + etcd/lease.rs): a
strongly-ordered key-value store with

  * **leases** with TTL + keepalive — the liveness primitive: every endpoint
    registration is bound to its worker's primary lease; lease loss deletes
    the keys, which every watcher observes (elastic membership),
  * **atomic create-if-absent** (``kv_create``) and create-or-validate,
  * **prefix get + watch** streams of Put/Delete events.

Deployments that fit on one host use :class:`LocalStore` in-process; the
multi-process path serves the same interface over TCP via
:mod:`dynamo_tpu_torch.runtime.hub` (no external etcd dependency — one
coordinator process; a replicated consensus store is deliberately out of
scope; the interface would admit one).
"""

from __future__ import annotations

import asyncio
import itertools
import json
import os
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import AsyncIterator, Optional


class StoreError(Exception):
    pass


class KeyExists(StoreError):
    pass


class ValidationFailed(StoreError):
    pass


class EventKind(str, Enum):
    PUT = "put"
    DELETE = "delete"
    # synthetic marker a RECONNECTED remote watcher emits after its
    # reconcile pass (hub.py RemoteWatcher._reconcile): the missed
    # deletes/puts have all been replayed, dependents holding derived
    # state can re-list/refresh. In-process watchers never emit it.
    RESUMED = "resumed"


@dataclass
class WatchEvent:
    kind: EventKind
    key: str
    value: bytes = b""
    lease_id: int = 0


@dataclass
class KvEntry:
    key: str
    value: bytes
    lease_id: int = 0
    revision: int = 0


@dataclass
class _Lease:
    id: int
    ttl: float
    deadline: float
    keys: set[str] = field(default_factory=set)


class Watcher:
    """A live prefix watch: async-iterate to receive WatchEvents.

    Mirrors the reference's PrefixWatcher (etcd.rs:283-332): creating one
    returns the current snapshot plus the event stream from that revision.
    """

    def __init__(self, prefix: str, snapshot: list[KvEntry], store: "LocalStore"):
        self.prefix = prefix
        self.snapshot = snapshot
        self._queue: asyncio.Queue[Optional[WatchEvent]] = asyncio.Queue()
        self._store = store

    def _push(self, ev: WatchEvent) -> None:
        self._queue.put_nowait(ev)

    def cancel(self) -> None:
        self._store._watchers.discard(self)
        self._queue.put_nowait(None)

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self

    async def __anext__(self) -> WatchEvent:
        ev = await self._queue.get()
        if ev is None:
            raise StopAsyncIteration
        return ev


class LocalStore:
    """In-process store implementation; also the state machine behind the
    TCP hub server.

    ``data_dir`` makes the store DURABLE (an in-memory hub restart would
    orphan every registration): mutations
    append to a JSONL write-ahead log, restore replays snapshot + WAL,
    and restored leases restart their TTL clock from restore time — hub
    downtime must not tick lease deadlines (the reference's etcd
    persists leases with their TTL the same way, etcd.rs:38 lease
    semantics). Clients that never reconnect still expire a TTL after
    the restart; clients that do reconnect just resume keepalives on
    their old lease ids (the id counters are persisted past the
    high-water mark so new grants can't collide)."""

    def __init__(self, *, clock=time.monotonic, data_dir: Optional[str] = None):
        self._data: dict[str, KvEntry] = {}
        self._leases: dict[int, _Lease] = {}
        self._watchers: set[Watcher] = set()
        self._revision = itertools.count(1)
        self._lease_ids = itertools.count(1)
        # high-water marks of EVER-ISSUED ids — persisted so a restart
        # can't reissue a revoked lease's id to a new client (a stale
        # holder of the old id would then control the new lease)
        self._rev_hw = 0
        self._lease_hw = 0
        self._clock = clock
        self._reaper_task: Optional[asyncio.Task] = None
        self._wal = None
        self._data_dir = data_dir
        if data_dir:
            self._restore(data_dir)

    # ---- persistence ----
    def _snap_path(self):
        return os.path.join(self._data_dir, "store.snap.json")

    def _wal_path(self):
        return os.path.join(self._data_dir, "store.wal.jsonl")

    def _log(self, **op) -> None:
        if self._wal is not None:
            self._wal.write(json.dumps(op) + "\n")
            self._wal.flush()

    def _apply(self, op: dict) -> None:
        """Replay one WAL record (no logging, no watcher notify — there
        are no watchers before start)."""
        kind = op["op"]
        if kind == "put":
            value = bytes.fromhex(op["v"])
            lease_id = op.get("l", 0)
            # detach from the PREVIOUS owner first (mirrors live kv_put):
            # otherwise the old lease's later expiry would delete a key
            # that a different live lease now owns
            old = self._data.get(op["k"])
            if old is not None and old.lease_id and old.lease_id != lease_id:
                prev = self._leases.get(old.lease_id)
                if prev:
                    prev.keys.discard(op["k"])
            if lease_id and lease_id in self._leases:
                self._leases[lease_id].keys.add(op["k"])
            elif lease_id:
                self._data.pop(op["k"], None)
                return  # lease already gone: the key died with it
            self._data[op["k"]] = KvEntry(op["k"], value, lease_id, op.get("r", 0))
        elif kind == "del":
            entry = self._data.pop(op["k"], None)
            if entry is not None and entry.lease_id in self._leases:
                self._leases[entry.lease_id].keys.discard(op["k"])
        elif kind == "grant":
            self._leases[op["id"]] = _Lease(op["id"], op["ttl"], 0.0)
        elif kind == "revoke":
            lease = self._leases.pop(op["id"], None)
            if lease:
                for key in list(lease.keys):
                    self._data.pop(key, None)

    def _restore(self, data_dir: str) -> None:
        os.makedirs(data_dir, exist_ok=True)
        try:
            with open(self._snap_path()) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            snap = {"data": [], "leases": [], "revision": 0, "lease_id": 0}
        for l in snap["leases"]:
            self._leases[l["id"]] = _Lease(l["id"], l["ttl"], 0.0)
        for e in snap["data"]:
            lease_id = e.get("l", 0)
            if lease_id and lease_id not in self._leases:
                continue
            self._data[e["k"]] = KvEntry(
                e["k"], bytes.fromhex(e["v"]), lease_id, e.get("r", 0)
            )
            if lease_id:
                self._leases[lease_id].keys.add(e["k"])
        max_rev, max_lease = snap.get("revision", 0), snap.get("lease_id", 0)
        try:
            with open(self._wal_path()) as f:
                for ln in f:
                    if not ln.strip():
                        continue
                    try:
                        op = json.loads(ln)
                    except ValueError:
                        continue  # torn tail write on crash
                    self._apply(op)
                    max_rev = max(max_rev, op.get("r", 0))
                    max_lease = max(max_lease, op.get("id", 0))
        except OSError:
            pass
        max_rev = max(max_rev, *(e.revision for e in self._data.values()), 0)
        self._rev_hw, self._lease_hw = max_rev, max_lease
        self._revision = itertools.count(max_rev + 1)
        self._lease_ids = itertools.count(max_lease + 1)
        # downtime doesn't count against liveness: every restored lease
        # gets a full TTL of grace from RESTORE time to resume keepalives
        now = self._clock()
        for lease in self._leases.values():
            lease.deadline = now + lease.ttl
        # compact: fresh snapshot, truncated WAL
        self._write_snapshot()
        self._wal = open(self._wal_path(), "w")

    def _write_snapshot(self) -> None:
        tmp = self._snap_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "data": [
                        {"k": e.key, "v": e.value.hex(), "l": e.lease_id,
                         "r": e.revision}
                        for e in self._data.values()
                    ],
                    "leases": [
                        {"id": l.id, "ttl": l.ttl}
                        for l in self._leases.values()
                    ],
                    # EVER-ISSUED high-water marks, not max-over-survivors:
                    # revoked ids must stay burned across restarts
                    "revision": self._rev_hw,
                    "lease_id": self._lease_hw,
                },
                f,
            )
        os.replace(tmp, self._snap_path())

    # ---- lifecycle ----
    def start(self) -> None:
        if self._reaper_task is None:
            self._reaper_task = asyncio.get_running_loop().create_task(self._reaper())

    async def close(self) -> None:
        if self._reaper_task:
            self._reaper_task.cancel()
            self._reaper_task = None
        for w in list(self._watchers):
            w.cancel()
        if self._wal is not None:
            self._write_snapshot()
            self._wal.close()
            self._wal = None
            try:  # compacted into the snapshot
                os.remove(self._wal_path())
            except OSError:
                pass

    async def _reaper(self) -> None:
        while True:
            await asyncio.sleep(0.25)
            self.expire_leases()

    def expire_leases(self) -> None:
        now = self._clock()
        for lease in [l for l in self._leases.values() if l.deadline <= now]:
            self._revoke(lease.id)

    # ---- leases ----
    def grant_lease(self, ttl: float) -> int:
        lease_id = next(self._lease_ids)
        self._lease_hw = max(self._lease_hw, lease_id)
        self._leases[lease_id] = _Lease(lease_id, ttl, self._clock() + ttl)
        self._log(op="grant", id=lease_id, ttl=ttl)
        return lease_id

    def keep_alive(self, lease_id: int) -> bool:
        lease = self._leases.get(lease_id)
        if lease is None:
            return False
        lease.deadline = self._clock() + lease.ttl
        return True

    def revoke_lease(self, lease_id: int) -> None:
        self._revoke(lease_id)

    def _revoke(self, lease_id: int) -> None:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        self._log(op="revoke", id=lease_id)
        for key in list(lease.keys):
            self._delete(key)

    # ---- kv ----
    def _notify(self, ev: WatchEvent) -> None:
        for w in list(self._watchers):
            if ev.key.startswith(w.prefix):
                w._push(ev)

    def _attach(self, key: str, lease_id: int) -> None:
        if lease_id:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise StoreError(f"unknown lease {lease_id}")
            lease.keys.add(key)

    def kv_put(self, key: str, value: bytes, lease_id: int = 0) -> None:
        old = self._data.get(key)
        if old is not None and old.lease_id and old.lease_id != lease_id:
            lease = self._leases.get(old.lease_id)
            if lease:
                lease.keys.discard(key)
        self._attach(key, lease_id)
        entry = KvEntry(key, value, lease_id, next(self._revision))
        self._rev_hw = max(self._rev_hw, entry.revision)
        self._data[key] = entry
        self._log(op="put", k=key, v=value.hex(), l=lease_id, r=entry.revision)
        self._notify(WatchEvent(EventKind.PUT, key, value, lease_id))

    def kv_create(self, key: str, value: bytes, lease_id: int = 0) -> None:
        """Atomic create-if-absent (ref: etcd.rs kv_create txn)."""
        if key in self._data:
            raise KeyExists(key)
        self.kv_put(key, value, lease_id)

    def kv_create_or_validate(self, key: str, value: bytes, lease_id: int = 0) -> None:
        existing = self._data.get(key)
        if existing is None:
            self.kv_put(key, value, lease_id)
        elif existing.value != value:
            raise ValidationFailed(key)

    def kv_get(self, key: str) -> Optional[KvEntry]:
        return self._data.get(key)

    def kv_get_prefix(self, prefix: str) -> list[KvEntry]:
        return [e for k, e in sorted(self._data.items()) if k.startswith(prefix)]

    def kv_delete(self, key: str) -> bool:
        return self._delete(key)

    def _delete(self, key: str) -> bool:
        entry = self._data.pop(key, None)
        if entry is None:
            return False
        if entry.lease_id:
            lease = self._leases.get(entry.lease_id)
            if lease:
                lease.keys.discard(key)
        self._log(op="del", k=key)
        self._notify(WatchEvent(EventKind.DELETE, key))
        return True

    def kv_delete_prefix(self, prefix: str) -> int:
        keys = [k for k in self._data if k.startswith(prefix)]
        for k in keys:
            self._delete(k)
        return len(keys)

    # ---- watch ----
    def watch_prefix(self, prefix: str) -> Watcher:
        w = Watcher(prefix, self.kv_get_prefix(prefix), self)
        self._watchers.add(w)
        return w


class LeaseKeeper:
    """Background keepalive for a lease (ref: etcd/lease.rs:51). Cancels the
    given CancellationToken if the lease is lost."""

    def __init__(self, store, lease_id: int, ttl: float, on_lost=None):
        self._store = store
        self.lease_id = lease_id
        self._ttl = ttl
        self._on_lost = on_lost
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        interval = max(self._ttl / 3.0, 0.05)
        while True:
            await asyncio.sleep(interval)
            try:
                ok = self._store.keep_alive(self.lease_id)
                if asyncio.iscoroutine(ok):
                    ok = await ok
            except ConnectionError:
                # hub unreachable (restarting): NOT lease loss — a
                # durable hub revives the lease with a fresh TTL at
                # restore and the connection layer is redialing; only an
                # explicit keep_alive=False (lease truly gone) is fatal
                continue
            if not ok:
                if self._on_lost:
                    self._on_lost()
                return

    async def stop(self, revoke: bool = True) -> None:
        if self._task:
            self._task.cancel()
            self._task = None
        if revoke:
            r = self._store.revoke_lease(self.lease_id)
            if asyncio.iscoroutine(r):
                await r
