"""Host-DRAM and disk KV tiers behind the device pool.

A port of ``dynamo_tpu/engine/offload.py`` (the reference system's
multi-tier block manager: GPU HBM <-> pinned host <-> disk, with a CUDA
gather/scatter copy kernel). Evicted device pages are gathered on the card
into contiguous ``[L, Hkv, n, bs, D]`` stacks (``ops/block_copy.py``, one
``csrc/block_copy.cu`` launch), copied to host memory, and parked in an LRU
pool keyed by the block's chained sequence hash. A later prefill whose
prefix misses the device pool probes this pool and restores hits with one
h2d copy plus one scatter launch into freshly allocated pages.

Transfer shapes are bucketed as the reference buckets them: index vectors
pad with the trash page 0 (a scatter of zeros to it is harmless by design),
so transfers come in O(log n) shapes.

**Async tier.** Both directions are pipelined so the scheduler loop never
blocks on PCIe:

  * **d2h**: :meth:`OffloadManager.flush_evictions_async` launches the
    gather on the compute stream, in the device-executor thread, so it is
    stream-ordered BEFORE the compute that overwrites the evicted pages
    (a CUDA graph replay included: the engine flushes before it launches
    one). An event recorded after the gather orders the d2h copy, which
    runs on a side stream into a pinned slab (a small pool of slabs,
    reused; ``record_stream`` keeps the device stack alive until the copy
    is done). The blocking wait and the host-pool insertion run on a
    2-thread offload executor, double-buffered (at most
    ``_MAX_INFLIGHT_FLUSHES`` flushes in flight) with a per-dispatch block
    budget; evictions whose pages the caller is about to overwrite are
    flushed unconditionally (``must_idxs``).
  * **h2d**: a restore splits into :meth:`begin_upload` (stack the reserved
    host chain into a pinned slab and copy it to the card on a side stream,
    on the offload executor, from the moment admission reserves the chain)
    and :meth:`finish_upload` (the compute stream waits on the copy's
    event and one scatter launch lands it), which only waits on the host if
    the copy has not landed. The wait actually paid is *exposed* restore
    latency, the rest *hidden* (``restore_latency_hidden_frac``).

**Disk tier.** With ``disk_blocks > 0`` the host pool's LRU overflow
demotes to :class:`DiskKvStore` (one content-addressed file per block, the
reference's format byte for byte) instead of dropping, and restores promote
back through a host staging area (:meth:`OffloadManager.promote_chain`).
Device LRU -> host, host LRU -> disk, disk LRU/TTL -> dropped. All disk
I/O runs on the offload executor: the event loop stays free of file I/O.

Dropping a block from the *last* local tier is the only true removal: the
manager queues the hash (:meth:`flush_dropped` -> ``on_dropped``) so the KV
event publisher can tell the router.

The caches and the int8 cache's scale planes are updated IN PLACE (the
reference's scatters are functional and rebind them): the decode and verify
CUDA graphs hold their addresses. Host entries are CPU ``torch`` tensors
(bf16 and e4m3 pages have no numpy dtype without ``ml_dtypes``); the disk
format turns them into exactly the bytes the reference writes.

**Fleet tier.** A peer's pull is served from the host and disk tiers by
:meth:`OffloadManager.export_chain_q` (non-destructive: peek and disk read)
and landed on the puller by :meth:`OffloadManager.land_peer_chain` in the
host staging area, from where the router-hinted prefetch
(``TorchEngine.prefetch_hint``: :meth:`peek_chain`, :meth:`discard_chain`,
the ``note_prefetch_*`` accounting) promotes it to the device before the
request arrives. The ``peer_*`` and ``h2d_prefetch_*`` keys of
:meth:`OffloadManager.stats` count that work.

Left out (ROADMAP A.9): the multi-host mirror.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import struct
import tempfile
import threading
import time
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..ops import block_copy
from ..utils.dtypes import dtype_name, from_bytes, to_bytes, torch_dtype
from . import kvquant
from .kvquant import entry_nbytes

logger = logging.getLogger(__name__)

_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128]

#: double-buffer depth for async d2h flushes: one gather landing while
#: the next is being filled; more would just queue PCIe traffic
_MAX_INFLIGHT_FLUSHES = 2


class _Transfers:
    """The card's side of host <-> device copies: one side stream and a
    small pool of pinned slabs in power-of-two size classes, reused (pinning
    is slow; transfer shapes are bucketed, so a few classes repeat). None
    of it exists on the CPU."""

    #: free slabs kept per size class
    KEEP = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._lock = threading.Lock()
        self._free: dict[int, list[torch.Tensor]] = {}

    def take(self, nbytes: int) -> torch.Tensor:
        size = 1 << max(nbytes - 1, 1 << 20).bit_length()
        with self._lock:
            free = self._free.get(size)
            if free:
                return free.pop()
        return torch.empty(size, dtype=torch.uint8, pin_memory=True)

    def give(self, slab: torch.Tensor) -> None:
        with self._lock:
            free = self._free.setdefault(slab.numel(), [])
            if len(free) < self.KEEP:
                free.append(slab)

    def stack(self, data: list, times: Optional[dict] = None) -> tuple:
        """A reserved chain's [L, H, m, bs, D] payload stacks (+ [L, m]
        scale stacks for a quantized chain), stacked straight into a pinned
        slab on the card (returned with it; None on the CPU). ``times``
        gets the host ms of taking the slab (``pin_ms``: a new size class
        pins) and of stacking into it (``stack_ms``)."""
        pieces = [(0, 2), (1, 2)] + ([(2, 1), (3, 1)] if len(data[0]) > 2 else [])
        if self.stream is None:
            return [torch.stack([e[j] for e in data], dim=d) for j, d in pieces], None
        shapes = []
        for j, d in pieces:
            x = data[0][j]
            shape = list(x.shape)
            shape.insert(d, len(data))
            shapes.append(torch.empty(shape, dtype=x.dtype, device="meta"))
        t0 = time.perf_counter()
        slab = self.take(_slab_bytes(shapes))
        t1 = time.perf_counter()
        out = _views(slab, shapes)
        for (j, d), o in zip(pieces, out):
            torch.stack([e[j] for e in data], dim=d, out=o)
        if times is not None:
            times["pin_ms"] = (t1 - t0) * 1e3
            times["stack_ms"] = (time.perf_counter() - t1) * 1e3
        return out, slab


def _views(slab: torch.Tensor, like: list) -> list[torch.Tensor]:
    """Views of ``slab`` shaped as each tensor of ``like`` (each at a
    256-byte aligned offset)."""
    out, off = [], 0
    for t in like:
        out.append(slab[off : off + t.nbytes].view(t.dtype).view(t.shape))
        off += -(-t.nbytes // 256) * 256
    return out


def _slab_bytes(like: list) -> int:
    return sum(-(-t.nbytes // 256) * 256 for t in like)


def _device_fetch(tensors: list, ready, xfer: _Transfers) -> tuple:
    """The one d2h sync point (module-level so tests can inject latency):
    host copies of device tensors, and the pinned slab that holds them
    (None on the CPU, where the tensors are returned as they are). On the
    card the copy runs on the side stream after ``ready`` (recorded on the
    compute stream after the gather), and this returns once it landed."""
    if xfer.stream is None:
        return list(tensors), None
    slab = xfer.take(_slab_bytes(tensors))
    hosts = _views(slab, tensors)
    with torch.cuda.device(xfer.device), torch.cuda.stream(xfer.stream):
        xfer.stream.wait_event(ready)
        for h, t in zip(hosts, tensors):
            h.copy_(t, non_blocking=True)
            t.record_stream(xfer.stream)
        done = torch.cuda.Event()
        done.record(xfer.stream)
    done.synchronize()
    return hosts, slab


def _device_put(tensors: list, xfer: _Transfers) -> list:
    """The one h2d entry point (module-level so tests can inject latency):
    device copies of pinned host tensors, copied on the side stream;
    returns once they landed (the tensors as they are on the CPU)."""
    if xfer.stream is None:
        return list(tensors)
    with torch.cuda.device(xfer.device), torch.cuda.stream(xfer.stream):
        devs = [t.to(xfer.device, non_blocking=True) for t in tensors]
        done = torch.cuda.Event()
        done.record(xfer.stream)
    done.synchronize()
    return devs


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // 128) * 128


def _pad_idxs(idxs: list[int]) -> np.ndarray:
    out = np.zeros(_bucket(len(idxs)), np.int32)  # pad with trash block 0
    out[: len(idxs)] = idxs
    return out


class DiskKvStore:
    """Third KV tier: content-addressed on-disk block store (the
    reference's class and format).

    One file per block (``<seq_hash:016x>.kvb``): magic ``DKV1``, a
    little-endian u32 header length, a JSON header (format version, hash,
    shapes, dtype name, section sizes, CRC) and the raw ``k``, ``v`` and
    optional f32 scale sections, the CRC covering all four. Writes land in
    a temp file and ``os.replace`` into place (a crash mid-write leaves no
    entry); every read re-validates magic / version / hash / sizes / CRC,
    so a truncated, corrupt or version-mismatched entry is a clean miss
    (discarded, counted in ``corrupt_discards``), never an exception.

    Capacity is LRU over an in-memory index rebuilt from the directory at
    construction (a restarted worker keeps its disk tier); ``ttl_s > 0``
    also expires entries by residency age; with ``block_bytes`` set the
    capacity is a BYTE budget of ``capacity_blocks`` full-width blocks'
    payload. Every hash that leaves the store is queued in
    ``drain_dropped``. All methods do blocking file I/O: callers are on the
    offload executor, never the event loop.
    """

    MAGIC = b"DKV1"
    VERSION = 2

    def __init__(self, path: str, capacity_blocks: int, ttl_s: float = 0.0,
                 block_bytes: int = 0):
        self.path = path
        self.capacity = capacity_blocks
        self.ttl_s = ttl_s
        self.block_bytes = int(block_bytes)
        self._lock = threading.Lock()
        # seq_hash -> (stored_at monotonic, payload bytes); LRU order
        self._index: OrderedDict[int, tuple[float, int]] = OrderedDict()
        self._used_bytes = 0
        self._dropped: list[int] = []
        self.stored_total = 0
        self.hit_blocks_total = 0
        self.corrupt_discards = 0
        self.evictions_total = 0
        os.makedirs(path, exist_ok=True)
        now = time.monotonic()
        for name in sorted(os.listdir(path)):
            if not name.endswith(".kvb"):
                continue  # temp files from a crashed writer, etc.
            try:
                h = int(name[:-4], 16)
            except ValueError:
                continue
            # budgets count PAYLOAD bytes: file size minus magic + header
            f = os.path.join(path, name)
            try:
                sz = os.path.getsize(f)
                with open(f, "rb") as fh:
                    pre = fh.read(8)
                hlen = struct.unpack("<I", pre[4:8])[0] if len(pre) == 8 else 0
                sz = max(sz - 8 - hlen, 0)
            except OSError:
                continue
            self._index[h] = (now, sz)
            self._used_bytes += sz

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def contains(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self._index

    def _file(self, seq_hash: int) -> str:
        return os.path.join(self.path, f"{seq_hash:016x}.kvb")

    def _discard_locked(self, seq_hash: int, corrupt: bool = False) -> None:
        _t, sz = self._index.pop(seq_hash, (0.0, 0))
        self._used_bytes -= sz
        self._dropped.append(seq_hash)
        if corrupt:
            self.corrupt_discards += 1
        else:
            self.evictions_total += 1
        try:
            os.remove(self._file(seq_hash))
        except OSError:
            pass

    def _sweep_ttl_locked(self) -> None:
        if self.ttl_s <= 0:
            return
        cutoff = time.monotonic() - self.ttl_s
        for h in [h for h, (t, _sz) in self._index.items() if t < cutoff]:
            self._discard_locked(h)

    def _over_budget_locked(self, extra: int = 0) -> bool:
        if self.block_bytes > 0:
            return (
                self._used_bytes + extra > self.capacity * self.block_bytes
                and len(self._index) > 0
            )
        return len(self._index) > self.capacity

    def put(self, seq_hash: int, k: torch.Tensor, v: torch.Tensor,
            scales: Optional[tuple] = None) -> bool:
        """Demote one block to disk; returns whether it is resident
        afterwards (False = capacity 0 or the write failed). ``scales`` =
        (ks, vs) per-layer f32 vectors of a quantized payload, written as
        the v2 scale section."""
        if self.capacity <= 0:
            return False
        with self._lock:
            self._sweep_ttl_locked()
            if seq_hash in self._index:
                self._index.move_to_end(seq_hash)
                return True
        k_bytes, v_bytes = to_bytes(k), to_bytes(v)
        ks_bytes = vs_bytes = b""
        if scales is not None:
            ks_bytes = to_bytes(scales[0].float())
            vs_bytes = to_bytes(scales[1].float())
        crc = zlib.crc32(k_bytes)
        for part in (v_bytes, ks_bytes, vs_bytes):
            crc = zlib.crc32(part, crc)
        header = json.dumps({
            "v": self.VERSION,
            "hash": seq_hash,
            "k_shape": list(k.shape),
            "v_shape": list(v.shape),
            "dtype": dtype_name(k.dtype),
            "k_bytes": len(k_bytes),
            "v_bytes": len(v_bytes),
            "ks_bytes": len(ks_bytes),
            "vs_bytes": len(vs_bytes),
            "crc": crc,
        }).encode()
        final = self._file(seq_hash)
        try:
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(self.MAGIC)
                    f.write(struct.pack("<I", len(header)))
                    f.write(header)
                    f.write(k_bytes)
                    f.write(v_bytes)
                    f.write(ks_bytes)
                    f.write(vs_bytes)
                os.replace(tmp, final)  # atomic: no half-written entries
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            logger.warning("disk tier write failed for %x (block dropped)",
                           seq_hash, exc_info=True)
            return False
        nbytes = len(k_bytes) + len(v_bytes) + len(ks_bytes) + len(vs_bytes)
        with self._lock:
            self._index[seq_hash] = (time.monotonic(), nbytes)
            self._index.move_to_end(seq_hash)
            self._used_bytes += nbytes
            self.stored_total += 1
            while self._over_budget_locked() and len(self._index) > 1:
                self._discard_locked(next(iter(self._index)))
            if self._over_budget_locked():
                # one entry bigger than the whole byte budget
                self._discard_locked(seq_hash)
                return False
        return True

    def get(self, seq_hash: int) -> Optional[tuple]:
        """Read + validate one block; any validation failure discards the
        entry and reads as a miss (None). Returns ``(k, v)`` full-width or
        ``(k, v, ks, vs)`` with a scale section, as CPU tensors."""
        with self._lock:
            self._sweep_ttl_locked()
            if seq_hash not in self._index:
                return None
            self._index.move_to_end(seq_hash)
        try:
            with open(self._file(seq_hash), "rb") as f:
                raw = bytearray(os.fstat(f.fileno()).st_size)
                if f.readinto(raw) != len(raw):
                    raw = None  # the file shrank under us: a torn entry
        except OSError:
            with self._lock:
                self._discard_locked(seq_hash, corrupt=True)
            return None
        got = None if raw is None else self._decode(seq_hash, raw)
        with self._lock:
            if got is None:
                self._discard_locked(seq_hash, corrupt=True)
            else:
                self.hit_blocks_total += 1
        return got

    def _decode(self, seq_hash: int, raw: bytearray) -> Optional[tuple]:
        """The entry in ``raw``; its tensors are views of ``raw`` (no copy
        of the payload)."""
        try:
            if raw[:4] != self.MAGIC:
                return None
            (hlen,) = struct.unpack("<I", raw[4:8])
            head = json.loads(bytes(raw[8 : 8 + hlen]))
            if head.get("v") != self.VERSION or head.get("hash") != seq_hash:
                return None  # v1 (pre-scale-section) entries included
            nk, nv = int(head["k_bytes"]), int(head["v_bytes"])
            nks = int(head.get("ks_bytes") or 0)
            nvs = int(head.get("vs_bytes") or 0)
            payload = memoryview(raw)[8 + hlen :]
            if len(payload) != nk + nv + nks + nvs:
                return None  # truncated/padded payload or scale section
            if zlib.crc32(payload) != head.get("crc"):
                return None
            dt = torch_dtype(head["dtype"])
            size = torch.empty((), dtype=dt).element_size()
            k = from_bytes(payload, dt, nk // size, 0, head["k_shape"])
            v = from_bytes(payload, dt, nv // size, nk, head["v_shape"])
            if not nks:
                return k, v
            ks = from_bytes(payload, torch.float32, nks // 4, nk + nv, [-1])
            vs = from_bytes(payload, torch.float32, nvs // 4, nk + nv + nks,
                            [-1])
            if ks.shape[0] != k.shape[0] or vs.shape[0] != v.shape[0]:
                return None  # scale vectors must be per-layer
            return k, v, ks, vs
        except Exception:  # noqa: BLE001 — any malformed entry = miss
            logger.debug("disk tier entry %x malformed", seq_hash,
                         exc_info=True)
            return None

    def match_chain(self, seq_hashes: list[int]) -> int:
        """Longest consecutive run resident in the index (index-only)."""
        with self._lock:
            self._sweep_ttl_locked()
            n = 0
            for h in seq_hashes:
                if h not in self._index:
                    break
                n += 1
            return n

    def drain_dropped(self) -> list[int]:
        with self._lock:
            dropped, self._dropped = self._dropped, []
            return dropped


class HostKvPool:
    """LRU pool of offloaded blocks: seq_hash -> entry tuples, ``(k, v)``
    full-width ``[L, Hkv, bs, D]`` pairs or ``(k, v, ks, vs)`` quantized
    payloads with per-layer f32 scales (CPU tensors).

    With ``block_bytes`` set, capacity is a BYTE budget
    (``capacity_blocks`` full-width blocks' worth) charged at each entry's
    bytes, so the same budget holds ~2x the quantized blocks;
    ``block_bytes == 0`` keeps the entry-count LRU. ``on_overflow(hash,
    entry) -> bool`` is offered every LRU victim (True: a lower tier kept
    it); ``on_drop(hash)`` fires for entries that left this worker's tiers.
    :meth:`plan_puts` / :meth:`apply_plan` simulate and apply a batch of
    puts without running either hook."""

    def __init__(self, capacity_blocks: int, block_bytes: int = 0):
        self.capacity = capacity_blocks
        self.block_bytes = int(block_bytes)
        self._data: OrderedDict[int, tuple] = OrderedDict()
        self._used_bytes = 0
        self.stored_total = 0
        self.hit_blocks_total = 0
        self.on_overflow: Optional[Callable] = None
        self.on_drop: Optional[Callable] = None

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, seq_hash: int) -> bool:
        return seq_hash in self._data

    def _over_budget(self, extra: int = 0) -> bool:
        if self.block_bytes > 0:
            return (
                self._used_bytes + extra > self.capacity * self.block_bytes
                and len(self._data) > 0
            )
        return len(self._data) >= self.capacity

    def put(self, seq_hash: int, k: torch.Tensor, v: torch.Tensor,
            scales: Optional[tuple] = None) -> None:
        """Insert one entry; ``scales`` = (ks, vs) for a quantized payload."""
        if self.capacity <= 0:
            return
        if seq_hash in self._data:
            self._data.move_to_end(seq_hash)
            return
        entry = (k, v) if scales is None else (k, v, scales[0], scales[1])
        incoming = entry_nbytes(entry) if self.block_bytes > 0 else 0
        while self._over_budget(incoming):
            old_h, old_e = self._data.popitem(last=False)
            self._used_bytes -= (
                entry_nbytes(old_e) if self.block_bytes > 0 else 0
            )
            kept = bool(self.on_overflow and self.on_overflow(old_h, old_e))
            if not kept and self.on_drop:
                self.on_drop(old_h)
        self._data[seq_hash] = entry
        self._used_bytes += incoming

    def take(self, seq_hash: int) -> Optional[tuple]:
        """Remove and return (the block is moving back to the device)."""
        got = self._data.pop(seq_hash, None)
        if got is not None and self.block_bytes > 0:
            self._used_bytes -= entry_nbytes(got)
        return got

    def peek(self, seq_hash: int) -> Optional[tuple]:
        """Return WITHOUT removing (the hinted prefetch and a peer serve
        read non-destructively; entries are immutable)."""
        got = self._data.get(seq_hash)
        if got is not None:
            self._data.move_to_end(seq_hash)
        return got

    def match_chain(self, seq_hashes: list[int]) -> int:
        """Longest consecutive run of hashes resident in the pool."""
        n = 0
        for h in seq_hashes:
            if h not in self._data:
                break
            n += 1
        return n

    def plan_puts(
        self, hashes: list[int]
    ) -> tuple[list[int], list[bool], list[int]]:
        """Simulate :meth:`put` over ``hashes`` without data: returns
        (drops, keep, final_order): the resident hashes the LRU will evict,
        whether each ``hashes[i]`` is resident after all puts, and the
        final recency order (entry-count based)."""
        sim = OrderedDict((k, None) for k in self._data)
        for h in hashes:
            if self.capacity <= 0:
                break
            if h in sim:
                sim.move_to_end(h)
                continue
            while len(sim) >= self.capacity:
                sim.popitem(last=False)
            sim[h] = None
        drops = [k for k in self._data if k not in sim]
        seen: set = set()
        keep = []
        for h in hashes:
            keep.append(h in sim and h not in seen)
            seen.add(h)
        return drops, keep, list(sim.keys())

    def apply_plan(self, drops, keep, final_order, hashes, data_for) -> None:
        """Apply a :meth:`plan_puts` result: drop evictions, insert kept
        entries (``data_for(i)`` supplies ``hashes[i]``'s value), and
        restore the simulated recency order."""
        for h in drops:
            old = self._data.pop(h, None)
            if old is not None and self.block_bytes > 0:
                self._used_bytes -= entry_nbytes(old)
        for i, h in enumerate(hashes):
            if keep[i] and h not in self._data:
                e = data_for(i)
                self._data[h] = e
                if self.block_bytes > 0:
                    self._used_bytes += entry_nbytes(e)
        for h in final_order:
            if h in self._data:
                self._data.move_to_end(h)


class _FlushTask:
    """One in-flight async d2h flush: the gather was launched on the device
    thread; ``future`` lands the host copies into the pool."""

    __slots__ = ("hashes", "future")

    def __init__(self, hashes: list[int], future):
        self.hashes = hashes
        self.future = future


class RestoreUpload:
    """One reserved host chain's h2d stage: stacking + device copy run on
    the offload executor from the moment admission reserves the chain;
    :meth:`OffloadManager.finish_upload` scatters (and only then waits, if
    the copy has not landed). ``future`` is None on the synchronous paths
    (async tier disabled, empty chain)."""

    __slots__ = ("hashes", "data", "idxs", "future", "t_start", "t_landed",
                 "cancelled")

    def __init__(self, hashes: list, data: list, idxs: list[int]):
        self.hashes = hashes
        self.data = data
        self.idxs = idxs
        self.future = None
        self.t_start = time.monotonic()
        self.t_landed: Optional[float] = None
        self.cancelled = False


class OffloadManager:
    """Orchestrates device <-> host <-> disk block movement for one engine.

    Device launches (gathers, scatters) happen on the engine's
    device-executor thread, on the compute stream, so transfers are always
    stream-ordered before the compute that overwrites those pages. The
    blocking host side of each transfer (d2h wait, host stacking, h2d copy,
    disk I/O) runs on ``_exec``, a 2-thread offload executor. ``_lock``
    guards the pool + pending/in-flight structures across the event-loop,
    device-executor and offload-executor threads.
    """

    def __init__(self, host_blocks: int, flush_budget: int = 64,
                 async_tier: bool = True, disk_blocks: int = 0,
                 disk_path: Optional[str] = None, tier_ttl_s: float = 0.0,
                 kv_quant: str = "none", block_bytes: int = 0,
                 full_dtype: Union[str, torch.dtype] = torch.float32,
                 device=None):
        if kv_quant not in kvquant.KV_QUANT_MODES:
            raise ValueError(
                f"kv_quant must be one of {kvquant.KV_QUANT_MODES}"
            )
        # per-block tier codec (engine/kvquant.py): every block entering
        # the host pool (and everything demoted past it) is stored int8/fp8
        # + per-layer scales; restores dequantize in the device scatter
        self.kv_quant = kv_quant
        #: full-width per-block bytes: > 0 turns the host/disk capacities
        #: into byte budgets
        self.block_bytes = int(block_bytes)
        #: dtype quantized entries dequantize back to for full width
        self.full_dtype = (torch_dtype(full_dtype) if isinstance(full_dtype, str)
                           else full_dtype)
        self.device = torch.device("cpu" if device is None else device)
        self._xfer = _Transfers(self.device)
        self.kv_quant_blocks_total = 0
        self.kv_quant_bytes_saved_total = 0
        self.pool = HostKvPool(host_blocks, block_bytes=self.block_bytes)
        # (seq_hash, device_block_idx) evictions awaiting d2h
        self._pending: list[tuple[int, int]] = []
        self.async_tier = async_tier
        self.flush_budget = max(1, flush_budget)
        self._lock = threading.RLock()
        self._exec: Optional[ThreadPoolExecutor] = None
        self._closed = False
        self._inflight_flushes: list[_FlushTask] = []
        self.d2h_flush_async_total = 0
        self.d2h_flush_failures = 0
        self.h2d_prefetch_blocks_total = 0
        self.h2d_prefetch_hits = 0
        self.h2d_uploads_started = 0
        self.h2d_uploads_cancelled = 0
        self.restore_hidden_s = 0.0
        self.restore_exposed_s = 0.0
        #: sums over landed uploads of their parts, ms: pin_ms, stack_ms
        #: (host clock) and, on the card, h2d_ms (CUDA events around the
        #: copy); not in stats(), whose keys are the reference's
        self.upload_times = {"uploads": 0, "pin_ms": 0.0, "stack_ms": 0.0,
                             "h2d_ms": 0.0}
        # third tier: host-pool LRU overflow demotes here via the offload
        # executor; restores promote back through host DRAM
        self.disk: Optional[DiskKvStore] = None
        self.disk_demotions_total = 0
        # an auto-created tempdir is OURS to remove at close(); an explicit
        # disk_path persists across restarts by design
        self._own_disk_path: Optional[str] = None
        if disk_blocks > 0:
            if disk_path is None:
                disk_path = tempfile.mkdtemp(prefix="dynkv-")
                self._own_disk_path = disk_path
            self.disk = DiskKvStore(disk_path, disk_blocks, ttl_s=tier_ttl_s,
                                    block_bytes=self.block_bytes)
            self.pool.on_overflow = self._demote_to_disk
        self.pool.on_drop = self._note_dropped_one
        # hashes that left the LAST local tier, queued for the KV event
        # publisher (flush_dropped runs on the event loop)
        self.on_dropped: Optional[Callable[[list[int]], None]] = None
        self._dropped_pending: list[int] = []
        # transfer-cost calibration (kv_router/costmodel.py, wired by the
        # engine): restore landings observe "host", disk promotions "disk"
        self.cost_model = None
        # device-tier residency probe (engine wires allocator.has_hash): a
        # queued drop publishes as a removal only if no tier holds the hash
        self.device_has: Optional[Callable[[int], bool]] = None
        # int8-with-scales DEVICE cache: () -> (k_scales, v_scales) [L, N]
        # f32 planes (None for full-width / fp8 caches). Flushes then
        # gather codes + scales and an int8 tier ADOPTS them (zero
        # re-encode); restores land payload + scales back in place.
        # device_requants_total counts blocks forced OFF the device codec
        # on the way out (a full-width or fp8 tier)
        self.device_planes: Optional[Callable[[], Optional[tuple]]] = None
        self.device_requants_total = 0
        # staging area for INCOMING chains (disk promotions, peer pulls):
        # exempt from the host pool's LRU capacity (a chain longer than the
        # host budget would otherwise demote its own head before it
        # restores); popped by reserve / discard, LRU-capped at a small
        # multiple of the host budget
        self._staged: OrderedDict[int, tuple] = OrderedDict()
        # peer-pulled hashes staged but not yet claimed by a request:
        # claiming one means its transfer was fully hidden
        # (peer_pull_hidden_frac); insertion-ordered and capped
        self._peer_hashes: OrderedDict[int, None] = OrderedDict()
        self._peer_track_cap = 8192
        self.peer_pull_blocks_total = 0
        self.peer_pull_blocks_claimed = 0
        self.peer_serve_blocks_total = 0

    # -- allocator callback (event-loop thread) --
    def on_evict(self, seq_hash: int, block_idx: int) -> None:
        with self._lock:
            self._pending.append((seq_hash, block_idx))

    def _executor(self) -> ThreadPoolExecutor:
        if self._closed:
            raise RuntimeError("offload manager is closed")
        if self._exec is None:
            self._exec = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="kv-offload"
            )
        return self._exec

    #: admission-side cap on waiting for a relevant in-flight flush: a
    #: wedged executor degrades to a cache miss, not a stalled loop
    _JOIN_TIMEOUT_S = 1.0

    def _join_flushes_for(self, seq_hashes: list[int]) -> None:
        """Wait (bounded) for in-flight flushes holding any of
        ``seq_hashes`` to land; on timeout the unlanded entries simply do
        not match."""
        need = set(seq_hashes)
        with self._lock:
            tasks = [
                t for t in self._inflight_flushes
                if not need.isdisjoint(t.hashes)
            ]
        deadline = time.monotonic() + self._JOIN_TIMEOUT_S
        for t in tasks:
            try:
                t.future.result(max(0.0, deadline - time.monotonic()))
            except Exception:  # noqa: BLE001 — timeout/failure = cache miss
                logger.debug("flush join missed (treated as cache miss)",
                             exc_info=True)
        with self._lock:
            self._reap_flushes_locked()

    def _reap_flushes_locked(self) -> None:
        alive = []
        for t in self._inflight_flushes:
            if not t.future.done():
                alive.append(t)
                continue
            exc = t.future.exception()
            if exc is not None:
                # a failed landing drops those blocks from the host tier:
                # visible to operators, and no longer residency
                self.d2h_flush_failures += 1
                self._dropped_pending.extend(t.hashes)
                logger.warning(
                    "async d2h flush of %d blocks failed (KV dropped "
                    "from the host tier): %s", len(t.hashes), exc,
                )
        self._inflight_flushes = alive

    def has_pending(self) -> bool:
        return bool(self._pending)

    def has_inflight_flushes(self) -> bool:
        return bool(self._inflight_flushes)

    def _note_dropped_one(self, seq_hash: int) -> None:
        with self._lock:
            self._dropped_pending.append(seq_hash)

    # -- tier codec (engine/kvquant.py) --

    def _encode_entry(self, k: torch.Tensor, v: torch.Tensor) -> tuple:
        """Full-width block -> this manager's tier entry form. Executor
        threads only (the quantize is real CPU work per block)."""
        if self.kv_quant == "none":
            return (k, v)
        full = k.nbytes + v.nbytes
        qk, qv, ks, vs = kvquant.quantize_entry(k, v, self.kv_quant)
        with self._lock:
            self.kv_quant_blocks_total += 1
            self.kv_quant_bytes_saved_total += max(
                full - entry_nbytes((qk, qv, ks, vs)), 0
            )
        return (qk, qv, ks, vs)

    def _encode_device_entry(self, qk, qv, ks, vs) -> tuple:
        """Device-codec block (int8 codes + per-layer scales gathered off
        the int8 device cache) -> this manager's tier entry: an int8 tier
        adopts it verbatim; any other codec bounces through full width
        (counted: device_requants_total). Executor threads only."""
        full = (qk.numel() + qv.numel()) * self.full_dtype.itemsize
        if self.kv_quant == "int8":
            entry = (qk, qv, ks, vs)
            with self._lock:
                self.kv_quant_blocks_total += 1
                self.kv_quant_bytes_saved_total += max(
                    full - entry_nbytes(entry), 0
                )
            return entry
        with self._lock:
            self.device_requants_total += 1
        k, v = kvquant.dequantize_entry(qk, qv, ks, vs, self.full_dtype)
        return self._encode_entry(k, v)

    def _normalize_entry(self, entry: tuple) -> tuple:
        """Coerce an incoming entry (a disk read after a --kv-quant flip)
        to THIS manager's mode, so restore stacks never mix dtypes.
        Executor threads only."""
        quantized = len(entry) > 2 and entry[2] is not None
        if self.kv_quant == "none":
            if not quantized:
                return entry
            return kvquant.dequantize_entry(
                entry[0], entry[1], entry[2], entry[3], self.full_dtype
            )
        want = kvquant.quant_dtype(self.kv_quant)
        if quantized and entry[0].dtype == want:
            return entry
        if quantized:  # a different quant mode (pre-restart flag flip)
            entry = kvquant.dequantize_entry(
                entry[0], entry[1], entry[2], entry[3], self.full_dtype
            )
        return self._encode_entry(entry[0], entry[1])

    @staticmethod
    def _entry_scales(entry: tuple) -> Optional[tuple]:
        return (entry[2], entry[3]) if len(entry) > 2 else None

    # -- disk tier --

    def _demote_to_disk(self, seq_hash: int, entry: tuple) -> bool:
        """Host-pool overflow victim -> disk, via the offload executor.
        True = the block stays resident (a failed write later re-queues
        the hash as a drop)."""
        if self.disk is None or self._closed:
            return False
        if self.disk.contains(seq_hash):
            return True  # already demoted once; content is immutable
        try:
            self._executor().submit(self._disk_demote_worker, seq_hash, entry)
        except RuntimeError:
            return False
        return True

    def _disk_demote_worker(self, seq_hash: int, entry: tuple) -> None:
        kept = False
        try:
            kept = self.disk.put(
                seq_hash, entry[0], entry[1], scales=self._entry_scales(entry)
            )
        except Exception:  # noqa: BLE001 — a failed demotion is a drop
            logger.warning("disk demotion of %x failed", seq_hash,
                           exc_info=True)
        with self._lock:
            if kept:
                self.disk_demotions_total += 1
            else:
                self._dropped_pending.append(seq_hash)
            self._dropped_pending.extend(self.disk.drain_dropped())

    def _staged_cap(self) -> int:
        return max(4 * self.pool.capacity, 64)

    def _stage_locked(self, seq_hash: int, entry: tuple, peer: bool = False,
                      fresh: Optional[set] = None) -> None:
        self._staged[seq_hash] = entry
        self._staged.move_to_end(seq_hash)
        if fresh is not None:
            fresh.add(seq_hash)
        while len(self._staged) > self._staged_cap():
            old = next(iter(self._staged))
            if fresh is not None and old in fresh:
                # never evict the chain being staged right now (its head
                # is what the consecutive match starts from)
                break
            self._staged.popitem(last=False)
            self._peer_hashes.pop(old, None)
            if self.disk is None or not self.disk.contains(old):
                self._dropped_pending.append(old)
        if peer:
            self._peer_hashes[seq_hash] = None
            while len(self._peer_hashes) > self._peer_track_cap:
                self._peer_hashes.popitem(last=False)

    def _match_chain_locked(self, seq_hashes: list[int]) -> int:
        """Longest consecutive run claimable by a reserve: host pool ∪
        staging area."""
        n = 0
        for h in seq_hashes:
            if h in self.pool or h in self._staged:
                n += 1
            else:
                break
        return n

    def promote_chain(self, seq_hashes: list[int]) -> int:
        """Disk -> host-DRAM promotion of the chain's continuation past the
        already-claimable prefix, into the staging area. Blocking disk
        reads: executor thread (the engine's prejoin) or an explicitly
        off-loop backstop only. Returns blocks promoted."""
        if self.disk is None or not seq_hashes:
            return 0
        with self._lock:
            n = self._match_chain_locked(seq_hashes)
        tail = seq_hashes[n:]
        run = min(
            self.disk.match_chain(tail) if tail else 0, self._staged_cap()
        )
        promoted = 0
        fresh: set = set()
        read_bytes, read_s = 0, 0.0
        for h in tail[:run]:
            t_r = time.monotonic()
            got = self.disk.get(h)  # validates; corrupt -> clean miss
            if got is None:
                break
            read_s += time.monotonic() - t_r
            read_bytes += entry_nbytes(got)
            got = self._normalize_entry(got)
            with self._lock:
                self._stage_locked(h, got, fresh=fresh)
            promoted += 1
        if self.cost_model is not None and read_bytes and read_s > 0:
            # measured disk-read wall -> the "disk" link class
            self.cost_model.observe("disk", read_bytes, read_s)
        with self._lock:
            self._dropped_pending.extend(self.disk.drain_dropped())
        return promoted

    def tier_contains(self, seq_hash: int) -> bool:
        """Index-only host ∪ staged ∪ disk residency probe."""
        with self._lock:
            if seq_hash in self.pool or seq_hash in self._staged:
                return True
        return self.disk is not None and self.disk.contains(seq_hash)

    def flush_dropped(self) -> None:
        """Deliver queued tier-drop notifications to ``on_dropped`` (event
        loop callers only: the callback publishes on the bus). A drop is
        published only if no tier (device included) still holds the hash."""
        cb = self.on_dropped
        with self._lock:
            if self.disk is not None:
                self._dropped_pending.extend(self.disk.drain_dropped())
            dropped, self._dropped_pending = self._dropped_pending, []
        if cb is None or not dropped:
            return
        gone = []
        seen: set = set()
        for h in dropped:
            if h in seen:
                continue
            seen.add(h)
            if self.tier_contains(h):
                continue
            if self.device_has is not None and self.device_has(h):
                continue
            gone.append(h)
        if gone:
            try:
                cb(gone)
            except Exception:  # noqa: BLE001 — residency events are advisory
                logger.debug("tier-drop notification failed", exc_info=True)

    # -- fleet tier (peer prefix pulls) --

    def _collect_export(self, seq_hashes: list[int], max_blocks: int):
        """Longest consecutive resident run of ``seq_hashes`` as entry
        tuples in this manager's codec mode (disk reads normalized).
        Non-destructive. Executor thread."""
        served: list[int] = []
        entries: list[tuple] = []
        for h in seq_hashes[:max_blocks]:
            with self._lock:
                got = self.pool.peek(h)
                if got is None:
                    got = self._staged.get(h)
            if got is None and self.disk is not None:
                got = self.disk.get(h)
                if got is not None:
                    got = self._normalize_entry(got)
            if got is None:
                break
            served.append(h)
            entries.append(got)
        return served, entries

    def export_chain(self, seq_hashes: list[int], max_blocks: int = 512) -> tuple:
        """Serve side of a peer prefix pull, FULL-WIDTH form: the longest
        consecutive run of ``seq_hashes`` resident in the host and disk
        tiers, stacked ``[L, Hkv, n, bs, D]`` (quantized entries
        dequantized). Returns (hashes, k, v)."""
        served, k, v, _ks, _vs = self.export_chain_q(
            seq_hashes, max_blocks=max_blocks, quant_ok=False)
        return served, k, v

    def export_chain_q(self, seq_hashes: list[int], max_blocks: int = 512,
                       quant_ok: bool = True) -> tuple:
        """Quant-aware export: (hashes, k, v, ks, vs). With the codec on
        and ``quant_ok`` (the puller advertised the capability) the stacks
        are the stored int8 / fp8 payloads plus [L, n] scales; otherwise
        the scales are None and the stacks full width. Non-destructive, so
        a puller dying mid-pull leaves this worker's tiers untouched.
        Executor thread (disk reads + multi-MB stacking)."""
        served, entries = self._collect_export(seq_hashes, max_blocks)
        if not served:
            return [], None, None, None, None
        quantized = self.kv_quant != "none"
        if quantized and not quant_ok:
            entries = [kvquant.dequantize_entry(e[0], e[1], e[2], e[3],
                                                self.full_dtype)
                       for e in entries]
            quantized = False
        k = torch.stack([e[0] for e in entries], dim=2)
        v = torch.stack([e[1] for e in entries], dim=2)
        ks = vs = None
        if quantized:
            ks = torch.stack([e[2] for e in entries], dim=1)  # [L, n]
            vs = torch.stack([e[3] for e in entries], dim=1)
        with self._lock:
            self.peer_serve_blocks_total += len(served)
        return served, k, v, ks, vs

    def land_peer_chain(self, seq_hashes: list[int], k_data: torch.Tensor,
                        v_data: torch.Tensor,
                        k_scales: Optional[torch.Tensor] = None,
                        v_scales: Optional[torch.Tensor] = None) -> int:
        """Puller side: park a peer-served chain (CPU stacks) in the host
        STAGING area, not the LRU pool (whose capacity would thrash a chain
        longer than the host budget before the restore runs); the hinted
        prefetch promotes it to the device like a locally offloaded chain.
        ``k_scales``/``v_scales`` ([L, n] f32) mark a quantized delivery;
        each block is normalized to THIS manager's codec mode. Executor
        thread (per-block copies: a view would pin the whole stack)."""
        landed = 0
        fresh: set = set()
        # truncate at the staging cap, keeping the chain's PREFIX
        for i, h in enumerate(seq_hashes[: self._staged_cap()]):
            entry = (k_data[:, :, i].clone(), v_data[:, :, i].clone())
            if k_scales is not None:
                entry += (k_scales[:, i].float().clone(),
                          v_scales[:, i].float().clone())
            entry = self._normalize_entry(entry)
            with self._lock:
                if (h in self.pool or h in self._staged
                        or (self.disk is not None and self.disk.contains(h))):
                    continue  # raced a local landing; content-identical
                self._stage_locked(h, entry, peer=True, fresh=fresh)
                self.peer_pull_blocks_total += 1
            landed += 1
        return landed

    # -- admission-time reservation (event-loop thread) --

    def reserve_chain(self, seq_hashes: list[int]) -> tuple[list[int], list]:
        """Take the longest resident prefix OUT of the pool (so a later
        flush cannot LRU it away before the restore runs). Event-loop
        callers pre-join in-flight flushes and pre-promote disk hits
        off-loop (the engine's prejoin); the inline join / promotion here
        is the backstop for direct callers."""
        if seq_hashes and self._inflight_flushes:
            self._join_flushes_for(seq_hashes)
        if self.disk is not None and seq_hashes:
            self.promote_chain(seq_hashes)
        with self._lock:
            n = self._match_chain_locked(seq_hashes)
            hashes = seq_hashes[:n]
            out = []
            for h in hashes:
                if h in self.pool:
                    out.append(self.pool.take(h))
                else:
                    out.append(self._staged.pop(h))
                # a request racing its own hint can reserve a peer-pulled
                # block before the prefetch marks it: reserving IS the claim
                if h in self._peer_hashes:
                    self._peer_hashes.pop(h)
                    self.peer_pull_blocks_claimed += 1
            return hashes, out

    def peek_chain(self, seq_hashes: list[int]) -> tuple[list[int], list]:
        """Non-destructive :meth:`reserve_chain` for the prefetch path: the
        entries STAY claimable by a racing admission until
        :meth:`discard_chain` drops them after the device commit (a hint
        must never make the hinted request slower)."""
        if seq_hashes and self._inflight_flushes:
            self._join_flushes_for(seq_hashes)
        if self.disk is not None and seq_hashes:
            self.promote_chain(seq_hashes)
        with self._lock:
            n = self._match_chain_locked(seq_hashes)
            hashes = seq_hashes[:n]
            out = []
            for h in hashes:
                got = self.pool.peek(h)
                if got is None:
                    got = self._staged[h]
                    self._staged.move_to_end(h)
                out.append(got)
            return hashes, out

    def discard_chain(self, hashes: list[int]) -> None:
        """Drop host copies whose content is now device-resident (the
        prefetch landed and committed)."""
        with self._lock:
            for h in hashes:
                self.pool.take(h)
                self._staged.pop(h, None)

    def unreserve(self, hashes: list[int], data) -> None:
        """Admission failed (or the prefill was cancelled/errored) after
        reservation: return the blocks to the pool, in the form they were
        reserved in."""
        with self._lock:
            for h, e in zip(hashes, data):
                self.pool.put(h, e[0], e[1], scales=self._entry_scales(e))

    # -- device-thread operations --

    def _gather(self, k_cache, v_cache, pending):
        """Launch the bucketed gather of ``pending`` pages (with the scale
        planes of an int8 device cache) on the compute stream; returns the
        device stacks and an event after them (None on the CPU)."""
        idxs = torch.as_tensor(_pad_idxs([idx for _h, idx in pending]),
                               device=k_cache.device)
        planes = self.device_planes() if self.device_planes else None
        if planes is not None:
            out = block_copy.gather_blocks(k_cache, v_cache, idxs, *planes)
        else:
            out = block_copy.gather_blocks(k_cache, v_cache, idxs) + (None, None)
        ready = None
        if k_cache.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(k_cache.device))
        return out, ready

    def flush_evictions(self, k_cache, v_cache) -> None:
        """Gather + d2h all pending evicted blocks into the host pool,
        synchronously (the ``async_tier=False`` escape hatch)."""
        with self._lock:
            if not self._pending:
                return
            pending, self._pending = self._pending, []
        stacks, ready = self._gather(k_cache, v_cache, pending)
        self._land_flush(pending, stacks, ready)

    def _land_flush(self, pending, stacks, ready) -> None:
        """Blocking half of a flush: the d2h copy + host-pool insertion
        (quantized to the tier codec when --kv-quant is on). Runs inline
        on the sync path, on the offload executor otherwise."""
        kg, vg, ksg, vsg = stacks
        tensors = [kg, vg] + ([ksg, vsg] if ksg is not None else [])
        hosts, slab = _device_fetch(tensors, ready, self._xfer)
        entries = []
        try:
            for i, (seq_hash, _idx) in enumerate(pending):
                # copies: a view would pin the whole gather (and the slab)
                k = hosts[0][:, :, i].clone()
                v = hosts[1][:, :, i].clone()
                if ksg is not None:
                    e = self._encode_device_entry(
                        k, v, hosts[2][:, i].clone(), hosts[3][:, i].clone())
                else:
                    e = self._encode_entry(k, v)
                entries.append((seq_hash, e))
        finally:
            if slab is not None:
                self._xfer.give(slab)
        with self._lock:
            for seq_hash, e in entries:
                self.pool.put(seq_hash, e[0], e[1],
                              scales=self._entry_scales(e))
            self.pool.stored_total += len(pending)

    def flush_evictions_async(
        self, k_cache, v_cache,
        budget: Optional[int] = None,
        must_idxs: Optional[set] = None,
    ) -> None:
        """Launch the gather for pending evictions WITHOUT waiting on the
        copy (device thread): the gather is on the compute stream before
        the caller's page-overwriting compute; the d2h wait and the pool
        insertion land on the offload executor.

        ``budget`` caps how many optional blocks one call gathers and the
        double buffer caps concurrent flushes, but evictions whose page is
        in ``must_idxs`` (pages the caller's next dispatch writes) are
        ALWAYS taken. ``budget=None`` flushes everything now (a prefill may
        write any freshly allocated page)."""
        if not self.async_tier:
            return self.flush_evictions(k_cache, v_cache)
        with self._lock:
            self._reap_flushes_locked()
            if not self._pending:
                return
            if budget is None:
                pending, self._pending = self._pending, []
            else:
                room = max(0, budget)
                if len(self._inflight_flushes) >= _MAX_INFLIGHT_FLUSHES:
                    room = 0  # double buffer full: must-flush only
                pending, deferred = [], []
                for h, idx in self._pending:
                    if must_idxs is not None and idx in must_idxs:
                        pending.append((h, idx))
                    elif room > 0:
                        pending.append((h, idx))
                        room -= 1
                    else:
                        deferred.append((h, idx))
                self._pending = deferred
            if not pending:
                return
        stacks, ready = self._gather(k_cache, v_cache, pending)
        fut = self._executor().submit(self._land_flush, pending, stacks, ready)
        with self._lock:
            self._inflight_flushes.append(
                _FlushTask([h for h, _idx in pending], fut)
            )
            self.d2h_flush_async_total += 1

    # -- async h2d restore stage --

    def begin_upload(
        self, hashes: list[int], data: list, block_idxs: list[int]
    ) -> RestoreUpload:
        """Start the h2d half of a restore the moment the chain is
        reserved, on the offload executor. The handle goes to
        :meth:`finish_upload` (or :meth:`cancel_upload` on rollback); with
        the async tier off or an empty chain it carries no future and
        finish_upload runs the one-shot :meth:`restore`."""
        up = RestoreUpload(hashes, data, block_idxs)
        if not hashes or not self.async_tier:
            return up
        up.future = self._executor().submit(self._upload_worker, up)
        with self._lock:
            self.h2d_uploads_started += 1
        return up

    def _upload_worker(self, up: RestoreUpload) -> list:
        times: dict = {}
        stacks, slab = self._xfer.stack(up.data, times)
        stream = self._xfer.stream
        try:
            if stream is not None:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record(stream)
            landed = _device_put(stacks, self._xfer)
            if stream is not None:
                # the side stream also carries the flushes' d2h copies: a
                # copy queued behind one counts its wait
                ev[1].record(stream)
                ev[1].synchronize()
                times["h2d_ms"] = ev[0].elapsed_time(ev[1])
        finally:
            if slab is not None:
                self._xfer.give(slab)
        up.t_landed = time.monotonic()
        with self._lock:
            self.upload_times["uploads"] += 1
            for k, ms in times.items():
                self.upload_times[k] += ms
        return landed

    def cancel_upload(self, up: Optional[RestoreUpload]) -> None:
        """Admission failed / request cancelled with the upload in flight.
        The upload only READS the host entries, so the caller's
        :meth:`unreserve` is safe concurrently; this records the
        abandonment."""
        if up is None or up.future is None or up.cancelled:
            return
        up.cancelled = True
        with self._lock:
            self.h2d_uploads_cancelled += 1

    def finish_upload(self, k_cache, v_cache, up: RestoreUpload,
                      account: bool = True) -> None:
        """Land a begun upload into its reserved pages, in place: wait for
        the device copies only if they have not arrived (the wait actually
        paid is the EXPOSED restore latency, the rest was hidden), then one
        scatter launch. ``account=False`` skips the hidden/exposed
        bookkeeping."""
        if not up.hashes:
            return
        if up.future is None:
            self.restore(k_cache, v_cache, up.data, up.idxs)
            return
        t0 = time.monotonic()
        landed = up.future.result()
        if account and self.cost_model is not None and up.t_landed is not None:
            # the upload worker's stack + h2d wall is the "host" link
            # observation (the bytes that moved)
            self.cost_model.observe(
                "host", landed[0].nbytes + landed[1].nbytes,
                max(up.t_landed - up.t_start, 1e-9),
            )
        if account:
            waited = time.monotonic() - t0
            total = max(up.t_landed - up.t_start, 1e-9)
            exposed = min(waited, total)
            with self._lock:
                self.restore_exposed_s += exposed
                self.restore_hidden_s += max(total - exposed, 0.0)
                self.pool.hit_blocks_total += len(up.data)
        self._scatter(k_cache, v_cache, up.idxs, landed)

    # -- prefetch accounting (router-hinted restores, engine side) --

    def note_prefetch_landed(self, up: RestoreUpload) -> None:
        """A hinted restore landed off the admission path: its whole
        transfer latency was hidden from every later request."""
        with self._lock:
            self.h2d_prefetch_blocks_total += len(up.hashes)
            if up.t_landed is not None:
                self.restore_hidden_s += max(up.t_landed - up.t_start, 0.0)
        if self.cost_model is not None and up.t_landed is not None and up.data:
            self.cost_model.observe(
                "host", sum(entry_nbytes(e) for e in up.data),
                max(up.t_landed - up.t_start, 1e-9))

    def note_prefetch_hits(self, n: int, hashes: Optional[list] = None) -> None:
        """``n`` prefetched device blocks claimed by a request; those that
        arrived through a peer pull count as hidden pull transfers."""
        with self._lock:
            self.h2d_prefetch_hits += n
            for h in hashes or ():
                if h in self._peer_hashes:
                    self._peer_hashes.pop(h)
                    self.peer_pull_blocks_claimed += 1

    def _scatter(self, k_cache, v_cache, block_idxs: list[int],
                 parts: list) -> None:
        """Land restored stacks at ``block_idxs`` (in place, one launch on
        the compute stream): an int8 device cache adopts a matching int8
        entry verbatim and requantizes anything else; a full-width or fp8
        cache takes full-width stacks as they are and quantized ones
        dequantized."""
        idxs = torch.as_tensor(_pad_idxs(block_idxs), device=k_cache.device)
        planes = self.device_planes() if self.device_planes else None
        quantized = len(parts) > 2
        if planes is not None:
            if quantized and parts[0].dtype == k_cache.dtype:
                block_copy.scatter_blocks(k_cache, v_cache, idxs, parts[0],
                                          parts[1], *planes, parts[2], parts[3])
            else:
                ks, vs = parts[2:] if quantized else (
                    torch.ones((k_cache.shape[0], parts[0].shape[2]),
                               dtype=torch.float32, device=k_cache.device),) * 2
                block_copy.scatter_blocks_requant(
                    k_cache, v_cache, *planes, idxs, parts[0], parts[1], ks, vs)
        elif quantized:
            block_copy.scatter_blocks_dequant(k_cache, v_cache, idxs, *parts)
        else:
            block_copy.scatter_blocks(k_cache, v_cache, idxs, *parts)
        if k_cache.device.type == "cuda":
            # the stacks were made on the side stream; the scatter reads
            # them on the compute stream
            stream = torch.cuda.current_stream(k_cache.device)
            for t in parts:
                t.record_stream(stream)

    def restore(self, k_cache, v_cache, data, block_idxs: list[int]) -> None:
        """Copy reserved host blocks (from :meth:`reserve_chain`) into the
        device pages ``block_idxs``, synchronously, in place."""
        assert len(data) == len(block_idxs)
        if not data:
            return
        with self._lock:
            self.pool.hit_blocks_total += len(data)
        stacks, slab = self._xfer.stack(data)
        try:
            parts = [t.to(k_cache.device) for t in stacks]
        finally:
            if slab is not None:
                self._xfer.give(slab)
        self._scatter(k_cache, v_cache, block_idxs, parts)

    def close(self) -> None:
        """Release the offload executor (in-flight landings still run to
        completion; nothing new is accepted). A disk tier on an
        auto-created tempdir is deleted; an explicit ``disk_path``
        persists."""
        self._closed = True
        if self._exec is not None:
            self._exec.shutdown(wait=False)
            self._exec = None
        if self._own_disk_path is not None:
            shutil.rmtree(self._own_disk_path, ignore_errors=True)

    def stats(self) -> dict:
        """The reference's tier keys, the fleet pull's and the hinted
        prefetch's among them."""
        with self._lock:
            hid, exp = self.restore_hidden_s, self.restore_exposed_s
            denom = hid + exp
            disk = self.disk
            pulled = self.peer_pull_blocks_total
            return {
                "offload_blocks_resident": len(self.pool),
                "offload_blocks_stored_total": self.pool.stored_total,
                "offload_hit_blocks_total": self.pool.hit_blocks_total,
                "disk_blocks_resident": len(disk) if disk is not None else 0,
                "disk_blocks_stored_total": (
                    disk.stored_total if disk is not None else 0),
                "disk_hit_blocks_total": (
                    disk.hit_blocks_total if disk is not None else 0),
                "disk_corrupt_discards": (
                    disk.corrupt_discards if disk is not None else 0),
                "disk_evictions_total": (
                    disk.evictions_total if disk is not None else 0),
                "disk_demotions_total": self.disk_demotions_total,
                "peer_pull_blocks_total": pulled,
                "peer_pull_blocks_claimed": self.peer_pull_blocks_claimed,
                "peer_pull_hidden_frac": (
                    round(self.peer_pull_blocks_claimed / pulled, 6)
                    if pulled else 0.0),
                "peer_serve_blocks_total": self.peer_serve_blocks_total,
                "kv_quant_blocks_total": self.kv_quant_blocks_total,
                "kv_quant_bytes_saved_total": self.kv_quant_bytes_saved_total,
                "d2h_flush_async": self.d2h_flush_async_total,
                "d2h_flush_failures": self.d2h_flush_failures,
                "d2h_flush_pending": len(self._pending),
                "h2d_prefetch_blocks_total": self.h2d_prefetch_blocks_total,
                "h2d_prefetch_hits": self.h2d_prefetch_hits,
                "h2d_uploads_started": self.h2d_uploads_started,
                "h2d_uploads_cancelled": self.h2d_uploads_cancelled,
                "restore_latency_hidden_frac": (
                    round(hid / denom, 6) if denom > 0 else 0.0
                ),
            }
