"""The KV tiers' codec, stores and block copies against the reference.

``dynamo_tpu_torch/engine/kvquant.py``, ``engine/offload.py``'s
``DiskKvStore`` / ``HostKvPool`` / ``OffloadManager`` and the plain twins
of ``ops/block_copy.py`` against ``dynamo_tpu/engine/kvquant.py`` and
``dynamo_tpu/engine/offload.py`` on the CPU, on the same numpy inputs:

  * the tier codec's codes and f32 scales byte for byte (int8 and scaled
    fp8, at f32 and bf16 inputs, with the edges pinned: ±inf and NaN in a
    block), the reference's codec cases;
  * the stores: the reference's host-pool and disk-store cases, and disk
    entries that each package reads from the other, file for file (bf16,
    f32, e4m3 pages; int8 and fp8 entries with scale sections);
  * each plain block copy against its reference core (the jitted ones the
    reference runs), byte-equal: gathers with and without the int8 planes,
    the scatter and its cast into an e4m3 cache over all 65 536 bf16
    patterns, the dequantizing scatter with scales that carry e4m3
    landings past 464 (NaN bytes), the adopt and the requant landings.
"""

import os
import struct
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kvquant as rkq
from dynamo_tpu.engine import offload as roff
from dynamo_tpu_torch.engine import kvquant
from dynamo_tpu_torch.engine.offload import (
    DiskKvStore,
    HostKvPool,
    OffloadManager,
    _bucket,
    _pad_idxs,
)
from dynamo_tpu_torch.ops import block_copy as bc

BF16, E4M3 = np.dtype(ml_dtypes.bfloat16), np.dtype(ml_dtypes.float8_e4m3fn)
_RAW = {BF16: (np.uint16, torch.bfloat16), E4M3: (np.uint8, torch.float8_e4m3fn)}


def tt(a) -> torch.Tensor:
    """A numpy array (ml_dtypes included) as a CPU tensor, bit for bit."""
    a = np.asarray(a)
    if a.dtype in _RAW:
        raw, dt = _RAW[a.dtype]
        return torch.from_numpy(np.ascontiguousarray(a).view(raw).copy()).view(dt)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def raw(x) -> np.ndarray:
    """The bytes of a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def same(a, b) -> bool:
    return raw(a).shape == raw(b).shape and np.array_equal(raw(a), raw(b))


# ---------------- the codec ----------------


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
def test_codec_bytes_equal_the_reference(mode, dtype):
    """quantize_stack / quantize_entry codes and scales, and the
    dequantized blocks in f32, bf16 and e4m3, byte for byte."""
    rng = np.random.default_rng(0)
    k = (rng.standard_normal((3, 2, 5, 4, 8)) * 3.0).astype(dtype)
    v = (rng.standard_normal((3, 1, 5, 4, 16)) * 0.01).astype(dtype)
    ref = rkq.quantize_stack(k, v, mode)
    got = kvquant.quantize_stack(tt(k), tt(v), mode)
    assert got[0].dtype == kvquant.quant_dtype(mode)
    assert all(same(g, r) for g, r in zip(got, ref))
    for out in (np.float32, BF16, E4M3):
        rd = rkq.dequantize_stack(*ref, out)
        gd = kvquant.dequantize_stack(*got, tt(np.zeros(1, out)).dtype)
        assert same(gd[0], rd[0]) and same(gd[1], rd[1]), out
    ref = rkq.quantize_entry(k[:, :, 0], v[:, :, 0], mode)
    got = kvquant.quantize_entry(tt(k[:, :, 0]), tt(v[:, :, 0]), mode)
    assert all(same(g, r) for g, r in zip(got, ref))
    rd = rkq.dequantize_entry(*ref, BF16)
    gd = kvquant.dequantize_entry(*got, torch.bfloat16)
    assert same(gd[0], rd[0]) and same(gd[1], rd[1])


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_codec_edges_equal_the_reference(mode):
    """The edges: a block holding +inf (its scale inf: finite values
    quantize to 0, inf/inf to NaN), one holding -inf, one holding NaN (all
    NaN), and a block whose absmax lands at 448.00003 before the e4m3 cast
    (it rounds to 448): codes and scales byte for byte, NaN signs
    included (int8 stores NaN as 0 in both)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 2, 4, 8)).astype(np.float32)
    x[0, 0, 0, 0] = np.inf
    x[1, 1, 2, 3] = -np.inf
    x[2, 0, 1, 1] = np.nan
    x[3] = np.float32(0.1) * np.arange(64, dtype=np.float32).reshape(2, 4, 8)
    with np.errstate(invalid="ignore"):
        ref = rkq.quantize_entry(x, x, mode)
    got = kvquant.quantize_entry(tt(x), tt(x), mode)
    assert all(same(g, r) for g, r in zip(got, ref))
    assert np.isnan(ref[2][2]) and np.isinf(ref[2][0])


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_codec_stack_roundtrip_error_bounds(mode):
    rng = np.random.default_rng(0)
    L, H, n, bs, D = 3, 2, 5, 4, 8
    k = torch.from_numpy(rng.standard_normal((L, H, n, bs, D)).astype(np.float32) * 3.0)
    v = torch.from_numpy(rng.standard_normal((L, H, n, bs, D)).astype(np.float32) * 0.01)
    qk, qv, ks, vs = kvquant.quantize_stack(k, v, mode)
    assert qk.dtype == kvquant.quant_dtype(mode)
    assert ks.shape == (L, n) and vs.shape == (L, n)
    k2, v2 = kvquant.dequantize_stack(qk, qv, ks, vs, torch.float32)
    for orig, rt, sc in ((k, k2, ks), (v, v2, vs)):
        step = sc[:, None, :, None, None].expand(orig.shape)
        if mode == "int8":
            bound = step * 0.5001
        else:
            bound = torch.maximum(orig.abs() * (2.0 ** -4) * 1.001, step)
        assert bool(((orig - rt).abs() <= bound).all())
    assert bool(torch.isfinite(qk.float()).all())


def test_codec_entry_roundtrip_and_nbytes():
    rng = np.random.default_rng(1)
    k = torch.from_numpy(rng.standard_normal((4, 2, 8, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((4, 2, 8, 16)).astype(np.float32))
    qk, qv, ks, vs = kvquant.quantize_entry(k, v, "int8")
    assert ks.shape == (4,) and vs.shape == (4,)
    k2, v2 = kvquant.dequantize_entry(qk, qv, ks, vs, torch.float32)
    torch.testing.assert_close(k2, k, atol=float(ks.max()) * 0.51, rtol=0)
    torch.testing.assert_close(v2, v, atol=float(vs.max()) * 0.51, rtol=0)
    full = kvquant.entry_nbytes((k, v))
    quant = kvquant.entry_nbytes((qk, qv, ks, vs))
    assert full == k.nbytes + v.nbytes
    assert quant < full / 3
    assert quant == rkq.entry_nbytes(tuple(t.numpy() for t in (qk, qv, ks, vs)))


def test_wire_block_bytes_math():
    full = 65536
    assert kvquant.wire_block_bytes(full, 2, layers=4, mode="int8") == (
        32768 + 2 * 4 * 4)
    assert kvquant.wire_block_bytes(full, 2, layers=4, mode="none") == full
    assert full / kvquant.wire_block_bytes(full, 2, 4, "int8") >= 1.8
    for args in ((65536, 2, 4), (2 << 20, 2, 32), (1 << 20, 1, 32), (4096, 4, 2)):
        for mode in ("none", "int8", "fp8", None):
            assert (kvquant.wire_block_bytes(*args, mode)
                    == rkq.wire_block_bytes(*args, mode))


# ---------------- host pool ----------------


def _blk(i):
    return torch.full((2, 2, 4, 8), float(i))  # [L, Hkv, bs, D]


def test_host_pool_lru_and_chain_match():
    pool = HostKvPool(capacity_blocks=3)
    for h in (1, 2, 3):
        pool.put(h, _blk(h), _blk(h))
    assert pool.match_chain([1, 2, 3, 4]) == 3
    pool.put(4, _blk(4), _blk(4))  # evicts 1 (LRU)
    assert 1 not in pool and 2 in pool
    assert pool.match_chain([1, 2, 3]) == 0
    got = pool.take(2)
    assert got is not None and got[0][0, 0, 0, 0] == 2
    assert 2 not in pool


def test_host_pool_zero_capacity_noop():
    pool = HostKvPool(0)
    pool.put(1, _blk(1), _blk(1))
    assert len(pool) == 0 and pool.take(1) is None


def _rblk(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 2, 4, 8)).astype(dtype),
            rng.standard_normal((2, 2, 4, 8)).astype(dtype))


def test_host_pool_byte_budget_holds_2x_quantized_blocks():
    k, v = map(tt, _rblk(0))
    block_bytes = k.nbytes + v.nbytes
    pool = HostKvPool(4, block_bytes=block_bytes)
    for h in range(10):
        pool.put(h, *map(tt, _rblk(h)))
    assert len(pool) == 4
    poolq = HostKvPool(4, block_bytes=block_bytes)
    for h in range(40):
        qk, qv, ks, vs = kvquant.quantize_entry(*map(tt, _rblk(h)), "int8")
        poolq.put(h, qk, qv, scales=(ks, vs))
    assert len(poolq) >= int(4 * 1.8)
    for h in list(poolq._data)[:3]:
        assert poolq.take(h) is not None
    before = len(poolq)
    for h in range(100, 104):
        qk, qv, ks, vs = kvquant.quantize_entry(*map(tt, _rblk(h)), "int8")
        poolq.put(h, qk, qv, scales=(ks, vs))
    assert len(poolq) >= before


def test_host_pool_plan_equals_the_reference():
    """plan_puts / apply_plan over one seeded put script: the same drops,
    keeps and recency order as the reference's pool, and the same pool."""
    rng = np.random.default_rng(4)
    ref, got = roff.HostKvPool(6), HostKvPool(6)
    for h in rng.integers(0, 12, 5).tolist():
        ref.put(h, *_rblk(h))
        got.put(h, *map(tt, _rblk(h)))
    for _ in range(4):
        hashes = rng.integers(0, 16, 5).tolist()
        plan = got.plan_puts(hashes)
        assert plan == ref.plan_puts(hashes)
        ref.apply_plan(*plan, hashes, lambda i: _rblk(hashes[i]))
        got.apply_plan(*plan, hashes, lambda i: tuple(map(tt, _rblk(hashes[i]))))
        assert list(got._data) == list(ref._data)


# ---------------- disk store ----------------


def test_disk_store_roundtrip_lru_and_restart_rescan(tmp_path):
    store = DiskKvStore(str(tmp_path), capacity_blocks=2)
    k1, v1 = map(tt, _rblk(1, BF16))
    assert store.put(101, k1, v1)
    got = store.get(101)
    assert got is not None and got[0].dtype == torch.bfloat16
    assert same(got[0], k1) and same(got[1], v1)
    store.put(102, *map(tt, _rblk(2)))
    store.get(101)
    store.put(103, *map(tt, _rblk(3)))
    assert store.get(102) is None and len(store) == 2
    assert 102 in store.drain_dropped()
    assert not os.path.exists(os.path.join(str(tmp_path), f"{102:016x}.kvb"))
    open(os.path.join(str(tmp_path), "garbage.tmp"), "wb").write(b"junk")
    store2 = DiskKvStore(str(tmp_path), capacity_blocks=8)
    assert len(store2) == 2 and store2.contains(101) and store2.contains(103)
    again = store2.get(101)
    assert again is not None and same(again[0], k1)


def test_disk_store_ttl_expires_entries(tmp_path):
    store = DiskKvStore(str(tmp_path), capacity_blocks=8, ttl_s=0.05)
    store.put(7, *map(tt, _rblk(7)))
    assert store.get(7) is not None
    time.sleep(0.12)
    assert store.get(7) is None
    assert 7 in store.drain_dropped()
    assert store.corrupt_discards == 0


def test_disk_store_truncated_corrupt_and_version_mismatch(tmp_path):
    path = str(tmp_path)

    def entry_file(h):
        return os.path.join(path, f"{h:016x}.kvb")

    def fresh(h):
        s = DiskKvStore(path, capacity_blocks=8)
        s.put(h, *map(tt, _rblk(h)))
        return s

    fresh(11)
    data = open(entry_file(11), "rb").read()
    open(entry_file(11), "wb").write(data[: len(data) // 2])
    s = DiskKvStore(path, capacity_blocks=8)
    assert s.get(11) is None and s.corrupt_discards == 1
    assert not os.path.exists(entry_file(11))
    assert 11 in s.drain_dropped()

    fresh(12)
    data = bytearray(open(entry_file(12), "rb").read())
    data[-3] ^= 0xFF
    open(entry_file(12), "wb").write(bytes(data))
    s = DiskKvStore(path, capacity_blocks=8)
    assert s.get(12) is None and s.corrupt_discards == 1

    fresh(13)
    data = open(entry_file(13), "rb").read()
    (hlen,) = struct.unpack("<I", data[4:8])
    cur = f'"v": {DiskKvStore.VERSION}'.encode()
    assert cur in data[8 : 8 + hlen]
    head = data[8 : 8 + hlen].replace(cur, b'"v": 9')
    open(entry_file(13), "wb").write(
        data[:4] + struct.pack("<I", len(head)) + head + data[8 + hlen :])
    s = DiskKvStore(path, capacity_blocks=8)
    assert s.get(13) is None and s.corrupt_discards == 1

    fresh(14)
    data = open(entry_file(14), "rb").read()
    open(entry_file(14), "wb").write(b"NOPE" + data[4:])
    s = DiskKvStore(path, capacity_blocks=8)
    assert s.get(14) is None and s.corrupt_discards == 1


def test_disk_store_quantized_entry_roundtrips_scales(tmp_path):
    s = DiskKvStore(str(tmp_path), capacity_blocks=8)
    qk, qv, ks, vs = kvquant.quantize_entry(*map(tt, _rblk(3)), "int8")
    assert s.put(33, qk, qv, scales=(ks, vs))
    got = s.get(33)
    assert got is not None and len(got) == 4
    assert same(got[0], qk) and same(got[2], ks) and same(got[3], vs)
    s2 = DiskKvStore(str(tmp_path), capacity_blocks=8)
    got2 = s2.get(33)
    assert got2 is not None and len(got2) == 4


def test_disk_store_corrupt_or_truncated_scale_section_is_clean_miss(tmp_path):
    path = str(tmp_path)

    def write_entry(h):
        s = DiskKvStore(path, capacity_blocks=8)
        qk, qv, ks, vs = kvquant.quantize_entry(*map(tt, _rblk(h)), "int8")
        assert s.put(h, qk, qv, scales=(ks, vs))
        return os.path.join(path, f"{h:016x}.kvb")

    f = write_entry(21)
    data = bytearray(open(f, "rb").read())
    data[-2] ^= 0xFF
    open(f, "wb").write(bytes(data))
    s = DiskKvStore(path, capacity_blocks=8)
    assert s.get(21) is None and s.corrupt_discards == 1
    assert 21 in s.drain_dropped()

    f = write_entry(22)
    data = open(f, "rb").read()
    open(f, "wb").write(data[:-5])
    s = DiskKvStore(path, capacity_blocks=8)
    assert s.get(22) is None and s.corrupt_discards == 1

    f = write_entry(23)
    data = open(f, "rb").read()
    (hlen,) = struct.unpack("<I", data[4:8])
    head = data[8 : 8 + hlen].replace(b'"ks_bytes": 8', b'"ks_bytes": 4')
    open(f, "wb").write(
        data[:4] + struct.pack("<I", len(head)) + head + data[8 + hlen :])
    s = DiskKvStore(path, capacity_blocks=8)
    assert s.get(23) is None and s.corrupt_discards == 1


def test_disk_store_byte_budget_holds_more_quantized_blocks(tmp_path):
    k, v = map(tt, _rblk(0))
    bb = k.nbytes + v.nbytes
    s = DiskKvStore(str(tmp_path / "full"), capacity_blocks=4, block_bytes=bb)
    for h in range(10):
        s.put(h, *map(tt, _rblk(h)))
    assert len(s) == 4
    sq = DiskKvStore(str(tmp_path / "q"), capacity_blocks=4, block_bytes=bb)
    for h in range(40):
        qk, qv, ks, vs = kvquant.quantize_entry(*map(tt, _rblk(h)), "int8")
        sq.put(h, qk, qv, scales=(ks, vs))
    assert len(sq) >= int(4 * 1.8)


def test_manager_normalizes_disk_entries_across_kv_quant_flip(tmp_path):
    path = str(tmp_path)
    k, v = map(tt, _rblk(9))
    bb = k.nbytes + v.nbytes
    om_q = OffloadManager(4, disk_blocks=8, disk_path=path, kv_quant="int8",
                          block_bytes=bb, full_dtype="float32")
    e = om_q._encode_entry(k, v)
    assert om_q.disk.put(77, e[0], e[1], scales=(e[2], e[3]))
    om_q.close()
    om_n = OffloadManager(4, disk_blocks=8, disk_path=path, full_dtype="float32")
    assert om_n.promote_chain([77]) == 1
    hashes, data = om_n.reserve_chain([77])
    assert hashes == [77] and len(data[0]) == 2
    torch.testing.assert_close(data[0][0], k, atol=float(e[2].max()) * 0.51, rtol=0)
    assert om_n.disk.corrupt_discards == 0
    om_n.close()
    om_n2 = OffloadManager(4, disk_blocks=8, disk_path=path, full_dtype="float32")
    om_n2.disk.put(78, k, v)
    om_n2.close()
    om_q2 = OffloadManager(4, disk_blocks=8, disk_path=path, kv_quant="int8",
                           block_bytes=bb, full_dtype="float32")
    assert om_q2.promote_chain([78]) == 1
    hashes, data = om_q2.reserve_chain([78])
    assert hashes == [78] and len(data[0]) == 4
    assert data[0][0].dtype == torch.int8
    assert om_q2.disk.corrupt_discards == 0
    om_q2.close()


def _interop_entries():
    """(label, k, v, scales) numpy entries of every kind a tier holds."""
    rng = np.random.default_rng(7)
    out = []
    for dt, label in ((BF16, "bf16"), (np.float32, "f32")):
        k, v = _rblk(5, dt)
        out.append((label, k, v, None))
    k8, v8 = (rng.standard_normal((2, 2, 4, 8)) * 100).astype(E4M3), (
        rng.standard_normal((2, 1, 4, 16)) * 100).astype(E4M3)
    out.append(("e4m3 pages", k8, v8, None))
    for mode in ("int8", "fp8"):
        qk, qv, ks, vs = rkq.quantize_entry(*_rblk(6, BF16), mode)
        out.append((f"{mode} entry", qk, qv, (ks, vs)))
    return out


@pytest.mark.parametrize("which", range(5), ids=["bf16", "f32", "e4m3 pages",
                                                 "int8 entry", "fp8 entry"])
def test_disk_entries_interoperate_both_ways(tmp_path, which):
    """An entry written by either package is read by the other byte for
    byte, and the two writers' files are identical."""
    label, k, v, scales = _interop_entries()[which]
    h = 0x1234_5678_9ABC_DEF0 + which
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref = roff.DiskKvStore(str(ref_dir), capacity_blocks=4)
    port = DiskKvStore(str(port_dir), capacity_blocks=4)
    assert ref.put(h, k, v, scales=scales)
    tscales = None if scales is None else tuple(tt(s) for s in scales)
    assert port.put(h, tt(k), tt(v), scales=tscales)
    name = f"{h:016x}.kvb"
    assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes(), label
    # each package reads the other's directory
    from_ref = DiskKvStore(str(ref_dir), capacity_blocks=4).get(h)
    from_port = roff.DiskKvStore(str(port_dir), capacity_blocks=4).get(h)
    want = (k, v) if scales is None else (k, v, *scales)
    assert from_ref is not None and from_port is not None
    assert len(from_ref) == len(from_port) == len(want)
    for a, b, w in zip(from_ref, from_port, want):
        assert same(a, w) and same(b, w), label
        assert a.shape == tuple(w.shape) and b.dtype == w.dtype


# ---------------- the block copies against the reference's cores ----------------


def _cache(rng, shape, dtype):
    if dtype == np.int8:
        return rng.integers(-127, 128, shape).astype(np.int8)
    return (rng.standard_normal(shape) * (100 if dtype == E4M3 else 1)).astype(dtype)


def _np(x):
    return np.asarray(x)


WIDTHS = [((2, 2, 2, 8, 8), "GQA"), ((3, 1, 1, 16, 4), "MLA latents")]


@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int8, E4M3],
                         ids=["f32", "bf16", "int8", "e4m3"])
@pytest.mark.parametrize("w", range(2), ids=[w[1] for w in WIDTHS])
def test_gather_and_scatter_equal_the_reference(dtype, w):
    """gather_blocks_core (and gather_blocks_s_core with the int8 planes),
    scatter_blocks_core and scatter_blocks_adopt_core, on bucketed index
    vectors out of order with the trash page padding them."""
    (L, Hk, Hv, Dk, Dv), _ = WIDTHS[w]
    rng = np.random.default_rng(w)
    N, bs = 13, 4
    kc, vc = _cache(rng, (L, Hk, N, bs, Dk), dtype), _cache(rng, (L, Hv, N, bs, Dv), dtype)
    for m in (1, 3, 5):
        idxs = _pad_idxs(rng.permutation(np.arange(1, N))[:m].tolist())
        assert idxs.shape[0] == _bucket(m)
        ref = roff._gather_blocks(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(idxs))
        got = bc.gather_blocks_plain(tt(kc), tt(vc), torch.from_numpy(idxs))
        assert same(got[0], _np(ref[0])) and same(got[1], _np(ref[1]))
        kd = _cache(rng, (L, Hk, m, bs, Dk), dtype)
        vd = _cache(rng, (L, Hv, m, bs, Dv), dtype)
        ref = roff._scatter_blocks(jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(idxs), jnp.asarray(kd), jnp.asarray(vd))
        tk, tv = tt(kc), tt(vc)
        bc.scatter_blocks_plain(tk, tv, torch.from_numpy(idxs), tt(kd), tt(vd))
        assert same(tk, _np(ref[0])) and same(tv, _np(ref[1]))
        if dtype != np.int8:
            continue
        ksp, vsp = (rng.random((L, N)).astype(np.float32) for _ in range(2))
        ref = roff._gather_blocks_s(jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(ksp), jnp.asarray(vsp),
                                    jnp.asarray(idxs))
        got = bc.gather_blocks_plain(tt(kc), tt(vc), torch.from_numpy(idxs),
                                     tt(ksp), tt(vsp))
        assert all(same(g, _np(r)) for g, r in zip(got, ref))
        ks, vs = (rng.random((L, m)).astype(np.float32) for _ in range(2))
        ks[0, 0] = 0.0  # clamps to the floor
        ref = roff._scatter_blocks_adopt(
            *(jnp.asarray(a) for a in (kc, vc, ksp, vsp, idxs, kd, vd, ks, vs)))
        t = [tt(a) for a in (kc, vc, ksp, vsp)]
        bc.scatter_blocks_plain(t[0], t[1], torch.from_numpy(idxs), tt(kd), tt(vd),
                                t[2], t[3], tt(ks), tt(vs))
        assert all(same(g, _np(r)) for g, r in zip(t, ref))


def test_scatter_cast_into_e4m3_over_every_bf16_pattern():
    """scatter_blocks_core's cast of a bf16 payload into an e4m3 cache
    (``astype``: NaN above 464, for inf and NaN) over all 65 536 bf16
    patterns, byte for byte."""
    pats = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(BF16)
    L, H, m, bs, D = 2, 2, 4, 16, 256  # 65 536 values
    kd = pats.reshape(L, H, m, bs, D)
    vd = np.roll(pats, 1).reshape(L, H, m, bs, D)
    kc = np.zeros((L, H, 9, bs, D), E4M3)
    idxs = _pad_idxs([5, 2, 7, 1])
    ref = roff._scatter_blocks(jnp.asarray(kc), jnp.asarray(kc), jnp.asarray(idxs),
                               jnp.asarray(kd), jnp.asarray(vd))
    tk, tv = tt(kc), tt(kc)
    bc.scatter_blocks_plain(tk, tv, torch.from_numpy(idxs), tt(kd), tt(vd))
    assert same(tk, _np(ref[0])) and same(tv, _np(ref[1]))


@pytest.mark.parametrize("code", [np.int8, E4M3], ids=["int8", "e4m3"])
@pytest.mark.parametrize("cache", [np.float32, BF16, E4M3], ids=["f32", "bf16", "e4m3"])
def test_dequant_scatter_equals_the_reference(code, cache):
    """scatter_blocks_q_core: codes times per-(layer, block) scales into
    the cache's dtype; scales up to 8 carry int8 codes past 464 into the
    e4m3 cache (NaN bytes)."""
    rng = np.random.default_rng(3)
    L, Hk, Hv, bs, Dk, Dv, N = 2, 2, 1, 4, 8, 16, 11
    kc, vc = _cache(rng, (L, Hk, N, bs, Dk), cache), _cache(rng, (L, Hv, N, bs, Dv), cache)
    for m in (1, 3, 6):
        idxs = _pad_idxs(rng.permutation(np.arange(1, N))[:m].tolist())
        kd = _cache(rng, (L, Hk, m, bs, Dk), code)
        vd = _cache(rng, (L, Hv, m, bs, Dv), code)
        ks, vs = ((rng.random((L, m)) * 8).astype(np.float32) for _ in range(2))
        ref = roff._scatter_blocks_q(
            *(jnp.asarray(a) for a in (kc, vc, idxs, kd, vd, ks, vs)))
        tk, tv = tt(kc), tt(vc)
        bc.scatter_blocks_dequant_plain(tk, tv, torch.from_numpy(idxs), tt(kd),
                                        tt(vd), tt(ks), tt(vs))
        assert same(tk, _np(ref[0])) and same(tv, _np(ref[1]))


@pytest.mark.parametrize("data", [np.float32, BF16, np.int8, E4M3],
                         ids=["f32", "bf16", "int8", "e4m3"])
def test_requant_scatter_equals_the_reference(data):
    """scatter_blocks_requant_core into the int8 cache: full-width stacks
    with ones, int8 and e4m3 codes with their scales; codes and plane
    scales byte for byte (a zero block's scale at the floor)."""
    rng = np.random.default_rng(5)
    L, H, bs, D, N = 2, 2, 4, 8, 11
    kc, vc = _cache(rng, (L, H, N, bs, D), np.int8), _cache(rng, (L, H, N, bs, D), np.int8)
    ksp, vsp = (rng.random((L, N)).astype(np.float32) for _ in range(2))
    for m in (1, 3, 6):
        idxs = _pad_idxs(rng.permutation(np.arange(1, N))[:m].tolist())
        kd = _cache(rng, (L, H, m, bs, D), data)
        vd = _cache(rng, (L, H, m, bs, D), data)
        if data in (np.float32, BF16):
            ks = vs = np.ones((L, m), np.float32)
        else:
            ks, vs = ((rng.random((L, m)) * 3).astype(np.float32) for _ in range(2))
        kd[0, :, 0] = 0  # a zero block
        ref = roff._scatter_blocks_requant(
            *(jnp.asarray(a) for a in (kc, vc, ksp, vsp, idxs, kd, vd, ks, vs)))
        t = [tt(a) for a in (kc, vc, ksp, vsp)]
        bc.scatter_blocks_requant_plain(*t, torch.from_numpy(idxs), tt(kd), tt(vd),
                                        tt(ks), tt(vs))
        assert all(same(g, _np(r)) for g, r in zip(t, ref))


def test_upload_times_record_each_landed_upload():
    """A begun upload that landed adds one to ``upload_times["uploads"]``
    (the card adds its pin, stack and h2d ms; the CPU stacks nothing), and
    ``stats()`` keeps exactly the reference's keys."""
    rng = np.random.default_rng(5)
    om = OffloadManager(8)
    blocks = []
    for h in (11, 12, 13):
        k = torch.from_numpy(rng.standard_normal((2, 2, 4, 8)).astype(np.float32))
        om.pool.put(h, k, -k)
        blocks.append(k)
    k_cache = torch.zeros((2, 2, 6, 4, 8))
    v_cache = torch.zeros_like(k_cache)
    hashes, data = om.reserve_chain([11, 12, 13])
    up = om.begin_upload(hashes, data, [1, 2, 3])
    om.finish_upload(k_cache, v_cache, up)
    assert om.upload_times["uploads"] == 1
    for i, k in enumerate(blocks, start=1):
        assert torch.equal(k_cache[:, :, i], k) and torch.equal(v_cache[:, :, i], -k)
    ref = roff.OffloadManager(8)
    assert set(om.stats()) == set(ref.stats())
    om.close()
    ref.close()
