"""``TorchEngine`` with the host and disk KV tiers against ``JaxEngine``.

The reference's engine cases of ``tests/test_offload.py``,
``tests/test_prefix_fleet.py``, ``tests/test_offload_pipeline.py`` and
``tests/test_lowprec.py``, on the CPU at a tiny size. Where both engines run
a case (the same f32 weights), their greedy tokens are equal and so are the
tier counters; a restored prefix's pages are byte-equal to the pages it
left the device as. The int8 device cache with the int8 tier adopts codes
and scales verbatim, and a restored request gives its first serve's tokens:
C.15 (ROADMAP), a fault of the reference that the port does not copy, is
that the reference's restore there loses the adopted scales.

Transfer latency is injected through ``engine/offload.py``'s module-level
``_device_fetch`` / ``_device_put`` hooks, as the reference's tests do.
"""

import asyncio
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import dynamo_tpu_torch.engine.offload as offload_mod
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStops
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu.runtime import collect as jax_collect
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.allocator import BlockAllocator, sequence_block_hashes
from dynamo_tpu_torch.engine.engine import _Sequence
from dynamo_tpu_torch.engine.offload import OffloadManager
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context, collect

GEOMETRY = dict(num_blocks=17, block_size=4, max_batch_size=2, max_context=64,
                prefill_chunk=32)
PROMPT = list(range(100, 124))  # 6 blocks of 4
#: the tier counters both engines must agree on once their flushes landed
TIER_KEYS = ("offload_blocks_resident", "offload_blocks_stored_total",
             "offload_hit_blocks_total", "disk_blocks_resident",
             "disk_hit_blocks_total", "disk_demotions_total",
             "disk_corrupt_discards", "kv_quant_blocks_total")


class Api:
    """One package's request types, so a script runs on either engine."""

    def __init__(self, req, stops, samp, ctx, collect_fn):
        self.req, self.stops, self.samp = req, stops, samp
        self.ctx, self.collect = ctx, collect_fn

    def request(self, toks, n):
        return self.req(token_ids=list(toks),
                        stop_conditions=self.stops(max_tokens=n, ignore_eos=True),
                        sampling_options=self.samp(temperature=0.0, seed=0),
                        eos_token_ids=[511])

    async def toks(self, engine, toks, n=2):
        outs = await self.collect(engine.generate(self.ctx(self.request(toks, n))))
        return [t for o in outs for t in o.token_ids]


JAX = Api(JaxRequest, JaxStops, JaxSampling, JaxContext, jax_collect)
TORCH = Api(PreprocessedRequest, StopConditions, SamplingOptions, Context, collect)


_MODELS: dict = {}


def _pair(mla=False, **kw):
    """A JaxEngine and a TorchEngine on the same f32 weights (one JAX model
    config per family for the module: the reference's programs compile
    once)."""
    mk = "tiny_mla" if mla else "tiny"
    if mk not in _MODELS:
        jcfg = getattr(JaxModelConfig, mk)(dtype="float32")
        jeng = JaxEngine(JaxEngineConfig(model=jcfg, **GEOMETRY), seed=0)
        _MODELS[mk] = (jcfg, jeng.params, jax.tree.map(np.asarray, jeng.params))
    jcfg, jparams, tree = _MODELS[mk]
    tcfg = getattr(ModelConfig, mk)(dtype="float32")
    jeng = JaxEngine(JaxEngineConfig(model=jcfg, **{**GEOMETRY, **kw}),
                     params=jparams)
    teng = TorchEngine(EngineConfig(model=tcfg, **{**GEOMETRY, **kw}),
                       params=from_jax_params(tree, tcfg), device="cpu")
    return jeng, teng


async def _settle(engine):
    """Every in-flight flush and disk demotion landed: the offload
    executor's two workers meet at a barrier only once both are free."""
    off = engine.offload
    if off._exec is not None:
        barrier = threading.Barrier(2)
        futs = [off._exec.submit(barrier.wait, 60) for _ in range(2)]
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: [f.result() for f in futs])
    off._reap_flushes_locked()


def _pages(engine, tokens) -> list:
    """Bytes of every device page holding a full block of ``tokens``'
    chain (and its int8 plane scales), by hash."""
    alloc = engine.allocator
    out = []
    for _l, h in sequence_block_hashes(tokens, engine.cfg.block_size):
        idx = alloc._by_hash.get(h, alloc._reuse.get(h))
        assert idx is not None, "block not on the device"
        page = [engine.k_cache[:, :, idx].clone(), engine.v_cache[:, :, idx].clone()]
        if engine.k_scales is not None:
            page += [engine.k_scales[:, idx].clone(), engine.v_scales[:, idx].clone()]
        out.append([p.view(torch.uint8) if p.dtype != torch.float32 else p.view(torch.int32)
                    for p in page])
    return out


def _same_pages(a, b) -> bool:
    return len(a) == len(b) and all(
        all(torch.equal(x, y) for x, y in zip(pa, pb)) for pa, pb in zip(a, b))


async def _churn(api, engine, n=4):
    for i in range(n):
        await api.toks(engine, range(200 + 30 * i, 224 + 30 * i), 2)


# ---------------- the round trip through the tiers ----------------


@pytest.mark.parametrize("case", ["gqa host", "mla host", "gqa host+disk",
                                  "gqa sync"])
def test_restore_matches_the_reference(run, tmp_path, case):
    """test_offload.py's round trip (GQA and MLA's latent widths),
    test_prefix_fleet.py's host -> disk -> restore and
    test_offload_pipeline.py's synchronous escape hatch: a prompt served,
    churned out of the 16-page pool, served again; both engines give the
    same greedy tokens both times, the same tier counters, and the torch
    engine's restored pages are the pages it evicted, byte for byte."""
    kw = dict(host_cache_blocks=64)
    if "disk" in case:
        kw = dict(host_cache_blocks=8, disk_cache_blocks=64)
    if "sync" in case:
        kw["offload_async"] = False
    jeng, teng = _pair(mla="mla" in case, **kw)

    async def script(api, engine):
        t1 = await api.toks(engine, PROMPT, 4)
        pages = _pages(engine, PROMPT) if engine is teng else None
        await _churn(api, engine, 6 if "disk" in case else 4)
        await _settle(engine)
        assert engine.offload.pool.stored_total > 0
        if "disk" in case:
            chain = [s for _l, s in sequence_block_hashes(PROMPT[:-1], 4)]
            assert engine.offload.disk.match_chain(chain) >= 5
        base = engine.offload.pool.hit_blocks_total
        t2 = await api.toks(engine, PROMPT, 4)
        assert engine.offload.pool.hit_blocks_total > base
        if pages is not None:
            assert _same_pages(_pages(engine, PROMPT)[: len(pages) - 1],
                               pages[: len(pages) - 1])
        await _settle(engine)
        m = engine.load_metrics()
        await engine.close()
        return t1, t2, {k: m[k] for k in TIER_KEYS}

    ref = run(script(JAX, jeng))
    got = run(script(TORCH, teng))
    assert got[0] == got[1] == ref[0] == ref[1]
    assert got[2] == ref[2]
    if "disk" in case:
        assert got[2]["disk_hit_blocks_total"] >= 5
    if "sync" in case:
        assert teng.offload.d2h_flush_async_total == 0
    else:
        assert teng.offload.d2h_flush_async_total > 0


def test_offload_disabled_by_default(run):
    teng = TorchEngine(EngineConfig(model=ModelConfig.tiny(), **GEOMETRY),
                       device="cpu")
    assert teng.offload is None

    async def main():
        assert await TORCH.toks(teng, range(10, 20))
        await teng.close()

    run(main())


def test_corrupt_disk_entry_is_clean_miss_on_restore_path(run, tmp_path):
    """Corrupting the chain's first on-disk block makes the serve a
    recompute: the same tokens, a corrupt-discard counted, no exception."""
    teng = TorchEngine(EngineConfig(model=ModelConfig.tiny(), host_cache_blocks=8,
                                    disk_cache_blocks=64,
                                    disk_cache_path=str(tmp_path), **GEOMETRY),
                       device="cpu")

    async def main():
        t1 = await TORCH.toks(teng, PROMPT)
        await _churn(TORCH, teng, 6)
        await _settle(teng)
        h0 = sequence_block_hashes(PROMPT, 4)[0][1]
        f = os.path.join(str(tmp_path), f"{h0:016x}.kvb")
        data = bytearray(open(f, "rb").read())
        data[-5] ^= 0xFF
        open(f, "wb").write(bytes(data))
        assert await TORCH.toks(teng, PROMPT) == t1
        assert teng.offload.stats()["disk_corrupt_discards"] >= 1
        await teng.close()

    run(main())
    assert os.path.isdir(tmp_path)  # an explicit disk path persists


def test_allocator_demotes_instead_of_removes_with_offload_tier():
    demoted, removed, evicted = [], [], []
    alloc = BlockAllocator(num_blocks=2, block_size=4)
    alloc.on_evict = lambda h, b: evicted.append(h)
    alloc.on_demoted = lambda hs: demoted.extend(hs)
    alloc.on_removed = lambda hs: removed.extend(hs)
    (b,) = alloc.allocate(1)
    h = alloc.commit_full_block(b, [1, 2, 3, 4], None)
    alloc.free([b])
    (b2,) = alloc.allocate(1)
    assert evicted == [h] and demoted == [h] and removed == []
    alloc.free([b2])
    alloc2 = BlockAllocator(num_blocks=2, block_size=4)
    removed2 = []
    alloc2.on_removed = lambda hs: removed2.extend(hs)
    (c,) = alloc2.allocate(1)
    h2 = alloc2.commit_full_block(c, [1, 2, 3, 4], None)
    alloc2.free([c])
    (c2,) = alloc2.allocate(1)
    assert removed2 == [h2]
    alloc2.free([c2])


def test_publisher_publishes_demotions_and_last_tier_drops():
    """KvEventPublisher.attach(allocator, offload): a device eviction
    publishes ``demoted``, a hash that left every tier ``removed``."""
    from dynamo_tpu_torch.kv_router.publisher import KvEventPublisher

    events = []
    pub = KvEventPublisher.__new__(KvEventPublisher)
    pub.publish = events.append
    alloc = BlockAllocator(num_blocks=2, block_size=4)
    om = OffloadManager(1)
    alloc.on_evict = lambda h, b: om.on_evict(h, b.idx)
    om.device_has = alloc.has_hash
    pub.attach(alloc, offload=om)
    (b,) = alloc.allocate(1)
    h = alloc.commit_full_block(b, [1, 2, 3, 4], None)
    alloc.free([b])
    alloc.allocate(1)
    assert [(e.kind, e.block_hashes) for e in events] == [
        ("stored", []), ("demoted", [h])]
    # the hash left the device, and no tier took it: a removal
    om._dropped_pending.append(h)
    om.flush_dropped()
    assert (events[-1].kind, events[-1].block_hashes) == ("removed", [h])
    om.close()


# ---------------- the async pipeline ----------------


def test_flush_budget_and_double_buffer(monkeypatch):
    real_fetch = offload_mod._device_fetch

    def slow_fetch(*a):
        time.sleep(0.15)
        return real_fetch(*a)

    monkeypatch.setattr(offload_mod, "_device_fetch", slow_fetch)
    k = torch.zeros((2, 2, 40, 4, 8))
    v = torch.zeros((2, 2, 40, 4, 8))
    om = OffloadManager(64)
    for i in range(1, 31):
        om.on_evict(1000 + i, i)
    om.flush_evictions_async(k, v, budget=8, must_idxs={29, 30})
    assert om.d2h_flush_async_total == 1
    assert len(om._pending) == 30 - 10
    assert {1029, 1030} <= set(om._inflight_flushes[0].hashes)
    assert not om._inflight_flushes[0].future.done()
    om.flush_evictions_async(k, v, budget=8)
    assert om.d2h_flush_async_total == 2
    om.flush_evictions_async(k, v, budget=8)
    assert om.d2h_flush_async_total == 2 and len(om._pending) == 12
    hashes, data = om.reserve_chain([1001, 1002])
    assert hashes == [1001, 1002] and len(data) == 2
    om.unreserve(hashes, data)
    om.flush_evictions_async(k, v)
    for t in list(om._inflight_flushes):
        t.future.result()
    assert om.pool.stored_total == 30 and len(om.pool) == 30
    om.close()


def _cfg(**kw):
    return EngineConfig(model=ModelConfig.tiny(), host_cache_blocks=64,
                        **{**GEOMETRY, **kw})


def test_decode_interleaves_with_async_flush(run, monkeypatch):
    """Forced evictions + a slow d2h do not stall decode: a token of a long
    decode lands inside a fetch's sleep, and the flushed prefix restores
    bit-exact."""
    windows = []
    real_fetch = offload_mod._device_fetch

    def slow_fetch(*a):
        t0 = time.monotonic()
        time.sleep(0.2)
        out = real_fetch(*a)
        windows.append((t0, time.monotonic()))
        return out

    monkeypatch.setattr(offload_mod, "_device_fetch", slow_fetch)
    engine = TorchEngine(_cfg(), device="cpu")

    async def main():
        toks1 = await TORCH.toks(engine, PROMPT, 4)
        token_times = []

        async def run_b():
            async for _o in engine.generate(Context(TORCH.request(range(400, 408), 20))):
                token_times.append(time.monotonic())

        await asyncio.gather(run_b(), _churn(TORCH, engine))
        assert engine.offload.d2h_flush_async_total > 0
        await _settle(engine)  # the windows close as the fetches land
        assert any(any(t0 < tt < t1 for t0, t1 in windows) for tt in token_times)
        base = engine.offload.pool.hit_blocks_total
        assert await TORCH.toks(engine, PROMPT, 4) == toks1
        assert engine.offload.pool.hit_blocks_total > base
        await engine.close()

    run(main())


def test_cancel_mid_upload_rolls_back(run, monkeypatch):
    real_put = offload_mod._device_put

    def slow_put(*a):
        time.sleep(0.3)
        return real_put(*a)

    monkeypatch.setattr(offload_mod, "_device_put", slow_put)
    engine = TorchEngine(_cfg(), device="cpu")

    async def main():
        await TORCH.toks(engine, range(450, 462))
        toks_ref = await TORCH.toks(engine, PROMPT)
        await _churn(TORCH, engine)
        await _settle(engine)
        resident = len(engine.offload.pool)
        free = engine.allocator.free_count
        ctx = Context(TORCH.request(PROMPT, 2))
        seq = _Sequence(request=ctx.data, context=ctx.context,
                        out_queue=asyncio.Queue(), tokens=list(PROMPT),
                        prompt_len=len(PROMPT))
        assert engine._begin_prefill(seq)
        st = engine._prefill_states[0]
        assert st.upload is not None and not st.upload.future.done()
        ctx.context.stop_generating()
        assert not await engine._prefill_step() and not engine._prefill_states
        assert seq.out_queue.get_nowait().finish_reason is not None
        assert len(engine.offload.pool) == resident
        assert engine.allocator.free_count == free
        assert engine.offload.h2d_uploads_cancelled == 1
        base = engine.offload.pool.hit_blocks_total
        assert await TORCH.toks(engine, PROMPT) == toks_ref
        assert engine.offload.pool.hit_blocks_total > base
        await engine.close()

    run(main())


def test_adopt_restored_duplicate_hash_never_leaks_blocks():
    alloc = BlockAllocator(num_blocks=9, block_size=4)
    total_free = alloc.free_count
    (winner,) = alloc.allocate(1)
    h = alloc.commit_full_block(winner, [1, 2, 3, 4], None)
    alloc.free([winner])
    (loser,) = alloc.allocate(1)
    assert alloc.adopt_restored(loser, h, 123, None) is False
    assert loser.seq_hash is None
    alloc.free([loser])
    assert alloc.free_count == total_free
    matched = alloc.match_prefix([1, 2, 3, 4])
    assert [b.idx for b in matched] == [winner.idx]
    alloc.free(matched)
    assert alloc.free_count == total_free


def test_offload_stats_exported_via_load_metrics(run):
    engine = TorchEngine(_cfg(), device="cpu")
    m = engine.load_metrics()
    for key in ("d2h_flush_async", "h2d_prefetch_hits", "restore_latency_hidden_frac"):
        assert key in m, key
    run(engine.close())


# ---------------- the int8 device cache and the tier codec ----------------


INT8 = dict(num_blocks=16, block_size=4, max_batch_size=4, max_context=128,
            prefill_chunk=32, kv_cache_dtype="int8", host_cache_blocks=32)


def test_int8_tier_adopts_device_codec_zero_bounce(run):
    """The reference's test_lowprec.py case, with C.15 repaired: int8 device
    cache + int8 tier: flushes ship codes + plane scales verbatim (no
    bounce), the restored pages equal the evicted ones (codes and scales),
    and the restored request gives its first serve's tokens."""
    engine = TorchEngine(EngineConfig(model=ModelConfig.tiny(), kv_quant="int8",
                                      **INT8), device="cpu")
    prompt = list(range(200, 240))

    async def main():
        first = await TORCH.toks(engine, prompt, 8)
        pages = _pages(engine, prompt)
        for i in range(3):
            await TORCH.toks(engine, range(300 + 50 * i, 340 + 50 * i), 8)
        await _settle(engine)
        assert engine.offload.device_requants_total == 0
        assert engine.load_metrics()["kv_device_export_requant_total"] == 0
        assert engine.offload.stats()["kv_quant_blocks_total"] > 0
        base = engine.offload.pool.hit_blocks_total
        again = await TORCH.toks(engine, prompt, 8)
        assert engine.offload.pool.hit_blocks_total > base
        assert _same_pages(_pages(engine, prompt)[:-1], pages[:-1])
        assert first == again
        assert engine.load_metrics()["kv_device_export_requant_total"] == 0
        await engine.close()

    run(main())


@pytest.mark.parametrize("kv_quant", ["none", "fp8"])
def test_other_tier_codecs_bounce_off_the_int8_cache_counted(run, kv_quant):
    """int8 device cache + a full-width or fp8 tier: every flushed block
    leaves the device codec (counted in kv_device_export_requant_total,
    as the reference counts it), and the restore requantizes on landing
    (a host tier of 128 int8 blocks' bytes holds the full-width entries)."""
    engine = TorchEngine(EngineConfig(model=ModelConfig.tiny(), kv_quant=kv_quant,
                                      **{**INT8, "host_cache_blocks": 128}),
                         device="cpu")
    prompt = list(range(200, 240))

    async def main():
        await TORCH.toks(engine, prompt, 8)
        for i in range(3):
            await TORCH.toks(engine, range(300 + 50 * i, 340 + 50 * i), 8)
        await _settle(engine)
        assert engine.offload.device_requants_total > 0
        assert engine.load_metrics()["kv_device_export_requant_total"] > 0
        base = engine.offload.pool.hit_blocks_total
        assert len(await TORCH.toks(engine, prompt, 8)) == 8
        assert engine.offload.pool.hit_blocks_total > base
        await engine.close()

    run(main())


def test_dynamo_run_tier_flags(run, tmp_path):
    """``dynamo_run``'s tier flags reach the engine: a host tier, a disk
    tier at ``--disk-path``, its TTL, the int8 codec, and no cost model."""
    from dynamo_tpu_torch.launch import dynamo_run

    args = dynamo_run.parse_args([
        "in=http", "out=torch", "--model-path", "tiny", "--device", "cpu",
        "--num-blocks", "32", "--max-context", "128", "--host-cache-blocks",
        "16", "--disk-blocks", "64", "--disk-path", str(tmp_path),
        "--kv-tier-ttl-s", "30", "--kv-quant", "int8", "--no-kv-cost-model"])
    _worker, core, _name = dynamo_run.build_engine(args)
    off = core.offload
    assert off.pool.capacity == 16 and off.disk.capacity == 64
    assert off.disk.path == str(tmp_path) and off.disk.ttl_s == 30.0
    assert off.kv_quant == "int8" and core.cost is None
    m = core.load_metrics()
    assert "kv_prefill_tok_s" not in m and m["disk_blocks_resident"] == 0
    assert m["kv_wire_block_bytes"] < m["kv_block_bytes"]
    run(core.close())


def test_logprob_drift_harness_through_the_int8_tier(run):
    """kvquant.measure_logprob_drift: a bf16 engine against one whose
    prefixes are parked in an int8 tier and restored (the reference's
    protocol); the drift lands in the quantized engine's stats."""
    from dynamo_tpu_torch.engine.kvquant import measure_logprob_drift

    cfg = ModelConfig.tiny(dtype="float32")
    params = TorchEngine(EngineConfig(model=cfg, **GEOMETRY), device="cpu").params
    ref = TorchEngine(EngineConfig(model=cfg, **GEOMETRY), params=params, device="cpu")
    q = TorchEngine(EngineConfig(model=cfg, kv_quant="int8", host_cache_blocks=64,
                                 **GEOMETRY), params=params, device="cpu")

    async def park(engine, _prompt):
        await _churn(TORCH, engine)
        await _settle(engine)

    async def main():
        d = await measure_logprob_drift(ref, q, [PROMPT], max_tokens=4, park=park)
        assert d["n_tokens"] == 4 and 0.0 <= d["greedy_agreement"] <= 1.0
        assert q.offload.pool.hit_blocks_total > 0
        assert q.load_metrics()["kv_quant_logprob_drift_max"] == pytest.approx(
            d["logprob_delta_max"], abs=1e-6)
        await ref.close()
        await q.close()

    run(main())


def test_disk_reads_stay_off_the_event_loop(run, monkeypatch):
    """A returning prompt whose chain lies on disk, with no eviction
    pending or in flight: its disk entries are read (and checked) on an
    executor thread, never on the event loop's (ROADMAP C.16: the
    reference reads them inline there)."""
    engine = TorchEngine(EngineConfig(model=ModelConfig.tiny(), host_cache_blocks=8,
                                      disk_cache_blocks=64, **GEOMETRY),
                         device="cpu")
    readers = []
    real_get = offload_mod.DiskKvStore.get

    def get(self, h):
        readers.append(threading.current_thread())
        return real_get(self, h)

    monkeypatch.setattr(offload_mod.DiskKvStore, "get", get)

    async def main():
        t1 = await TORCH.toks(engine, PROMPT)
        await _churn(TORCH, engine, 6)
        await _settle(engine)
        assert not engine.offload.has_pending()
        assert not engine.offload.has_inflight_flushes()
        readers.clear()
        assert await TORCH.toks(engine, PROMPT) == t1
        assert engine.offload.stats()["disk_hit_blocks_total"] > 0
        assert readers and threading.current_thread() not in readers
        await engine.close()

    run(main())
