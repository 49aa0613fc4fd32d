"""MLA over the scale-free fp8 cache (``kv_cache_dtype="float8_e4m3"``) in the
port against the JAX package, on the CPU.

Same inputs (numpy, from seeds; the latent pages cast to ``float8_e4m3fn``
by the reference's cast) through the JAX function and its port:

* the latent attention twins over fp8 pages (decode with its statistics,
  the verify's window merge, a prefill chunk) against the reference's dense
  XLA functions, which widen the pages with ``astype(float32)`` as the
  port's twins widen them with ``.float()``: within 2e-5 (f32 queries);
* the tiny MLA + MoE model over an fp8 cache: prefill, and the per-part
  mixed step's segment, against the reference's XLA path (both write the
  chunk first and read it back from the fp8 pages), the merged decode
  window and the mixed step's decode rows against the reference's kernel
  path (Pallas in interpret mode: the new token attended at full width, as
  the port does), the verify against the reference's (its window stays out
  of the cache on both paths); and the reference's XLA decode, which reads
  the new token back from its fp8 page, separated from both by that
  rounding (ROADMAP C.18);
* ``TorchEngine`` against ``JaxEngine`` (its XLA path) on ``tiny_mla``
  through the default schedule: greedy tokens equal, logprobs within
  2e-3, the KV pool's bytes and ``kv_block_bytes`` equal;
* the host tier (every codec) and the transfer plane (a JAX prefill
  worker feeding the port's decode engine) over an MLA fp8 cache, which the
  reference serves: the same tokens as the reference's engines.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import mla as jmodel_mla
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.ops import mla_attention_pallas as jmla
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStops
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu.runtime import collect as jax_collect
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops import mla_attention as tmla
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context, collect
from tests.test_torch_mla import BS, N_BLOCKS, _weights

FP8 = torch.float8_e4m3fn
TOL = dict(rtol=2e-5, atol=2e-5)


def _e4m3(x):
    """The reference's cast of f32 values (ml_dtypes, the same bytes as
    ``astype(float8_e4m3fn)``)."""
    return np.asarray(x, np.float32).astype(ml_dtypes.float8_e4m3fn)


def _t(*xs):
    """Torch copies (fp8 arrays through their bytes)."""
    out = []
    for x in xs:
        x = np.array(x)
        if x.dtype == ml_dtypes.float8_e4m3fn:
            out.append(torch.from_numpy(x.view(np.uint8)).view(FP8))
        else:
            out.append(torch.from_numpy(x))
    return out


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _f(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _close(got, ref, **tol):
    np.testing.assert_allclose(_f(got), _f(ref), **(tol or TOL))


def _bytes(x):
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# ---------------- the latent twins over fp8 pages ----------------


@pytest.mark.parametrize("C,R", [(32, 8), (512, 64)], ids=["tiny", "V2-Lite"])
def test_latent_twins_over_fp8_pages_match_the_reference_xla(C, R):
    """Decode (ragged, one empty slot, with statistics), the verify's merge
    of a 3-token window and a prefill chunk (history + the chunk, written
    first, padding past ``valid``) over the same fp8 page bytes."""
    rng = np.random.default_rng(3)
    B, M, H, T = 4, 5, 4, 3
    N = B * M + 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    cc, pc = _e4m3(f(1, N, BS, C) * 2), _e4m3(f(1, N, BS, R) * 2)
    tables = rng.permutation(np.arange(1, N)).astype(np.int32).reshape(B, M)
    scale = 0.7 / np.sqrt(C + R)

    # decode over seq_lens cached rows (the reference's XLA decode attends
    # positions < seq_lens, the pages holding the current token too)
    q_eff, q_pe = f(B, H, C), f(B, H, R)
    lens = np.asarray([1, BS + 3, 0, M * BS], np.int32)
    o, m, l = tmla.mla_paged_decode_attention(
        *_t(q_eff, q_pe, cc, pc, tables, lens), scale, return_stats=True)
    ref = jmodel_mla.mla_decode_attention_xla(
        *_j(q_eff, q_pe, cc, pc, tables, lens), scale)
    live = lens > 0
    _close(o[live], np.asarray(ref)[live])
    assert float(o[2].abs().max()) == 0.0 and float(l[2].max()) == 0.0

    # the verify: T in-flight tokens at full width over the fp8 history
    qv, qpv = f(B, T, H, C), f(B, T, H, R)
    c_win, pe_win = f(B, T, C), f(B, T, R)
    hist = np.asarray([2, BS + 1, 0, 3 * BS], np.int32)
    args = (qv, qpv, c_win, pe_win, cc, pc, tables, hist)
    got = tmla.mla_verify_attention(*_t(*args), scale)
    _close(got, tmla.mla_verify_attention_xla(*_t(*args), scale))
    _close(got, jmla.mla_verify_attention(*_j(*args), scale, use_pallas=False))

    # a prefill chunk of T = 6 rows (4 real) after 9 cached tokens
    qp_eff, qp_pe = f(6, H, C), f(6, H, R)
    table, valid = tables[3], 4
    got = tmla.mla_paged_prefill_attention(
        *_t(qp_eff, qp_pe, cc, pc, table), 9, scale, valid_len=valid)
    ref = jmodel_mla.mla_prefill_attention_xla(
        *_j(qp_eff, qp_pe, cc, pc, table), jnp.int32(9), jnp.int32(valid), scale)
    _close(got[:valid], np.asarray(ref)[:valid])
    assert float(got[valid:].abs().max()) == 0.0
    # the port's dense oracle reads the same pages
    _close(tmla.gather_latents(*_t(cc, tables)),
           jnp.take(jnp.asarray(cc)[0], jnp.asarray(tables), axis=0).reshape(
               B, M * BS, C))


# ---------------- the tiny MLA + MoE model over an fp8 cache ----------------


def _fp8_model(seed):
    rng = np.random.default_rng(seed)
    cfg = _weights()[1]
    ks, vs = llama.kv_cache_shapes(cfg, N_BLOCKS, BS)
    kc = _e4m3(rng.standard_normal(ks) * 0.5)
    vc = _e4m3(rng.standard_normal(vs) * 0.5)
    return (*_weights(), kc, vc, rng)


def _greedy(B):
    z_f, z_i = np.zeros(B, np.float32), np.zeros(B, np.int32)
    return z_i, z_i, z_f, z_i, np.ones(B, np.float32)


def _slots_equal(got, want, slots):
    """The pages agree byte for byte at ``slots`` ((page, row) pairs)."""
    for b, o in slots:
        np.testing.assert_array_equal(_bytes(got)[:, 0, b, o],
                                      _bytes(want)[:, 0, b, o])


def test_prefill_and_verify_over_fp8_match_the_reference():
    """Prefill (16 rows, 11 real, after 8 cached) against the reference's
    XLA prefill: both land the chunk through the reference's cast and read
    it back from the fp8 pages, so logits agree within 1e-4 and the landed
    rows byte for byte. The verify (3 proposals per row) against the
    reference's XLA verify, whose window stays out of the cache as the
    port's does: tokens and accepted counts exact, logprobs within 1e-4."""
    jcfg, cfg, jparams, params, kc, vc, rng = _fp8_model(0)
    T, hist, valid = 16, 8, 11
    table = rng.permutation(np.arange(1, N_BLOCKS))[:8].astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    jl, jk, jv = jllama.prefill(jparams, jcfg, *_j(tokens, table), jnp.int32(hist),
                                jnp.int32(valid), *_j(kc, vc), use_pallas=False)
    tk, tv = _t(kc, vc)
    tl, tk2, _ = llama.prefill(params, cfg, *_t(tokens, table), hist, valid, tk, tv)
    assert tk2 is tk and tk.dtype == FP8
    _close(tl, jl, rtol=1e-4, atol=1e-4)
    assert int(tl.argmax()) == int(jnp.argmax(jl))
    pos = np.arange(hist, hist + valid)
    slots = list(zip(table[pos // BS], pos % BS))
    _slots_equal(tk, jk, slots)
    _slots_equal(tv, jv, slots)

    B, M = 2, 6
    tables = rng.permutation(np.arange(1, N_BLOCKS))[: B * M].reshape(B, M)
    tables = tables.astype(np.int32)
    window = rng.integers(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    vpos, vlens = np.asarray([4, 17], np.int32), np.asarray([5, 18], np.int32)
    z = _greedy(B)
    chain = llama.decode_window(
        params, cfg, *_t(window[:, 0], vpos, tables, vlens), [0] * B, [0] * B,
        *_t(*z[2:]), *_t(kc, vc), n_steps=3)[0]
    window[1, 1:] = chain.numpy()[:, 1]  # the second row's proposals accept
    common = (window, window[:, 1:].copy(), vpos, tables, vlens)
    jout = jllama.verify_window(
        jparams, jcfg, *_j(*common, [0, 0], [0, 0], z[2], z[3], z[4], kc, vc),
        n_spec=3, with_logprobs=True)
    tout = llama.verify_window(params, cfg, *_t(*common), [0, 0], [0, 0],
                               *_t(*z[2:]), *_t(kc, vc), n_spec=3,
                               with_logprobs=True)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    assert int(tout[1][1]) == 3
    for got, want in zip(tout[4], jout[4]):
        _close(got, want, rtol=1e-4, atol=1e-4)


def test_decode_and_mixed_step_over_fp8_match_the_reference_paths():
    """The merged decode window (3 steps, an inactive slot) against the
    reference's kernel path (Pallas in interpret mode), which attends the
    new token at full width and appends it cast, as the port does: tokens
    exact, logits within 1e-4, every written slot byte-equal; the per-part
    mixed step (2 decode rows + a live and a dead segment) part by part
    against the reference path of the same meaning. The
    reference's XLA decode writes the new token first and reads it back
    from its fp8 page: on this input its logits part from both by more than
    1e-2 and its first row's greedy tokens differ (ROADMAP C.18)."""
    jcfg, cfg, jparams, params, kc, vc, rng = _fp8_model(1)
    B, M, n = 3, 6, 3
    tables = rng.permutation(np.arange(1, N_BLOCKS))[: B * M].reshape(B, M)
    tables = tables.astype(np.int32)
    tables[2] = 0
    seq_lens = np.asarray([5, 13, 0], np.int32)
    positions = np.maximum(seq_lens - 1, 0).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    samp = _greedy(B)
    dec = (tokens, positions, tables, seq_lens)
    jt, jk, jv = jllama.decode_window(
        jparams, jcfg, *_j(*dec, *samp), *_j(kc, vc), n_steps=n,
        use_pallas=True, interpret=True)
    tt, tk, tv = llama.decode_window(
        params, cfg, *_t(*dec), [0] * B, [0] * B, *_t(*samp[2:]), *_t(kc, vc),
        n_steps=n)
    np.testing.assert_array_equal(tt.numpy()[:, :2], np.asarray(jt)[:, :2])
    slots = [(tables[b, p // BS], p % BS) for b in range(2)
             for p in range(seq_lens[b] - 1, seq_lens[b] - 1 + n)]
    _slots_equal(tk, jk, slots)
    _slots_equal(tv, jv, slots)

    logits = llama._decode_body(params, cfg, *_t(*dec), *_t(kc, vc))[0]
    for use_pallas in (True, False):
        jlogits = jax.jit(lambda p, *a, up=use_pallas: jllama._decode_body(
            p, jcfg, *a, use_pallas=up, interpret=True))(
            jparams, *_j(*dec), *_j(kc, vc))[0]
        gap = float(np.abs(_f(logits)[:2] - np.asarray(jlogits)[:2]).max())
        if use_pallas:
            assert gap < 1e-4, gap
        else:  # C.18: the new token read back from its fp8 page
            assert gap > 1e-2, gap
    jx = jllama.decode_window(
        jparams, jcfg, *_j(*dec, *samp), *_j(kc, vc), n_steps=n,
        use_pallas=False)[0]
    assert not np.array_equal(np.asarray(jx)[:, 0], tt.numpy()[:, 0])

    # the mixed step's per-part flavor: the live segment through prefill
    # (held to the reference's XLA mixed step, whose segment has prefill's
    # meaning), then the merged decode of the two rows (held to the
    # reference's kernel-path decode of the same rows: the reference's
    # per-part mixed step cannot run its kernels in interpret mode)
    d_tables = tables[:2]
    p_tables = np.zeros((2, M), np.int32)
    p_tables[0] = [p for p in range(1, N_BLOCKS) if p not in d_tables][:M]
    d_seq_lens = np.asarray([9, 20], np.int32)
    mdec = (rng.integers(0, cfg.vocab_size, 2).astype(np.int32), d_seq_lens - 1,
            d_tables, d_seq_lens)
    pre = (rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32), p_tables,
           np.asarray([4, 0], np.int32), np.asarray([12, 0], np.int32))
    _, jpl, jk, jv = jllama.mixed_step(
        jparams, jcfg, *_j(*mdec, *_greedy(2), *pre), *_j(kc, vc),
        use_pallas=False)
    jd, jdk, jdv = jllama.decode_window(
        jparams, jcfg, *_j(*mdec, *_greedy(2)), *_j(kc, vc), n_steps=1,
        use_pallas=True, interpret=True)
    tn, tpl, tk, tv = llama.mixed_step(
        params, cfg, *_t(*mdec), [0] * 2, [0] * 2, *_t(*_greedy(2)[2:]),
        *_t(*pre), *_t(kc, vc))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jd)[0])
    _close(tpl[0], np.asarray(jpl)[0], rtol=1e-4, atol=1e-4)
    assert int(tpl[0].argmax()) == int(jnp.argmax(jpl[0]))
    seg = [(p_tables[0][p // BS], p % BS) for p in range(4, 16)]
    _slots_equal(tk, jk, seg)
    _slots_equal(tv, jv, seg)
    rows = [(d_tables[b, (d_seq_lens[b] - 1) // BS], (d_seq_lens[b] - 1) % BS)
            for b in range(2)]
    _slots_equal(tk, jdk, rows)
    _slots_equal(tv, jdv, rows)


# ---------------- the engine ----------------

GEOMETRY = dict(num_blocks=64, block_size=4, max_batch_size=4, max_context=128,
                prefill_chunk=32, kv_cache_dtype="float8_e4m3")
#: four overlapping greedy requests: chunked prefill, mixed steps and
#: merged decode windows
PROMPTS = [(list(range(10, 80)), 10), (list(range(100, 145)), 8),
           (list(range(200, 213)), 7), (list(range(300, 340)), 5)]
#: logprob tolerance against the reference's XLA engine: its decode steps
#: read the new token back from its fp8 page (C.18), moving a later
#: logprob by up to ~4e-4 on tiny_mla; the prefill's first token agrees to
#: f32 rounding
LP_ATOL = 2e-3


@functools.lru_cache(maxsize=1)
def _tiny_mla():
    """(JAX config, JAX params, port config, port params) of tiny_mla in
    f32, drawn once (the reference's programs compile once per config)."""
    jcfg = JaxModelConfig.tiny_mla(dtype="float32")
    cfg = ModelConfig.tiny_mla(dtype="float32")
    tree = llama.init_params(cfg, torch.Generator().manual_seed(0))
    tree = jax.tree.map(lambda t: t.numpy(), tree)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, from_jax_params(tree, cfg)


async def _serve(engine, make_req, make_ctx, collect_fn):
    async def one(i, toks, n):
        await asyncio.sleep(0.002 * i)  # staggered arrivals
        outs = await collect_fn(engine.generate(make_ctx(make_req(toks, n))))
        return ([t for o in outs for t in o.token_ids],
                [e["logprob"] for o in outs for e in (o.logprobs or [])])

    try:
        return await asyncio.gather(
            *[one(i, toks, n) for i, (toks, n) in enumerate(PROMPTS)])
    finally:
        await engine.close()


def test_torch_engine_matches_jax_engine_on_tiny_mla_over_fp8(run):
    jcfg, jparams, cfg, params = _tiny_mla()
    jeng = JaxEngine(JaxEngineConfig(model=jcfg, **GEOMETRY), params=jparams)
    teng = TorchEngine(EngineConfig(model=cfg, **GEOMETRY), params=params,
                       device="cpu")
    assert teng.k_cache.dtype == FP8 and teng.v_cache.dtype == FP8
    assert teng.k_scales is None
    jm, tm = jeng.load_metrics(), teng.load_metrics()
    assert tm["hbm_kv_pool_bytes"] == jm["hbm_kv_pool_bytes"]
    assert teng._hbm_stats()["kv_pool"] == teng.k_cache.numel() + teng.v_cache.numel()
    assert tm["kv_block_bytes"] == jm["kv_block_bytes"] == (
        cfg.num_layers * BS * (cfg.kv_lora_rank + cfg.qk_rope_head_dim))
    ref = run(_serve(
        jeng, lambda t, n: JaxRequest(
            token_ids=t, stop_conditions=JaxStops(max_tokens=n),
            sampling_options=JaxSampling(temperature=0.0, logprobs=1)),
        JaxContext, jax_collect))
    got = run(_serve(
        teng, lambda t, n: PreprocessedRequest(
            token_ids=t, stop_conditions=StopConditions(max_tokens=n),
            sampling_options=SamplingOptions(temperature=0.0, logprobs=1)),
        Context, collect))
    assert [g[0] for g in got] == [r[0] for r in ref]
    assert [len(g[0]) for g in got] == [n for _, n in PROMPTS]
    for (_, lp), (_, jlp) in zip(got, ref):
        np.testing.assert_allclose(lp, jlp, rtol=0, atol=LP_ATOL)
    assert teng.stats["mixed_steps"] > 0 and teng.stats["prefill_chunks"] > 0
    assert teng.stats["decode_steps"] > teng.stats["decode_windows"] > 0


def test_host_tier_and_transfer_plane_over_mla_fp8_match_the_reference(run):
    """The reference serves MLA over fp8 pages with a host tier (any codec)
    and across the transfer plane, so the port does: a prompt churned out
    of a 24-page pool comes back from the host tier with the reference's
    tokens and hit blocks, per codec; a JAX prefill worker's fp8 latent
    pages land in the port's decode engine, whose stream equals the
    reference's aggregated one."""
    from dynamo_tpu import disagg as ref_disagg
    from dynamo_tpu_torch.disagg import (
        ConditionalDisaggRouter,
        DisaggConfig,
        DisaggEngine,
        KvTransferServer,
        PrefillQueue,
    )
    from dynamo_tpu_torch.runtime import DistributedRuntime

    jcfg, jparams, cfg, params = _tiny_mla()
    prompts = [list(range(10 + 40 * i, 50 + 40 * i)) for i in range(4)]

    async def churn(engine, req, ctx, collect_fn):
        out = []
        try:
            for i in (0, 1, 2, 3, 0):
                outs = await collect_fn(engine.generate(ctx(req(prompts[i]))))
                out.append([t for o in outs for t in o.token_ids])
                await asyncio.sleep(0.02)
            return out, engine.load_metrics()["offload_hit_blocks_total"]
        finally:
            await engine.close()

    def jreq(t, n=6):
        return JaxRequest(token_ids=t, stop_conditions=JaxStops(max_tokens=n),
                          sampling_options=JaxSampling(temperature=0.0))

    def treq(t, n=6):
        return PreprocessedRequest(token_ids=t,
                                   stop_conditions=StopConditions(max_tokens=n),
                                   sampling_options=SamplingOptions(temperature=0.0))

    tier = dict(GEOMETRY, num_blocks=24, max_batch_size=2, host_cache_blocks=32)
    for codec in ("none", "int8", "fp8"):
        kw = dict(tier, kv_quant=codec)
        want = run(churn(JaxEngine(JaxEngineConfig(model=jcfg, **kw),
                                   params=jparams), jreq, JaxContext, jax_collect))
        got = run(churn(TorchEngine(EngineConfig(model=cfg, **kw), params=params,
                                    device="cpu"), treq, Context, collect))
        assert got == want and got[1] > 0, codec
        assert got[0][-1] == got[0][0]

    async def remote():
        drt = await DistributedRuntime.from_settings()
        router = ConditionalDisaggRouter(drt, "dynamo", "tiny_mla",
                                         DisaggConfig(max_local_prefill_length=8))
        await router.start()
        pre = JaxEngine(JaxEngineConfig(model=jcfg, **GEOMETRY), params=jparams)
        worker = ref_disagg.PrefillWorker(
            pre, ref_disagg.PrefillQueue(drt.bus), layer_chunk=1, kv_ici=False)
        dec = TorchEngine(EngineConfig(model=cfg, **GEOMETRY), params=params,
                          device="cpu")
        transfer = KvTransferServer(host="127.0.0.1")
        await transfer.start()
        worker.start()
        eng = DisaggEngine(dec, router, PrefillQueue(drt.bus), transfer)
        agg = JaxEngine(JaxEngineConfig(model=jcfg, **GEOMETRY), params=jparams)
        try:
            outs = await asyncio.wait_for(
                collect(eng.generate(Context(treq(prompts[1], 8)))), 60)
            assert eng.stats["remote_prefills"] == 1
            assert eng.stats["streamed_deliveries"] == 1
            ref = await jax_collect(agg.generate(JaxContext(jreq(prompts[1], 8))))
            return ([t for o in outs for t in o.token_ids],
                    [t for o in ref for t in o.token_ids])
        finally:
            await worker.close()
            await transfer.close()
            await router.stop()
            for e in (dec, pre, agg):
                await e.close()
            await drt.shutdown()

    got, want = run(remote())
    assert got == want and len(got) == 8
