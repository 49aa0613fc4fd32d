"""The port's MLA + MoE slice against the JAX package, on the CPU.

Same inputs (numpy, from a seed) through the JAX function and its port:
the MLA plain twins against the JAX Pallas kernels in interpret mode (2e-5,
f32, stats included), the dense ``*_xla`` oracles and the YaRN rope
against JAX's, the merged decode with an empty-history row, the
widened KV append bit-exact at Dk != Dv, the MoE FFN against JAX's ragged
and dense dispatch, the tiny MLA + MoE model's prefill / merged decode
window / mixed step against the JAX forward (``use_pallas=False``; logits
to 1e-4, greedy tokens identical), ``TorchEngine`` against ``JaxEngine``,
``from_hf_config`` on DeepSeek-V2-Lite's published config, and seeded
sampling (threefry keys and draws) token for token.
"""

import asyncio
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import mla as jmodel_mla
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.ops import mla_attention_pallas as jmla
from dynamo_tpu.ops import sampling as jsamp
from dynamo_tpu.ops.kv_cache_update_pallas import kv_cache_append as jappend
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStops
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu.runtime import collect as jax_collect
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models import mla as tmodel_mla
from dynamo_tpu_torch.models.config import DEEPSEEK_V2_LITE_HF, ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops import mla_attention as tmla
from dynamo_tpu_torch.ops import sampling
from dynamo_tpu_torch.ops.kv_cache_update import kv_cache_append
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context, collect

BS, N_BLOCKS = 4, 40
# tiny MLA (q-lora) + MoE: one dense layer, then MoE with 8 experts top-2
# and one shared expert
MOE = dict(dtype="float32", num_layers=2, first_dense_layers=1,
           num_experts=8, num_experts_per_tok=2, num_shared_experts=1,
           moe_intermediate_size=32)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _close(a, b, tol=2e-5):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _latents(rng, B, M, C=32, R=8, H=4):
    N = B * M + 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    tables = np.arange(1, N, dtype=np.int32).reshape(B, M)
    return f(B, H, C), f(B, H, R), f(1, N, BS, C), f(1, N, BS, R), tables


# the reference kernels' widths: the tiny model's, and kv_lora_rank % 128
# == 0 beyond the three DeepSeek / MiniCPM3 ones (C.7)
WIDTHS = pytest.mark.parametrize("C,R", [(32, 8), (384, 16), (640, 64)],
                                 ids=["C32-R8", "C384-R16", "C640-R64"])


@WIDTHS
def test_mla_decode_twin_matches_pallas_interpret(C, R):
    rng = np.random.default_rng(0)
    q_eff, q_pe, cc, pc, tables = _latents(rng, 4, 4, C, R)
    lens = np.asarray([1, BS + 3, 0, 4 * BS], np.int32)  # ragged, one empty
    got = tmla.mla_paged_decode_attention(*_t(q_eff, q_pe, cc, pc, tables, lens),
                                          0.21, return_stats=True)
    ref = jmla.mla_paged_decode_attention(*_j(q_eff, q_pe, cc, pc, tables, lens),
                                          0.21, return_stats=True, interpret=True)
    for a, b in zip(got, ref):
        _close(a, b)
    assert float(got[0][2].abs().max()) == 0.0 and float(got[2][2].max()) == 0.0
    assert bool((got[1][2] == -1e30).all())


@WIDTHS
@pytest.mark.parametrize("valid", [None, 9])
def test_mla_prefill_twin_matches_pallas_interpret(valid, C, R):
    rng = np.random.default_rng(1)
    q_eff, q_pe, cc, pc, tables = _latents(rng, 16, 6, C, R)
    table, hist = tables[3], 5
    got = tmla.mla_paged_prefill_attention(
        *_t(q_eff, q_pe, cc, pc, table), hist, 0.3, valid_len=valid)
    ref = jmla.mla_paged_prefill_attention(
        *_j(q_eff, q_pe, cc, pc, table), jnp.int32(hist), 0.3, interpret=True)
    assert got.dtype == torch.float32
    n = 16 if valid is None else valid
    _close(got[:n], np.asarray(ref)[:n])
    if valid is not None:  # the port's addition: padded rows come out zero
        assert float(got[valid:].abs().max()) == 0.0


def test_mla_decode_attention_merged_matches_jax():
    rng = np.random.default_rng(2)
    q_eff, q_pe, cc, pc, tables = _latents(rng, 3, 4)
    c_new = rng.standard_normal((3, 32)).astype(np.float32)
    pe_new = rng.standard_normal((3, 8)).astype(np.float32)
    hist = np.asarray([0, 5, 2 * BS + 1], np.int32)  # hist 0: out == c_new
    args = (q_eff, q_pe, c_new, pe_new, cc, pc, tables, hist)
    got = tmla.mla_decode_attention_merged(*_t(*args), 0.17)
    ref = jmla.mla_decode_attention_merged(*_j(*args), 0.17, interpret=True)
    _close(got, ref)
    _close(got[0], np.broadcast_to(c_new[0], (4, 32)))


def test_mla_yarn_rope_matches_jax():
    """DeepSeek-V2-Lite's YaRN (factor 40, mscale ratio) frequencies and
    the half-split rotation of the rope dims."""
    cfg = ModelConfig.from_hf_config(DEEPSEEK_V2_LITE_HF)
    jcfg = JaxModelConfig.from_hf_config(DEEPSEEK_V2_LITE_HF)
    inv, msc = tmodel_mla.mla_rope_freqs(cfg)
    jinv, jmsc = jmodel_mla.mla_rope_freqs(jcfg)
    _close(inv, jinv, 1e-7)
    assert msc == jmsc
    D = cfg.qk_rope_head_dim  # the lowest frequency is interpolated by 40
    assert float(inv[-1]) == pytest.approx(cfg.rope_theta ** (-(D - 2) / D) / 40,
                                           rel=1e-6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, cfg.qk_rope_head_dim)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    _close(tmodel_mla.rope_rotate(*_t(x, pos), inv, msc),
           jmodel_mla.rope_rotate(*_j(x, pos), jinv, jmsc))


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_mla_xla_oracles_match_jax_and_the_twins(kind):
    """The dense ``*_xla`` oracles against JAX's, and the kernels' plain
    twins against them on the rows that attend something."""
    rng = np.random.default_rng(8)
    q_eff, q_pe, cc, pc, tables = _latents(rng, 5, 5)
    if kind == "decode":
        lens = np.asarray([1, BS + 3, 7, 2 * BS, 5 * BS], np.int32)
        args = (q_eff, q_pe, cc, pc, tables, lens)
        got = tmodel_mla.mla_decode_attention_xla(*_t(*args), 0.19)
        twin = tmla.mla_paged_decode_attention_plain(*_t(*args), 0.19)
        ref = jmodel_mla.mla_decode_attention_xla(*_j(*args), 0.19)
        n = 5
    else:
        table, hist, n = tables[2], 6, 3
        got = tmodel_mla.mla_prefill_attention_xla(
            *_t(q_eff, q_pe, cc, pc, table), hist, n, 0.19)
        twin = tmla.mla_paged_prefill_attention_plain(
            *_t(q_eff, q_pe, cc, pc, table), hist, 0.19, valid_len=n)
        ref = jmodel_mla.mla_prefill_attention_xla(
            *_j(q_eff, q_pe, cc, pc, table), jnp.int32(hist), jnp.int32(n), 0.19)
    _close(got, ref)
    _close(twin[:n], got[:n])


def test_kv_cache_append_widened_bit_exact_vs_pallas():
    """MLA widths: the k cache takes c_kv [L, B, 1, C], the v cache k_pe
    [L, B, 1, R]."""
    rng = np.random.default_rng(3)
    L, B, C, R, N = 3, 4, 32, 8, 9
    c_new = rng.standard_normal((L, B, 1, C)).astype(np.float32)
    pe_new = rng.standard_normal((L, B, 1, R)).astype(np.float32)
    kc = rng.standard_normal((L, 1, N, BS, C)).astype(np.float32)
    vc = rng.standard_normal((L, 1, N, BS, R)).astype(np.float32)
    blk = np.asarray([2, 5, 7, 0], np.int32)
    off = np.asarray([0, 3, 1, 2], np.int32)
    tk, tv = _t(kc.copy(), vc.copy())
    kv_cache_append(*_t(c_new, pe_new), tk, tv, *_t(blk, off))
    jk, jv = jappend(*_j(c_new, pe_new, kc, vc, blk, off), interpret=True)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# DeepSeek-V3-style routing: sigmoid scores, gate bias, group-limited top-k
V3_ROUTING = dict(moe_scoring="sigmoid", moe_gate_bias=True, n_group=4,
                  topk_group=2, moe_group_score="top2",
                  routed_scaling_factor=2.5)


@pytest.mark.parametrize("routing", [{}, V3_ROUTING], ids=["v2", "v3"])
def test_moe_ffn_matches_jax_ragged_and_dense(routing):
    jcfg = JaxModelConfig.tiny(**MOE, **routing)
    cfg = ModelConfig.tiny(**MOE, **routing)
    rng = np.random.default_rng(4)
    E, X, Fm = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    shapes = dict(moe_gate=(E, X), we_gate=(X, E, Fm), we_up=(X, E, Fm),
                  we_down=(X, Fm, E), shared_gate=(E, Fm), shared_up=(E, Fm),
                  shared_down=(Fm, E))
    lp = {k: (rng.standard_normal(v) * 0.2).astype(np.float32)
          for k, v in shapes.items()}
    if routing:
        lp["moe_gate_bias"] = (rng.standard_normal(X) * 0.1).astype(np.float32)
    x = rng.standard_normal((13, E)).astype(np.float32)
    tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
    got = llama.moe_ffn(tlp, cfg, torch.from_numpy(x))
    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    for ref in (jllama.moe_ffn, jllama.moe_ffn_dense):
        _close(got, jax.jit(functools.partial(ref, cfg=jcfg))(jlp, x=jnp.asarray(x)),
               1e-5)
    _close(llama.moe_ffn_dense(tlp, cfg, torch.from_numpy(x)), got, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_combine_fixed_order_matches_jax(dtype):
    """The combine adds each token's k weighted expert rows one at a time
    in the expert-sorted order, as the reference's ``.at[t_sorted].add``
    does: bit-equal to JAX's ``_moe_combine`` in f32 and in bf16 (the same
    adds in the same order), and twice the same bits. ``moe_ffn`` against
    JAX's: f32 within 1e-5; bf16 within 2**-6 of the largest |output|
    (two bf16 steps at that magnitude: the products round in bf16 and
    their sums run in another order)."""
    rng = np.random.default_rng(11)
    T, k, D, X = 13, 3, 40, 8
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    idx = np.stack([rng.choice(X, k, replace=False) for _ in range(T)])
    t_sorted = np.argsort(idx.reshape(-1), kind="stable") // k
    o = rng.standard_normal((T * k, D)).astype(np.float32)
    w = rng.random(T * k).astype(np.float32)
    args = (torch.from_numpy(o).to(tdt), torch.from_numpy(t_sorted),
            torch.from_numpy(w), T, tdt)
    got = llama._moe_combine(*args)
    ref = jllama._moe_combine(jnp.asarray(o, jdt), jnp.asarray(t_sorted),
                              jnp.asarray(w), T, jdt)
    assert got.dtype == tdt and torch.equal(got, llama._moe_combine(*args))
    np.testing.assert_array_equal(_np(got), _np(ref))
    jcfg = JaxModelConfig.tiny(**{**MOE, "dtype": dtype})
    cfg = ModelConfig.tiny(**{**MOE, "dtype": dtype})
    E, Fm = cfg.hidden_size, cfg.moe_intermediate_size
    shapes = dict(moe_gate=(E, X), we_gate=(X, E, Fm), we_up=(X, E, Fm),
                  we_down=(X, Fm, E), shared_gate=(E, Fm), shared_up=(E, Fm),
                  shared_down=(Fm, E))
    lp = {n: (rng.standard_normal(v) * 0.2).astype(np.float32)
          for n, v in shapes.items()}
    x = rng.standard_normal((T, E)).astype(np.float32)
    tlp = {n: torch.from_numpy(v).to(tdt) for n, v in lp.items()}
    got = llama.moe_ffn(tlp, cfg, torch.from_numpy(x).to(tdt))
    jref = jax.jit(functools.partial(jllama.moe_ffn, cfg=jcfg))(
        {n: jnp.asarray(v, jdt) for n, v in lp.items()}, x=jnp.asarray(x, jdt))
    if dtype == "float32":
        _close(got, jref, 1e-5)
    else:
        top = float(np.abs(_np(jref)).max())
        np.testing.assert_allclose(_np(got), _np(jref), rtol=0, atol=top * 2**-6)


@functools.lru_cache(maxsize=1)
def _weights():
    """One tiny MLA + MoE model for the forward tests, drawn once as numpy
    in the JAX package's tree (neither side mutates its parameters)."""
    jcfg = JaxModelConfig.tiny_mla(**MOE)
    cfg = ModelConfig.tiny_mla(**MOE)
    tree = llama.init_params(cfg, torch.Generator().manual_seed(0))
    tree = jax.tree.map(lambda t: t.numpy() * (5.0 if t.dim() > 1 else 1.0), tree)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            from_jax_params(tree, cfg))


def _model(seed):
    rng = np.random.default_rng(seed)
    cfg = _weights()[1]
    ks, vs = llama.kv_cache_shapes(cfg, N_BLOCKS, BS)
    kc = rng.standard_normal(ks).astype(np.float32) * 0.5
    vc = rng.standard_normal(vs).astype(np.float32) * 0.5
    return (*_weights(), kc, vc, rng)


def _caches(kc, vc):
    return (jnp.asarray(kc), jnp.asarray(vc)), _t(kc.copy(), vc.copy())


def test_mla_moe_prefill_matches_jax():
    jcfg, cfg, jparams, params, kc, vc, rng = _model(0)
    assert "dense_layers" in params and "we_gate" in params["layers"]
    T, hist, valid = 16, 8, 11
    table = np.asarray(rng.permutation(np.arange(1, N_BLOCKS))[:8], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    (jk, jv), (tk, tv) = _caches(kc, vc)
    jl, jk, jv = jllama.prefill(jparams, jcfg, *_j(tokens, table), jnp.int32(hist),
                                jnp.int32(valid), jk, jv, use_pallas=False)
    tl, tk, tv = llama.prefill(params, cfg, *_t(tokens, table), hist, valid, tk, tv)
    _close(tl, jl, 1e-4)
    assert int(torch.argmax(tl)) == int(jnp.argmax(jl))
    pos = np.arange(hist, hist + valid)  # the real rows' latents landed alike
    slots = (slice(None), 0, table[pos // BS], pos % BS)
    _close(_np(tk)[slots], _np(jk)[slots], 1e-4)
    _close(_np(tv)[slots], _np(jv)[slots], 1e-4)


def _greedy_args(B):
    z_f, z_i = np.zeros(B, np.float32), np.zeros(B, np.int32)
    return z_i, z_i, z_f, z_i, np.ones(B, np.float32)


def test_mla_moe_merged_decode_window_matches_jax():
    jcfg, cfg, jparams, params, kc, vc, rng = _model(1)
    B, M, n = 3, 6, 3
    tables = np.asarray(
        rng.permutation(np.arange(1, N_BLOCKS))[: B * M].reshape(B, M), np.int32)
    tables[2] = 0  # inactive slot
    seq_lens = np.asarray([5, 13, 0], np.int32)
    positions = np.maximum(seq_lens - 1, 0).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    seeds, steps, temps, top_ks, top_ps = _greedy_args(B)
    (jk, jv), (tk, tv) = _caches(kc, vc)
    jtoks, jk, jv = jllama.decode_window(
        jparams, jcfg, *_j(tokens, positions, tables, seq_lens, seeds, steps,
                           temps, top_ks, top_ps),
        jk, jv, n_steps=n, use_pallas=False)
    ttoks, tk, tv = llama.decode_window(
        params, cfg, *_t(tokens, positions, tables, seq_lens), [0] * B, [0] * B,
        *_t(temps, top_ks, top_ps), tk, tv, n_steps=n)
    np.testing.assert_array_equal(ttoks.numpy()[:, :2], np.asarray(jtoks)[:, :2])
    # every written slot agrees (page 0 is trash: inactive rows land there)
    _close(_np(tk)[:, :, 1:], _np(jk)[:, :, 1:], 1e-4)
    _close(_np(tv)[:, :, 1:], _np(jv)[:, :, 1:], 1e-4)
    # one step's logits against the JAX decode body
    logits, _, _ = llama._decode_body(
        params, cfg, *_t(tokens, positions, tables, seq_lens),
        *_t(kc.copy(), vc.copy()))
    jlogits, _, _ = jax.jit(lambda p, *a: jllama._decode_body(
        p, jcfg, *a, use_pallas=False))(
        jparams, *_j(tokens, positions, tables, seq_lens, kc, vc))
    _close(logits[:2], np.asarray(jlogits)[:2], 1e-4)


def test_mla_moe_mixed_step_matches_jax():
    jcfg, cfg, jparams, params, kc, vc, rng = _model(2)
    B, M, MP, T = 2, 8, 2, 16
    pages = rng.permutation(np.arange(1, N_BLOCKS))
    d_tables = np.asarray(pages[: B * M].reshape(B, M), np.int32)
    p_tables = np.zeros((MP, M), np.int32)
    p_tables[0] = pages[B * M: (B + 1) * M]  # segment 1 is dead
    d_seq_lens = np.asarray([9, 20], np.int32)
    dec = (rng.integers(0, cfg.vocab_size, B).astype(np.int32),
           d_seq_lens - 1, d_tables, d_seq_lens)
    pre = (rng.integers(0, cfg.vocab_size, (MP, T)).astype(np.int32), p_tables,
           np.asarray([4, 0], np.int32), np.asarray([12, 0], np.int32))
    samp = _greedy_args(B)
    (jk, jv), (tk, tv) = _caches(kc, vc)
    jn, jpl, jk, jv = jllama.mixed_step(jparams, jcfg, *_j(*dec, *samp, *pre),
                                        jk, jv, use_pallas=False)
    tn, tpl, tk, tv = llama.mixed_step(params, cfg, *_t(*dec), [0] * B, [0] * B,
                                       *_t(*samp[2:]), *_t(*pre), tk, tv)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _close(tpl[0], np.asarray(jpl)[0], 1e-4)
    assert int(torch.argmax(tpl[0])) == int(jnp.argmax(jpl[0]))
    # the decode tokens' and the live segment's real rows landed alike
    pos = np.arange(4, 16)
    d_pos = d_seq_lens - 1
    blk = np.concatenate([d_tables[np.arange(B), d_pos // BS], p_tables[0][pos // BS]])
    off = np.concatenate([d_pos % BS, pos % BS])
    for t, j in ((tk, jk), (tv, jv)):
        _close(_np(t)[:, 0, blk, off], _np(j)[:, 0, blk, off], 1e-4)


# four overlapping greedy requests (the tests/test_torch_engine.py
# geometry): chunked prefill, mixed steps, merged decode windows
GEOMETRY = dict(num_blocks=64, block_size=4, max_batch_size=4,
                max_context=128, prefill_chunk=32)
PROMPTS = [(list(range(10, 80)), 10), (list(range(100, 145)), 8),
           (list(range(200, 213)), 7), (list(range(300, 340)), 5)]


async def _serve(engine, make_req, make_ctx, collect_fn):
    async def one(i, toks, n):
        await asyncio.sleep(0.002 * i)  # staggered arrivals
        outs = await collect_fn(engine.generate(make_ctx(make_req(toks, n))))
        return [t for o in outs for t in o.token_ids]

    try:
        return await asyncio.gather(
            *[one(i, toks, n) for i, (toks, n) in enumerate(PROMPTS)])
    finally:
        await engine.close()


def test_torch_engine_matches_jax_engine_on_mla_moe(run):
    jcfg, cfg, jparams, params = _weights()
    jeng = JaxEngine(JaxEngineConfig(model=jcfg, **GEOMETRY), params=jparams)
    teng = TorchEngine(EngineConfig(model=cfg, **GEOMETRY), params=params,
                       device="cpu")
    ref = run(_serve(
        jeng, lambda t, n: JaxRequest(
            token_ids=t, stop_conditions=JaxStops(max_tokens=n),
            sampling_options=JaxSampling(temperature=0.0)),
        JaxContext, jax_collect))
    got = run(_serve(
        teng, lambda t, n: PreprocessedRequest(
            token_ids=t, stop_conditions=StopConditions(max_tokens=n),
            sampling_options=SamplingOptions(temperature=0.0)),
        Context, collect))
    assert [len(g) for g in got] == [n for _, n in PROMPTS]
    assert got == ref
    assert teng.stats["mixed_steps"] > 0 and teng.stats["prefill_chunks"] > 0
    assert teng.stats["decode_steps"] > teng.stats["decode_windows"] > 0
    assert teng.k_cache.shape[-1] == cfg.kv_lora_rank
    assert teng.v_cache.shape[-1] == cfg.qk_rope_head_dim


@pytest.mark.parametrize("widths", [{}], ids=["tiny"])
def test_torch_engine_refuses_mla_widths_the_kernel_lacks(monkeypatch, widths):
    """On the card the latent kernels run or nothing does: the JAX
    engine's kv_lora_rank % 128 gate raises instead of falling back (the
    tiny model's C = 32)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="latent kernel"):
        TorchEngine(EngineConfig(model=ModelConfig.tiny_mla(**{**MOE, **widths}),
                                 **GEOMETRY), device="cuda")


def test_torch_engine_takes_minicpm3_latent_widths_on_the_card(monkeypatch):
    """MiniCPM3-4B's latent widths (kv_lora_rank 256, qk_rope_head_dim 32)
    pass the card's gate: a CPU build stops only at the card allocation."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = ModelConfig.tiny_mla(**{**MOE, "kv_lora_rank": 256, "qk_rope_head_dim": 32})
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(EngineConfig(model=cfg, **GEOMETRY), device="cuda")


@pytest.mark.parametrize("widths", [dict(kv_lora_rank=384, qk_rope_head_dim=64),
                                    dict(kv_lora_rank=640, qk_rope_head_dim=64),
                                    dict(kv_lora_rank=256, qk_rope_head_dim=16),
                                    dict(kv_lora_rank=768, qk_rope_head_dim=64),
                                    dict(kv_lora_rank=256, qk_rope_head_dim=160),
                                    dict(kv_lora_rank=1024, qk_rope_head_dim=64)],
                         ids=["C=384", "C=640", "R=16", "C=768", "R=160", "C=1024"])
def test_torch_engine_takes_every_c128_latent_width_on_the_card(monkeypatch, widths):
    """C.7, C.8: every kv_lora_rank % 128 == 0 with any rope width passes
    the card's gate (the reference engine's): the tensor-core body's widths
    (C = 384, 640; R = 16) and the wider ones the CUDA-core body takes
    (C = 768, 1024; R = 160). A CPU build stops only at the card
    allocation."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = ModelConfig.tiny_mla(**{**MOE, **widths})
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(EngineConfig(model=cfg, **GEOMETRY), device="cuda")


def test_from_hf_config_matches_jax_on_deepseek_v2_lite():
    got = ModelConfig.from_hf_config(DEEPSEEK_V2_LITE_HF)
    ref = JaxModelConfig.from_hf_config(DEEPSEEK_V2_LITE_HF)
    fields = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(got)] == fields
    assert {f: getattr(got, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    assert (got.num_layers, got.num_experts, got.kv_lora_rank) == (27, 64, 512)
    assert got.mla_softmax_scale() == ref.mla_softmax_scale()


def test_threefry_keys_and_seeded_draws_match_jax():
    seeds = [0, 1, 7, 12345, 2**31 - 1] * 4
    steps = [0] * 5 + [1] * 5 + [31] * 5 + [100000] * 5
    keys = sampling.make_keys(seeds, steps)
    jkeys = jsamp.make_keys(*_j(np.asarray(seeds, np.int32), np.asarray(steps, np.int32)))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))
    rng = np.random.default_rng(6)
    B, V = 5, 300
    temps = np.asarray([0.7, 1.0, 0.0, 1.3, 0.5], np.float32)  # one greedy row
    tk = np.asarray([0, 5, 0, 40, 0], np.int32)
    tp = np.asarray([1.0, 1.0, 0.9, 0.8, 1.0], np.float32)
    for draw in range(8):
        logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
        s, st = [draw * 11 + b for b in range(B)], [draw] * B
        got = sampling.sample_tokens(*_t(logits), sampling.make_keys(s, st),
                                     *_t(temps, tk, tp))
        ref = jsamp.sample_tokens(
            *_j(logits), jsamp.make_keys(*_j(np.asarray(s, np.int32),
                                             np.asarray(st, np.int32))),
            *_j(temps, tk, tp))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
