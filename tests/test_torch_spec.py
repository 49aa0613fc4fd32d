"""The port's speculative (prompt-lookup) decoding path against the JAX
package, on the CPU.

Same inputs (numpy, from a seed) and weights (``from_jax_params``) through
the JAX function and its port, f32:

* ``kv_cache_append_tokens_plain`` (the CUDA kernel's oracle) against JAX's
  ``kv_cache_append_tokens(interpret=True)``, bit-exact, at GQA widths and
  at MLA's Dk != Dv, with windows that cross a page boundary, one that
  starts a page, one of T = bs rows, and padded rows on the trash page 0
  (excluded from the comparison: their writes race there);
* ``speculative_accept``: out_tokens and n_acc exact for greedy rows,
  seeded sampled rows with top-k / top-p, and -1 proposals, with and
  without the all-greedy shortcut;
* ``mla_verify_attention`` (the kernel's plain twin for the history) and
  ``mla_verify_attention_xla`` against JAX's Pallas (interpret) and XLA
  branches, 2e-5;
* ``verify_window`` for a dense GQA, an MLA + MoE and a dense int8-weight
  model, with penalties and logprobs: tokens and n_acc exact, logprobs and
  the forward's logits to 1e-4, the caches after the append to 2e-5;
* ``TorchEngine`` with ``spec_gamma=3`` against ``spec_gamma=0`` and
  against ``JaxEngine(spec_gamma=3)`` on the reference's repetitive prompt:
  identical greedy streams, the spec counters equal to JaxEngine's, fewer
  decode steps than plain decode; the int8-KV gate, the decode_window < 2
  error, the kernel's row limit and the launcher's flags.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.ops import mla_attention_pallas as jmla
from dynamo_tpu.ops import sampling as jsamp
from dynamo_tpu.ops.kv_cache_update_pallas import (
    kv_cache_append_tokens as j_append_tokens,
)
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStops
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu.runtime import collect as jax_collect
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import llama, quant
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops import kv_cache_update as kvu
from dynamo_tpu_torch.ops import mla_attention as tmla
from dynamo_tpu_torch.ops import sampling
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context, collect

BS, N_BLOCKS = 4, 40
# tiny MLA (q-lora) + MoE: one dense layer, then MoE with 8 experts top-2
# and one shared expert (the tests/test_torch_mla.py model)
MOE = dict(dtype="float32", num_layers=2, first_dense_layers=1,
           num_experts=8, num_experts_per_tok=2, num_shared_experts=1,
           moe_intermediate_size=32)


def _t(*xs):
    """Torch copies (the port updates caches and counts in place)."""
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a).astype(np.float32),
                               _np(b).astype(np.float32), rtol=tol, atol=tol)


# ---------------- kv_cache_append_tokens ----------------


@pytest.mark.parametrize("widths", [(2, 8, 8), (1, 32, 8)],
                         ids=["gqa", "mla_dk_ne_dv"])
@pytest.mark.parametrize("T", [3, BS], ids=["T3", "T_eq_bs"])
def test_kv_cache_append_tokens_plain_bit_exact_vs_jax(widths, T):
    """The plain twin (the CUDA kernel's oracle) against JAX's append:
    sequence 0 crosses a page boundary, sequence 1 starts at row 0 of a
    page, sequence 2 is padded (all rows on page 0, excluded: its writes
    race there). Bit-exact."""
    Hkv, Dk, Dv = widths
    rng = np.random.default_rng(T)
    L, B, N = 2, 3, 12
    kc = rng.standard_normal((L, Hkv, N, BS, Dk)).astype(np.float32)
    vc = rng.standard_normal((L, Hkv, N, BS, Dv)).astype(np.float32)
    k_new = rng.standard_normal((L, B, T, Hkv, Dk)).astype(np.float32)
    v_new = rng.standard_normal((L, B, T, Hkv, Dv)).astype(np.float32)
    tables = np.asarray([[3, 7, 9], [5, 2, 11], [0, 0, 0]], np.int32)
    starts = np.asarray([BS - 1, BS, 0])  # crossing, page start, padded
    pos = starts[:, None] + np.arange(T)[None, :]
    blk = np.take_along_axis(tables, pos // BS, axis=1).astype(np.int32)
    off = (pos % BS).astype(np.int32)
    jk, jv = j_append_tokens(*_j(k_new, v_new, kc, vc, blk, off), interpret=True)
    tk, tv = _t(kc, vc)
    out = kvu.kv_cache_append_tokens(*_t(k_new, v_new), tk, tv, *_t(blk, off))
    assert out[0] is tk and out[1] is tv  # updated in place
    np.testing.assert_array_equal(tk.numpy()[:, :, 1:], np.asarray(jk)[:, :, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, :, 1:], np.asarray(jv)[:, :, 1:])
    # the T = 1 case is the one-token append, bit for bit
    tk1, tv1 = _t(kc, vc)
    kvu.kv_cache_append(*_t(k_new[:, :, 0], v_new[:, :, 0]), tk1, tv1,
                        *_t(blk[:, 0], off[:, 0]))
    tk2, tv2 = _t(kc, vc)
    kvu.kv_cache_append_tokens(*_t(k_new[:, :, :1], v_new[:, :, :1]), tk2, tv2,
                               *_t(blk[:, :1], off[:, :1]))
    assert torch.equal(tk1, tk2) and torch.equal(tv1, tv2)


def test_kv_cache_append_tokens_refuses_windows_past_a_page():
    L, B, T, Hkv, D = 1, 1, BS + 1, 1, 8
    kc = torch.zeros(L, Hkv, 4, BS, D)
    new = torch.zeros(L, B, T, Hkv, D)
    idx = torch.zeros(B, T, dtype=torch.int32)
    with pytest.raises(ValueError, match="must fit a page"):
        kvu.kv_cache_append_tokens(new, new, kc, kc.clone(), idx, idx)


# ---------------- speculative_accept ----------------


def _accept_inputs(rng, B, T, V):
    """Logits with a clear winner at every position (so greedy proposals
    that follow the argmax chain are accepted), the argmax chain as the
    proposals, and every row's own twist: row 0 all-argmax, row 1 a miss
    at t=1, row 2 no proposals beyond t=0 (-1), rows 3-5 sampled (plain,
    top-k, top-p), row 5 with random proposals."""
    g = T - 1
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2.0
    win = rng.integers(0, V, (B, T))
    logits[np.arange(B)[:, None], np.arange(T)[None, :], win] += 12.0
    props = win[:, :g].astype(np.int32).copy()
    props[1, 1] = (props[1, 1] + 1) % V
    props[2, 1:] = -1
    props[5] = rng.integers(0, V, g)
    temps = np.asarray([0, 0, 0, 0.9, 0.7, 1.3], np.float32)[:B]
    top_ks = np.asarray([0, 0, 0, 0, 5, 0], np.int32)[:B]
    top_ps = np.asarray([1, 1, 1, 1, 1, 0.8], np.float32)[:B]
    return logits, props, temps, top_ks, top_ps


_j_accept = jax.jit(jsamp.speculative_accept)


@pytest.mark.parametrize("sampled", [True, False], ids=["mixed", "all_greedy"])
def test_speculative_accept_matches_jax(sampled):
    """Greedy rows accept the argmax chain; sampled rows accept draws from
    the seed ^ 0x5EC stream and correct from the residual on the plain
    stream: out_tokens and n_acc equal JAX's token for token over many
    seeds (the all-greedy batch takes the port's no-keys shortcut)."""
    rng = np.random.default_rng(3)
    B, T, V = 6, 4, 48
    g = T - 1
    for trial in range(3):
        logits, props, temps, top_ks, top_ps = _accept_inputs(rng, B, T, V)
        if not sampled:
            temps[:] = 0.0
        seeds = rng.integers(0, 2**31 - 1, B).tolist()
        steps = rng.integers(0, 1000, B).tolist()
        ka = jnp.stack([jsamp.make_keys(jnp.asarray(seeds, jnp.int32) ^ 0x5EC,
                                        jnp.asarray(steps, jnp.int32) + t)
                        for t in range(g)], axis=1)
        ks = jnp.stack([jsamp.make_keys(jnp.asarray(seeds, jnp.int32),
                                        jnp.asarray(steps, jnp.int32) + t)
                        for t in range(T)], axis=1)
        jout, jn = _j_accept(*_j(logits, props), ka, ks,
                             *_j(temps, top_ks, top_ps))
        tka = tks = None
        if sampled:
            tka = torch.stack([sampling.make_keys([s ^ 0x5EC for s in seeds],
                                                  [s + t for s in steps])
                               for t in range(g)], dim=1)
            tks = torch.stack([sampling.make_keys(seeds, [s + t for s in steps])
                               for t in range(T)], dim=1)
        tout, tn = sampling.speculative_accept(*_t(logits, props), tka, tks,
                                               *_t(temps, top_ks, top_ps))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn), err_msg=trial)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout),
                                      err_msg=trial)
        assert tn[0] == g and tn[1] == 1 and tn[2] == 1  # the greedy rows


# ---------------- mla_verify_attention ----------------


@pytest.mark.parametrize("branch", ["pallas", "xla"])
def test_mla_verify_attention_matches_jax(branch):
    """T=3 in-flight tokens over paged latent history (one row with no
    history, one crossing pages): the port's kernel path (plain twin on the
    CPU) and its XLA twin against the JAX Pallas (interpret) and XLA
    branches, 2e-5 (f32, sums in another order)."""
    rng = np.random.default_rng(5)
    B, T, H, C, R, M = 3, 3, 4, 32, 8, 5
    N = B * M + 1
    cc = rng.standard_normal((1, N, BS, C)).astype(np.float32)
    pc = rng.standard_normal((1, N, BS, R)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N))[: B * M].reshape(B, M).astype(np.int32)
    hist = np.asarray([0, 7, 13], np.int32)
    q_eff = rng.standard_normal((B, T, H, C)).astype(np.float32)
    q_pe = rng.standard_normal((B, T, H, R)).astype(np.float32)
    c_win = rng.standard_normal((B, T, C)).astype(np.float32)
    pe_win = rng.standard_normal((B, T, R)).astype(np.float32)
    scale = 0.11
    args = (q_eff, q_pe, c_win, pe_win, cc, pc, tables, hist)
    ref = jmla.mla_verify_attention(*_j(*args), scale,
                                    use_pallas=branch == "pallas", interpret=True)
    fn = tmla.mla_verify_attention if branch == "pallas" else tmla.mla_verify_attention_xla
    got = fn(*_t(*args), scale)
    assert got.dtype == torch.float32 and got.shape == (B, T, H, C)
    _close(got, ref, 2e-5)


# ---------------- verify_window ----------------


def _models():
    """(label, JAX config, port config, JAX params, port params): a dense
    GQA, an MLA + MoE (weights x5: decisive logits and routing), and the
    dense one with int8 weights."""
    out = []
    for label, jcfg, cfg, mode in (
        ("dense", JaxModelConfig.tiny(dtype="float32"),
         ModelConfig.tiny(dtype="float32"), "none"),
        ("mla_moe", JaxModelConfig.tiny_mla(**MOE), ModelConfig.tiny_mla(**MOE),
         "none"),
        ("dense_int8", JaxModelConfig.tiny(dtype="float32"),
         ModelConfig.tiny(dtype="float32"), "int8"),
    ):
        tree = llama.init_params(cfg, torch.Generator().manual_seed(0))
        tree = {k: ({kk: vv * 5.0 if vv.dim() > 1 else vv for kk, vv in v.items()}
                    if isinstance(v, dict) else (v * 5.0 if v.dim() > 1 else v))
                for k, v in tree.items()}
        tree = quant.quantize_params(tree, cfg, mode)
        ntree = jax.tree.map(lambda t: t.numpy(), tree)
        out.append((label, jcfg, cfg, jax.tree.map(jnp.asarray, ntree),
                    from_jax_params(ntree, cfg)))
    return out


@functools.lru_cache(maxsize=1)
def _model_table():
    return {m[0]: m[1:] for m in _models()}


@pytest.mark.parametrize("label", ["dense", "mla_moe", "dense_int8"])
def test_verify_window_matches_jax(label):
    """One verify of gamma=3 over B=4 slots (greedy with the plain greedy
    chain as proposals, greedy with a miss, sampled with top-k, an empty
    slot), with penalties and logprobs: out_tokens and n_acc exact,
    logprobs and the forward's logits within 1e-4, the counts equal, the
    caches after the one append within 2e-5 (page 0 excluded)."""
    jcfg, cfg, jparams, params = _model_table()[label]
    rng = np.random.default_rng(7)
    g, B, M = 3, 4, 6
    T = g + 1
    ks, vs = llama.kv_cache_shapes(cfg, N_BLOCKS, BS)
    kc = rng.standard_normal(ks).astype(np.float32) * 0.5
    vc = rng.standard_normal(vs).astype(np.float32) * 0.5
    tables = rng.permutation(np.arange(1, N_BLOCKS))[: B * M].reshape(B, M).astype(np.int32)
    tables[3] = 0
    seq_lens = np.asarray([6, 11, 8, 0], np.int32)  # row 0's window crosses a page
    positions = np.maximum(seq_lens - 1, 0).astype(np.int32)
    last = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    V = cfg.vocab_size
    pens = dict(freq_pens=np.asarray([0.3, 0, 0.2, 0], np.float32),
                pres_pens=np.asarray([0, 0.5, 0, 0], np.float32),
                rep_pens=np.asarray([1.2, 1, 1, 1], np.float32))
    counts = np.zeros((B, V), np.int32)
    counts[np.arange(B), rng.integers(0, V, B)] = 2
    mask = rng.random((B, V)) < 0.05
    temps = np.asarray([0, 0, 0.8, 0], np.float32)
    top_ks = np.asarray([0, 0, 6, 0], np.int32)
    top_ps = np.asarray([1, 1, 0.9, 1], np.float32)
    seeds, steps = [11, 22, 33, 0], [5, 9, 2, 0]
    # proposals: the plain greedy chain of the port's (penalized) decode
    # window, so the greedy rows accept; row 1 misses at t=1
    chain = llama.decode_window(
        params, cfg, *_t(last, positions, tables, seq_lens), [0] * B, [0] * B,
        *_t(np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32)),
        *_t(kc, vc), n_steps=g, **dict(zip(pens, _t(*pens.values()))),
        counts=torch.from_numpy(counts.copy()), prompt_mask=torch.from_numpy(mask),
    )[0].numpy().T  # [B, g]
    props = chain.astype(np.int32).copy()
    props[1, 1] = (props[1, 1] + 1) % V
    props[3] = -1
    window = np.concatenate([last[:, None], np.maximum(props, 0)], axis=1)
    common = (window, props, positions, tables, seq_lens)
    jout = jllama.verify_window(
        jparams, jcfg, *_j(*common, seeds, steps, temps, top_ks, top_ps, kc, vc),
        n_spec=g, with_logprobs=True, **{k: jnp.asarray(v) for k, v in pens.items()},
        counts=jnp.asarray(counts), prompt_mask=jnp.asarray(mask))
    tk, tv = _t(kc, vc)
    tcounts = torch.from_numpy(counts.copy())
    tout = llama.verify_window(
        params, cfg, *_t(*common), seeds, steps, *_t(temps, top_ks, top_ps),
        tk, tv, n_spec=g, with_logprobs=True,
        **dict(zip(pens, _t(*pens.values()))), counts=tcounts,
        prompt_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    assert tout[1][0] == g and tout[1][1] == 1  # the greedy rows accepted
    assert tout[4] is tcounts
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jout[4]))
    for got, want in zip(tout[5], jout[5]):
        _close(got, want, 1e-4)
    _close(tk[:, :, 1:], np.asarray(jout[2])[:, :, 1:], 2e-5)
    _close(tv[:, :, 1:], np.asarray(jout[3])[:, :, 1:], 2e-5)
    # the forward's raw logits on fresh caches
    tl = llama._verify_forward(params, cfg, *_t(window, positions, tables, seq_lens),
                               *_t(kc, vc), g)[0]
    jl = jax.jit(functools.partial(jllama._verify_forward, cfg=jcfg, n_spec=g))(
        jparams, tokens=jnp.asarray(window), positions=jnp.asarray(positions),
        block_tables=jnp.asarray(tables), seq_lens=jnp.asarray(seq_lens),
        k_cache=jnp.asarray(kc), v_cache=jnp.asarray(vc))[0]
    _close(tl[:3], np.asarray(jl)[:3], 1e-4)


# ---------------- the engine ----------------

PROMPT = [7, 8, 9, 10] * 6  # tests/test_speculative.py: n-gram bait
SPEC_GEOMETRY = dict(num_blocks=64, block_size=8, max_batch_size=2,
                     decode_window=4)


async def _stream(engine, req, ctx, collect_fn):
    try:
        outs = await collect_fn(engine.generate(ctx(req)))
    finally:
        await engine.close()
    return [t for o in outs for t in o.token_ids]


def test_torch_engine_spec_stream_matches_plain_and_jax_engine(run):
    """spec_gamma=3 on a repetitive prompt: the greedy stream of the plain
    engine and of JaxEngine(spec_gamma=3) on the same weights, the same
    proposed/accepted counts as JaxEngine, fewer decode steps."""
    jcfg = JaxModelConfig.tiny(dtype="float32")
    jeng = JaxEngine(JaxEngineConfig(model=jcfg, spec_gamma=3, **SPEC_GEOMETRY),
                     seed=0)
    tree = jax.tree.map(np.asarray, jeng.params)
    cfg = ModelConfig.tiny(dtype="float32")
    ref = run(_stream(jeng, JaxRequest(
        token_ids=PROMPT, stop_conditions=JaxStops(max_tokens=20),
        sampling_options=JaxSampling(temperature=0.0), eos_token_ids=[]),
        JaxContext, jax_collect))
    got, stats = {}, {}
    for gamma in (0, 3):
        eng = TorchEngine(EngineConfig(model=cfg, spec_gamma=gamma, **SPEC_GEOMETRY),
                          params=from_jax_params(tree, cfg), device="cpu")
        got[gamma] = run(_stream(eng, PreprocessedRequest(
            token_ids=PROMPT, stop_conditions=StopConditions(max_tokens=20),
            sampling_options=SamplingOptions(temperature=0.0), eos_token_ids=[]),
            Context, collect))
        stats[gamma] = dict(eng.stats)
    assert len(ref) == 20
    assert got[3] == got[0] == ref
    assert stats[3]["spec_accepted"] > 0
    assert stats[3]["spec_proposed"] == jeng.stats["spec_proposed"]
    assert stats[3]["spec_accepted"] == jeng.stats["spec_accepted"]
    assert stats[3]["decode_steps"] < stats[0]["decode_steps"]
    assert stats[0]["spec_proposed"] == 0


def _force_proposals(engine, ref_stream, gamma):
    """Replace the engine's prompt-lookup proposer with one that proposes
    each active sequence's true continuation from ``ref_stream`` (the plain
    run's output), as tests/test_speculative.py does: deterministic
    engagement where organic n-gram hits depend on the random model."""

    def forced():
        prop = np.full((engine.cfg.max_batch_size, gamma), -1, np.int64)
        found = False
        for i, seq in enumerate(engine._active):
            if seq is None or seq.finished:
                continue
            nxt = ref_stream[seq.generated: seq.generated + gamma]
            if nxt:
                prop[i, : len(nxt)] = nxt
                found = True
        return prop if found else None

    engine._propose_ngram = forced


def test_torch_engine_spec_serves_mla_moe_and_sampled_rows(run):
    """The MLA + MoE model with spec_gamma=3, fed the plain stream as its
    proposals: the same greedy stream, every proposal accepted, fewer
    decode steps; a seeded sampled request (penalties, logprobs) through
    the organic verify gets every token with its logprob entry."""
    _jcfg, cfg, _jparams, params = _model_table()["mla_moe"]

    def req(**so):
        return PreprocessedRequest(
            token_ids=PROMPT, stop_conditions=StopConditions(max_tokens=16),
            sampling_options=SamplingOptions(**so), eos_token_ids=[])

    got, stats = {}, {}
    for gamma in (0, 3):
        eng = TorchEngine(EngineConfig(model=cfg, spec_gamma=gamma, **SPEC_GEOMETRY),
                          params=params, device="cpu")
        if gamma:
            _force_proposals(eng, got[0], gamma)
        got[gamma] = run(_stream(eng, req(temperature=0.0), Context, collect))
        stats[gamma] = dict(eng.stats)
    assert got[3] == got[0] and len(got[3]) == 16
    assert stats[3]["spec_accepted"] == stats[3]["spec_proposed"] > 0
    assert stats[3]["decode_steps"] < stats[0]["decode_steps"]
    sampled = req(temperature=0.7, top_k=20, seed=5, frequency_penalty=0.2,
                  logprobs=2)
    plain = run(_stream(TorchEngine(EngineConfig(model=cfg, **SPEC_GEOMETRY),
                                    params=params, device="cpu"),
                        sampled, Context, collect))
    eng = TorchEngine(EngineConfig(model=cfg, spec_gamma=3, **SPEC_GEOMETRY),
                      params=params, device="cpu")
    _force_proposals(eng, plain, 3)

    async def spec():
        try:
            return await collect(eng.generate(Context(sampled)))
        finally:
            await eng.close()

    outs = run(spec())
    toks = [t for o in outs for t in o.token_ids]
    lps = [e for o in outs for e in (o.logprobs or [])]
    assert len(toks) == 16 and len(lps) == 16
    assert all(len(e["top"]) == 2 for e in lps)
    assert eng.stats["spec_proposed"] > 0


def test_spec_config_gates(run, monkeypatch, caplog):
    """decode_window < 2 raises; the int8 KV cache warns and runs plain
    windows; on the card a verify of any width passes the init checks (the
    decode kernel takes any number of rows per kv head), so a CPU build
    stops only at the card allocation; the launcher threads --spec-gamma /
    --spec-ngram."""
    cfg = ModelConfig.tiny(dtype="float32")
    with pytest.raises(ValueError, match="decode_window >= 2"):
        EngineConfig(model=cfg, spec_gamma=3, decode_window=1)
    with caplog.at_level(logging.WARNING):
        eng = TorchEngine(EngineConfig(model=cfg, spec_gamma=3, kv_cache_dtype="int8",
                                       **SPEC_GEOMETRY), device="cpu")
    assert "speculative" in caplog.text and eng.k_scales is not None

    async def plain_windows():
        return await _stream(eng, PreprocessedRequest(
            token_ids=PROMPT, stop_conditions=StopConditions(max_tokens=9),
            sampling_options=SamplingOptions(temperature=0.0)), Context, collect)

    assert len(run(plain_windows())) == 9
    assert eng.stats["spec_proposed"] == 0 and eng.stats["decode_windows"] > 0
    # G = 8 query heads per kv head: (8 + 1) x 8 = 72 verify rows
    wide = ModelConfig.tiny(num_heads=8, num_kv_heads=1, head_dim=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA") as err:
        TorchEngine(EngineConfig(model=wide, spec_gamma=8, **SPEC_GEOMETRY),
                    device="cuda")
    assert "rows" not in str(err.value)
    from dynamo_tpu_torch.launch import dynamo_run
    args = dynamo_run.parse_args(["in=http", "out=torch", "--model-path", "tiny",
                                  "--spec-gamma", "3", "--spec-ngram", "2"])
    ecfg = dynamo_run.engine_config(args, cfg)
    assert (ecfg.spec_gamma, ecfg.spec_ngram) == (3, 2)
    assert dynamo_run.engine_config(dynamo_run.parse_args([]), cfg).spec_gamma == 0
