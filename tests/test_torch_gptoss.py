"""gpt-oss in the port against the JAX package: sliding-window floors and
attention sinks in the three GQA attention kernels' plain versions (what
the wrappers run on CPU tensors; the CUDA kernels are held to these on the
card by tests/test_torch_cuda.py and chip_smoke.py), YaRN rope, the tiny
gpt-oss model (o_proj bias, router logit bias, biased clamped-SwiGLU
experts) through prefill / decode window / mixed step / verify and the
engine, a homogeneous window shorter than the context (Mistral-7B-v0.1's
kind), and the refusal of quantized weights on gpt-oss. The gpt-oss checkpoint loader is held to HF in
tests/test_torch_checkpoint.py, where transformers is already loaded.

The JAX side runs its Pallas kernels in interpret mode, or its XLA paths,
as its own tests do; inputs come from numpy seeds. Tolerances: 2e-5 for
the f32 kernel functions (the JAX kernel tests' own), 1e-4 for the tiny
f32 model's logits, 1e-6 relative for the rope frequencies; greedy tokens
exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops.paged_attention_pallas import (
    paged_decode_attention as j_decode,
)
from dynamo_tpu.ops.paged_attention_pallas import (
    paged_prefill_attention as j_prefill,
)
from dynamo_tpu.ops.ragged_paged_attention_pallas import (
    ragged_mixed_attention as j_ragged,
)
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)
from dynamo_tpu_torch.ops.ragged_paged_attention import ragged_mixed_attention

TOL = dict(rtol=2e-5, atol=2e-5)
D, BS = 64, 16


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **(tol or TOL))


def _pages(rng, Hkv, N, int8):
    """K and V pages (f32, or int8 codes with f32 per-page scales)."""
    if not int8:
        kc, vc = (rng.standard_normal((Hkv, N, BS, D)).astype(np.float32)
                  for _ in range(2))
        return kc, vc, None, None
    kc, vc = (rng.integers(-127, 128, (Hkv, N, BS, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, N).astype(np.float32) for _ in range(2))
    return kc, vc, ks, vs


# the JAX dispatchers jitted whole (their ops one by one compile slower)
_J_STATIC = ("scale", "use_pallas", "window", "interpret")
j_decode_any = jax.jit(jatt.decode_attention, static_argnames=_J_STATIC)
j_verify = jax.jit(jatt.verify_attention, static_argnames=_J_STATIC)
j_merged = jax.jit(jatt.decode_attention_merged,
                   static_argnames=("scale", "window", "interpret"))


_INIT_STD = {"sinks": 0.5, "be_gate": 0.05, "be_up": 0.05, "be_down": 0.05}
_INIT_ZERO = ("bq", "bk", "bv", "bo", "moe_router_bias")


def _jax_init(jcfg, seed):
    """The leaves of the reference's init_params drawn with numpy at its
    scales (norms 1, its zero biases 0, sinks 0.5, expert biases 0.05,
    the rest 0.02): its own init compiles for seconds, jitted or not."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(jllama.init_params, jcfg),
                            jax.random.key(seed))

    def leaf(path, s):
        name = path[-1].key
        if "norm" in name:
            v = np.ones(s.shape)
        elif name in _INIT_ZERO:
            v = np.zeros(s.shape)
        else:
            v = rng.normal(0, _INIT_STD.get(name, 0.02), s.shape)
        return jnp.asarray(v, s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _scales(ks, vs, lib):
    if ks is None:
        return {}
    conv = _t if lib == "torch" else _j
    k, v = conv(ks, vs)
    return dict(k_scales=k, v_scales=v)


# (G, window, sinks, int8 pages): a window alone, sinks alone and both
# (over int8 pages with scales), over G = 2 and 4; neither is the path
# tests/test_torch_ops.py holds to the same kernels
KERNEL_CASES = [(4, 20, False, False), (2, 0, True, False),
                (4, 20, True, True)]


@pytest.mark.parametrize("G,window,with_sinks,int8", KERNEL_CASES)
def test_gqa_kernel_functions_match_jax(G, window, with_sinks, int8):
    """paged_decode_attention (with stats, and with the sink folded),
    paged_prefill_attention, ragged_mixed_attention, verify_attention and
    decode_attention_merged against the JAX package's (Pallas interpret /
    its kernel-path dispatchers), with windows shorter than the history
    and chunks that cross them."""
    rng = np.random.default_rng(100 + G + window + 2 * with_sinks + 4 * int8)
    Hkv, B, M = 2, 3, 5
    H = Hkv * G
    N = (B + 2) * M + 1
    kc, vc, ks, vs = _pages(rng, Hkv, N, int8)
    pages = rng.permutation(np.arange(1, N)).astype(np.int32)
    tables = pages[: B * M].reshape(B, M)
    p_tables = pages[B * M: (B + 2) * M].reshape(2, M)
    sinks = rng.standard_normal(H).astype(np.float32) if with_sinks else None
    ts = None if sinks is None else torch.from_numpy(sinks)
    js = None if sinks is None else jnp.asarray(sinks)
    scale = D ** -0.5
    tsc, jsc = _scales(ks, vs, "torch"), _scales(ks, vs, "jax")
    cache = (kc, vc)

    # ---- decode rows: (o, m, l) without the sink, o with it ----
    seq_lens = np.asarray([0, 27, M * BS], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    args = (q, *cache, tables, seq_lens)
    o, m, l = paged_decode_attention(*_t(*args), scale, return_stats=True,
                                     window=window, **tsc)
    jo, jm, jl = j_decode(*_j(*args), scale, return_stats=True, window=window,
                          interpret=True, **jsc)
    for g, r in ((o, jo), (m, jm), (l, jl)):
        _close(g, r)
    _close(paged_decode_attention(*_t(*args), scale, window=window, sinks=ts,
                                  **tsc),
           j_decode_any(*_j(*args), scale, use_pallas=True, window=window,
                        sinks=js, interpret=True, **jsc))

    # ---- a prefill chunk over 37 cached tokens (floors in the history) ----
    T, hist = 16, 37
    qp = rng.standard_normal((T, H, D)).astype(np.float32)
    pargs = (qp, *cache, p_tables[0])
    _close(paged_prefill_attention(*_t(*pargs), hist, scale, window=window,
                                   sinks=ts, **tsc),
           j_prefill(*_j(*pargs), jnp.int32(hist), scale, window=window,
                     sinks=js, interpret=True, **jsc))

    # ---- the ragged call: decode rows + a live and a short segment ----
    p_hists = np.asarray([37, 5], np.int32)
    p_valids = np.asarray([T, 9], np.int32)
    qc = rng.standard_normal((2, T, H, D)).astype(np.float32)
    rargs = (q, qc, *cache, tables, seq_lens, p_tables, p_hists, p_valids)
    od, oc = ragged_mixed_attention(*_t(*rargs), scale, window=window,
                                    sinks=ts, **tsc)
    jd, jc = j_ragged(*_j(*rargs), scale, window=window, sinks=js,
                      interpret=True, **jsc)
    _close(od[1:], jd[1:])  # slot 0 is inactive (the JAX rows are garbage)
    _close(oc[0], jc[0])
    _close(oc[1, :9], jc[1, :9])  # the short segment's real rows

    # ---- the merge: a T=3 verify window and the merged decode ----
    hist_lens = np.asarray([0, 30, 58], np.int32)
    vq = rng.standard_normal((B, 3, H, D)).astype(np.float32)
    kw, vw = (rng.standard_normal((B, 3, Hkv, D)).astype(np.float32)
              for _ in range(2))
    vargs = (vq, kw, vw, *cache, tables, hist_lens)
    _close(att.verify_attention(*_t(*vargs), scale, window=window, sinks=ts,
                                **tsc),
           j_verify(*_j(*vargs), scale, use_pallas=True, window=window,
                    sinks=js, interpret=True, **jsc))
    margs = (vq[:, 0], kw[:, 0], vw[:, 0], *cache, tables, hist_lens)
    _close(att.decode_attention_merged(*_t(*margs), scale, window=window,
                                       sinks=ts, **tsc),
           j_merged(*_j(*margs), scale, window=window, sinks=js,
                    interpret=True, **jsc))


# ---------------- YaRN ----------------

@pytest.mark.parametrize("truncate", [False, True])
def test_yarn_rope_matches_jax(truncate):
    """gpt-oss-20b's published rope_scaling (YaRN factor 32 over 4096,
    truncate=False: a fractional correction range), and the same with the
    range rounded: inverse frequencies, the cos/sin attention factor and a
    rotation at positions past the original context."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    rs = dict(ModelConfig.gptoss_20b().rope_scaling, truncate=truncate)
    cfg = ModelConfig.gptoss_20b(rope_scaling=rs)
    jcfg = JaxModelConfig.gptoss_20b(rope_scaling=rs)
    inv, jinv = llama._rope_freqs(cfg), jllama._rope_freqs(jcfg)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6)
    msc = llama.rope_attention_scaling(cfg)
    assert msc == jllama._rope_attention_scaling(jcfg) != 1.0
    x = np.random.default_rng(3).standard_normal((4, 2, 64)).astype(np.float32)
    pos = np.arange(6000, 6004, dtype=np.int32)
    # 5e-4: the two libraries' f32 cos/sin of angles of thousands of
    # radians differ by up to ~2e-4 (the frequencies above agree to 1e-6)
    _close(llama.apply_rope(*_t(x, pos), inv, msc),
           jllama.apply_rope(*_j(x, pos), jinv, msc), rtol=5e-4, atol=5e-4)


# ---------------- the tiny models ----------------

N_BLOCKS, MBS = 48, 4


def _tiny(kind):
    """(JAX config, port config, JAX params, port params): the tiny-gptoss
    preset's first two layers, or a dense tiny model with one 8-token
    window on every layer (Mistral-7B-v0.1's kind), at f32.
    Zero-initialised biases and the sinks are drawn, so each carries
    weight in the check."""
    from dynamo_tpu_torch.launch.dynamo_run import PRESETS
    from dynamo_tpu_torch.models.weights import from_jax_params

    if kind == "tiny-gptoss":
        # depth cut to one windowed and one full layer: the reference
        # unrolls its layers here, and its compiles set the test's time
        cfg = PRESETS["tiny-gptoss"]()
        cfg.dtype = "float32"
        cfg.num_layers, cfg.layer_windows = 2, cfg.layer_windows[:2]
        fields = {k: getattr(cfg, k) for k in (
            "num_layers", "layer_windows", "attn_sinks", "o_bias",
            "attention_bias", "num_experts", "num_experts_per_tok",
            "moe_intermediate_size", "moe_act")}
        jcfg = JaxModelConfig.tiny(dtype="float32", **fields)
    else:
        from dynamo_tpu_torch.models.config import ModelConfig

        cfg = ModelConfig.tiny(dtype="float32", sliding_window=8)
        jcfg = JaxModelConfig.tiny(dtype="float32", sliding_window=8)
    jparams = _jax_init(jcfg, 5)
    rng = np.random.default_rng(6)
    lay = dict(jparams["layers"])
    # the sinks near the log of the window: a real share of the mass
    for k, mean, std in (("bq", 0, 0.1), ("bk", 0, 0.1), ("bv", 0, 0.1),
                         ("bo", 0, 0.1), ("moe_router_bias", 0, 0.5),
                         ("sinks", np.log(16), 1.0)):
        if k in lay:
            lay[k] = jnp.asarray(rng.normal(mean, std, lay[k].shape),
                                 lay[k].dtype)
    jparams = {**jparams, "layers": lay}
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, params


def _f(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("kind", ["tiny-gptoss", "window-8"])
def test_tiny_model_paths_match_jax(kind):
    """prefill (a chunk over a history longer than the window), a 4-step
    merged decode window and dense_forward, and for gpt-oss the fused
    mixed step and the verify too, against the JAX package's (XLA paths;
    its mixed step through the ragged Pallas kernel in interpret mode):
    logits within 1e-4, greedy tokens exact, the written K/V rows alike.
    The window-8 model takes the reference's paged and dense paths
    (tests/test_model_llama.py's sliding-window case)."""
    from dynamo_tpu_torch.models import llama

    jcfg, cfg, jparams, params = _tiny(kind)
    rng = np.random.default_rng(7)
    shape = llama.kv_cache_shapes(cfg, N_BLOCKS, MBS)[0]
    kc0 = rng.standard_normal(shape).astype(np.float32) * 0.5
    vc0 = rng.standard_normal(shape).astype(np.float32) * 0.5
    pages = rng.permutation(np.arange(1, N_BLOCKS)).astype(np.int32)
    M = 11
    V = cfg.vocab_size

    def caches():
        return _j(kc0, vc0), _t(kc0.copy(), vc0.copy())

    # ---- prefill: 16 rows (13 real) after 24 cached tokens ----
    table = pages[:M]
    tokens = rng.integers(0, V, 16).astype(np.int32)
    (jk, jv), (tk, tv) = caches()
    jl, jk, jv = jllama.prefill(jparams, jcfg, jnp.asarray(tokens),
                                jnp.asarray(table), jnp.int32(24),
                                jnp.int32(13), jk, jv, use_pallas=False)
    tl, tk, tv = llama.prefill(params, cfg, torch.from_numpy(tokens),
                               torch.from_numpy(table), 24, 13, tk, tv)
    _close(tl, jl, rtol=1e-4, atol=1e-4)
    assert int(tl.argmax()) == int(jnp.argmax(jl))
    pos = np.arange(24, 37)
    slots = (slice(None), slice(None), table[pos // MBS], pos % MBS)
    _close(_f(tk)[slots], _f(jk)[slots], rtol=1e-4, atol=1e-4)

    # ---- a 4-step merged decode window (one row past the window) ----
    B = 3
    tables = pages[: B * M].reshape(B, M).copy()
    tables[2] = 0  # an inactive slot
    seq_lens = np.asarray([5, 29, 0], np.int32)
    positions = np.maximum(seq_lens - 1, 0).astype(np.int32)
    last = rng.integers(0, V, B).astype(np.int32)
    zf, zi, of = (np.zeros(B, np.float32), np.zeros(B, np.int32),
                  np.ones(B, np.float32))
    (jk, jv), (tk, tv) = caches()
    jtoks, jk, jv, jlp = jllama.decode_window(
        jparams, jcfg, *_j(last, positions, tables, seq_lens, zi, zi, zf, zi,
                           of), jk, jv, n_steps=4, use_pallas=False,
        with_logprobs=True)
    ttoks, tk, tv, tlp = llama.decode_window(
        params, cfg, *_t(last, positions, tables, seq_lens), [0] * B, [0] * B,
        *_t(zf, zi, of), tk, tv, n_steps=4, with_logprobs=True)
    np.testing.assert_array_equal(ttoks.numpy()[:, :2], np.asarray(jtoks)[:, :2])
    _close(tlp[0][:, :2], jlp[0][:, :2], rtol=1e-4, atol=1e-4)
    _close(_f(tk)[:, :, 1:], _f(jk)[:, :, 1:], rtol=1e-4, atol=1e-4)

    # ---- the cache-free oracle over 40 tokens ----
    toks = rng.integers(0, V, 40).astype(np.int32)
    _close(llama.dense_forward(params, cfg, torch.from_numpy(toks)),
           jax.jit(functools.partial(jllama.dense_forward, cfg=jcfg))(
               jparams, tokens=jnp.asarray(toks)),
           rtol=1e-4, atol=1e-4)
    if kind != "tiny-gptoss":
        return

    # ---- the fused mixed step: 2 decode rows + a segment past the window ----
    d_tables = pages[: 2 * M].reshape(2, M)
    p_tables = np.zeros((2, M), np.int32)
    p_tables[0] = pages[2 * M: 3 * M]  # segment 1 is dead
    d_seq_lens = np.asarray([9, 30], np.int32)
    dec = (rng.integers(0, V, 2).astype(np.int32), d_seq_lens - 1, d_tables,
           d_seq_lens)
    pre = (rng.integers(0, V, (2, 16)).astype(np.int32), p_tables,
           np.asarray([20, 0], np.int32), np.asarray([12, 0], np.int32))
    z2 = (np.zeros(2, np.int32), np.zeros(2, np.int32),
          np.zeros(2, np.float32), np.zeros(2, np.int32),
          np.ones(2, np.float32))
    (jk, jv), (tk, tv) = caches()
    jn, jpl, jk, jv = jllama.mixed_step(
        jparams, jcfg, *_j(*dec), *_j(*z2), *_j(*pre), jk, jv,
        use_pallas=False)
    tn, tpl, tk, tv = llama.mixed_step(
        params, cfg, *_t(*dec), [0] * 2, [0] * 2, *_t(*z2[2:]), *_t(*pre),
        tk, tv)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _close(tpl[0], jpl[0], rtol=1e-4, atol=1e-4)

    # ---- the verify: 3 proposals per row (the second row's from the
    # port's own greedy chain, so it accepts), logprobs of every position
    window = rng.integers(0, V, (2, 4)).astype(np.int32)
    vpos, vlens = np.asarray([4, 27], np.int32), np.asarray([5, 28], np.int32)
    (jk, jv), (tk, tv) = caches()
    chain = llama.decode_window(
        params, cfg, *_t(window[:, 0], vpos, d_tables, vlens), [0] * 2,
        [0] * 2, *_t(*z2[2:]), *_t(kc0.copy(), vc0.copy()), n_steps=3)[0]
    window[1, 1:] = chain.numpy()[:, 1]
    common = (window, window[:, 1:].copy(), vpos, d_tables, vlens)
    jout = jllama.verify_window(
        jparams, jcfg, *_j(*common, [0, 0], [0, 0], z2[2], z2[3], z2[4], kc0,
                           vc0), n_spec=3, with_logprobs=True)
    tout = llama.verify_window(params, cfg, *_t(*common), [0, 0], [0, 0],
                               *_t(*z2[2:]), tk, tv, n_spec=3,
                               with_logprobs=True)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    assert int(tout[1][1]) == 3
    for got, want in zip(tout[4], jout[4]):
        _close(got, want, rtol=1e-4, atol=1e-4)


# ---------------- the engine ----------------


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3", "int8_native"])
def test_quantized_gptoss_is_refused(mode):
    """Quantized weights on gpt-oss are not ported: the engine refuses
    them before it serves."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.launch.dynamo_run import PRESETS

    cfg = PRESETS["tiny-gptoss"]()
    with pytest.raises(NotImplementedError, match="gpt-oss"):
        TorchEngine(EngineConfig(model=cfg, num_blocks=8, block_size=4,
                                 max_batch_size=1, quantization=mode),
                    device="cpu")


def test_torch_engine_matches_jax_engine_on_tiny_gptoss(run):
    """TorchEngine and JaxEngine on one tiny gpt-oss model (a layer with a
    window of 6, then a full one; 8-token prefill chunks that cross the window's
    edge; tests/test_hf_parity.py's paged-engine case): the same greedy
    tokens, which the port's dense forward also gives, with spec_gamma=0
    and with spec_gamma=3 (2-gram prompt lookup: proposals made and
    verified)."""
    from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine import JaxEngine
    from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
    from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
    from dynamo_tpu.protocols.common import StopConditions as JaxStops
    from dynamo_tpu.runtime import Context as JaxContext
    from dynamo_tpu.runtime import collect as jax_collect
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.weights import from_jax_params
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime import Context, collect

    kw = dict(num_layers=2, layer_windows=(6, 0), attn_sinks=True,
              o_bias=True, attention_bias=True, num_experts=4,
              num_experts_per_tok=2, moe_intermediate_size=32,
              moe_act="gptoss_clamp", dtype="float32")
    geometry = dict(num_blocks=32, block_size=4, max_batch_size=2,
                    max_context=64, prefill_chunk=8)
    jcfg, cfg = JaxModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    jparams = _jax_init(jcfg, 2)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    # a 9-token block twice; the greedy answer repeats a 2-gram early on
    prompt = [(11 * i + 5) % cfg.vocab_size for i in range(9)] * 2
    n = 17  # the first token, then four 4-step windows: one JAX program
    cur = list(prompt)
    for _ in range(n):
        lg = llama.dense_forward(params, cfg, torch.tensor(cur))
        cur.append(int(lg[-1].argmax()))
    want = cur[len(prompt):]

    async def stream(engine, req, ctx, collect_fn):
        try:
            outs = await collect_fn(engine.generate(ctx(req)))
        finally:
            await engine.close()
        return [t for o in outs for t in o.token_ids]

    ref = run(stream(
        JaxEngine(JaxEngineConfig(model=jcfg, **geometry), params=jparams),
        JaxRequest(token_ids=list(prompt),
                   stop_conditions=JaxStops(max_tokens=n, ignore_eos=True),
                   sampling_options=JaxSampling(temperature=0.0),
                   eos_token_ids=[]),
        JaxContext, jax_collect))
    assert ref == want
    for gamma in (0, 3):
        eng = TorchEngine(EngineConfig(model=cfg, spec_gamma=gamma,
                                       spec_ngram=2, **geometry),
                          params=params, device="cpu")
        got = run(stream(eng, PreprocessedRequest(
            token_ids=list(prompt),
            stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0),
            eos_token_ids=[]), Context, collect))
        assert got == ref, (gamma, got, ref)
        if gamma:
            assert eng.stats["spec_proposed"] > 0

