"""Gemma-3 in the port against the JAX package, on the CPU.

Same inputs (numpy, from seeds) through the JAX function and its port:

* the plain twins of the three GQA kernels (what the wrappers run on CPU
  tensors; the CUDA kernels of ``csrc/paged_attention_wide.cu`` are held
  to them on the card by tests/test_torch_cuda.py and chip_smoke.py) at
  head widths 256 and 192, G = 2 (Gemma-3-12B's), over f32, int8 and fp8
  pages, windowed and not, against the JAX Pallas kernels in interpret
  mode: within 2e-5 (the JAX kernel tests' own);
* the gate: a width the kernels do not take raises ``ValueError`` naming
  ROADMAP B.7, on the CPU before any launch;
* ``GEMMA3_12B_HF``'s spelled-out defaults against
  ``transformers.Gemma3TextConfig()``, and the preset's shapes;
* a tiny Gemma-3 (head_dim 256, 6 layers windowed 8, 8, 8, 8, 8 and full,
  a query scale base of 32, linear rope on the full layer and a local
  rope on the windowed ones, sandwich norms, GeGLU, scaled embeddings)
  through dense_forward, prefill, the merged decode window, the fused
  mixed step and the verify against ``dynamo_tpu.models.llama``'s, in
  f32: logits within 1e-4, greedy tokens exact;
* ``TorchEngine`` against ``JaxEngine`` on it over bf16, int8 and fp8 KV
  pages: the same greedy tokens (each path of the fp8 cache is the
  reference path of its own meaning, ROADMAP C.11);
* tiny ``Gemma3ForCausalLM`` checkpoints, text and multimodal, built
  here: the port's loader + dense_forward against HF's logits at the JAX
  package's 5e-4, its leaves equal to the JAX loader's, and the port's
  saver read back bit for bit (these skip without ``Gemma3TextConfig``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.ops.paged_attention_pallas import (
    paged_decode_attention as j_decode,
)
from dynamo_tpu.ops.paged_attention_pallas import (
    paged_prefill_attention as j_prefill,
)
from dynamo_tpu.ops.ragged_paged_attention_pallas import (
    ragged_mixed_attention as j_ragged,
)
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import GEMMA3_12B_HF, ModelConfig, gemma3_12b
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)
from dynamo_tpu_torch.ops.ragged_paged_attention import ragged_mixed_attention
from tests.test_torch_gptoss import _jax_init

FP8 = torch.float8_e4m3fn
TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


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
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _close(got, ref, **tol):
    np.testing.assert_allclose(_f(got), _f(ref), **(tol or TOL))


# ---------------- the kernels' plain twins at the wide heads ----------------


def _pages(rng, kind, shape):
    """K and V pages (f32, int8 codes with f32 per-page scales, or fp8) and
    the scales' keyword arguments for the port and for JAX."""
    N = shape[1]
    if kind == "int8":
        kc, vc = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, N).astype(np.float32) for _ in range(2))
        return (kc, vc), dict(zip(("k_scales", "v_scales"), _t(ks, vs))), dict(
            k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if kind == "fp8":  # the reference's cast of values up to ~8
        kc, vc = ((2 * x).astype(ml_dtypes.float8_e4m3fn) for x in (kc, vc))
    return (kc, vc), {}, {}


@pytest.mark.parametrize("D,pages,window", [
    (256, "f32", 0), (256, "int8", 20), (256, "fp8", 20), (192, "f32", 20)])
def test_wide_head_twins_match_pallas(D, pages, window):
    """paged_decode_attention with (m, l), paged_prefill_attention over 37
    cached tokens and ragged_mixed_attention (decode rows, a live and a
    short segment) at head widths 256 and 192 with Gemma-3-12B's G = 2,
    against the JAX Pallas kernels in interpret mode: within 2e-5; a window
    shorter than the histories where given."""
    rng = np.random.default_rng(D + window + len(pages))
    B, Hkv, G, bs, M = 3, 2, 2, 16, 5
    H = Hkv * G
    N = (B + 2) * M + 1
    cache, tsc, jsc = _pages(rng, pages, (Hkv, N, bs, D))
    pages_ = rng.permutation(np.arange(1, N)).astype(np.int32)
    tables = pages_[: B * M].reshape(B, M)
    p_tables = pages_[B * M: (B + 2) * M].reshape(2, M)
    scale = 32 ** -0.5  # a query scale base unlike D (Gemma-3's kind)

    seq_lens = np.asarray([0, 27, M * bs], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    args = (q, *cache, tables, seq_lens)
    got = paged_decode_attention(*_t(*args), scale, return_stats=True,
                                 window=window, **tsc)
    ref = j_decode(*_j(*args), scale, return_stats=True, window=window,
                   interpret=True, **jsc)
    for g, r in zip(got, ref):
        _close(g, r)

    T, hist = 16, 37
    qp = rng.standard_normal((T, H, D)).astype(np.float32)
    pargs = (qp, *cache, p_tables[0])
    _close(paged_prefill_attention(*_t(*pargs), hist, scale, window=window, **tsc),
           j_prefill(*_j(*pargs), jnp.int32(hist), scale, window=window,
                     interpret=True, **jsc))

    p_hists = np.asarray([37, 5], np.int32)
    p_valids = np.asarray([T, 9], np.int32)
    qc = rng.standard_normal((2, T, H, D)).astype(np.float32)
    rargs = (q, qc, *cache, tables, seq_lens, p_tables, p_hists, p_valids)
    od, oc = ragged_mixed_attention(*_t(*rargs), scale, window=window, **tsc)
    jd, jc = j_ragged(*_j(*rargs), scale, window=window, interpret=True, **jsc)
    _close(od[1:], jd[1:])  # slot 0 is inactive (the JAX rows are garbage)
    _close(oc[0], jc[0])
    _close(oc[1, :9], jc[1, :9])  # the short segment's real rows


@pytest.mark.parametrize("D", [96, 320, 32])
def test_other_head_widths_raise_naming_b7(D):
    """A width outside 64 / 128 / 192 / 256 is refused before any launch,
    on any device: the check, the launcher (on CPU tensors, where it would
    otherwise refuse the device) and TorchEngine's gate, which holds only
    on the card (the CPU serves any width through the plain twins)."""
    with pytest.raises(ValueError, match="ROADMAP B.7"):
        pa.check_head_dim("test", D)
    q = torch.zeros(2, 1, 2, D)
    kc = torch.zeros(1, 4, 16, D)
    with pytest.raises(ValueError, match="B.7"):
        pa.launch_paged_attention(q, kc, kc, 0.1, d_tables=torch.ones(
            2, 1, dtype=torch.int32), d_seq_lens=torch.ones(2, dtype=torch.int32))
    for ok in pa.HEAD_DIMS:
        pa.check_head_dim("test", ok)
    assert pa.HEAD_DIMS == (64, 128, 192, 256)


# ---------------- the config ----------------


def test_gemma3_12b_config_spells_out_the_hf_defaults():
    """Every key of GEMMA3_12B_HF's text_config that the published file
    leaves out equals ``Gemma3TextConfig()``'s default (transformers
    4.57's), and the preset reads as Gemma-3-12B: 48 layers, 40 of them
    windowed 1024 (every sixth full), 16 heads over 8 of 256, 11.77B
    parameters, the context cut to 8192."""
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "Gemma3TextConfig"):
        pytest.skip("transformers too old for Gemma-3")
    published = ("hidden_size", "intermediate_size", "model_type",
                 "num_attention_heads", "num_hidden_layers",
                 "num_key_value_heads", "rope_scaling", "sliding_window")
    ref = transformers.Gemma3TextConfig()
    for key, value in GEMMA3_12B_HF["text_config"].items():
        if key in published:
            continue
        want = (getattr(ref, "_sliding_window_pattern", None)
                or getattr(ref, "sliding_window_pattern", None)
                if key == "sliding_window_pattern" else getattr(ref, key))
        assert value == want, (key, value, want)
    cfg = gemma3_12b()
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim) == (48, 3840, 16, 8, 256)
    assert cfg.layer_windows == tuple(0 if (i + 1) % 6 == 0 else 1024
                                      for i in range(48))
    assert (cfg.attn_scale_base, cfg.rope_local_theta, cfg.rope_theta) == (
        256, 10000.0, 1000000.0)
    assert cfg.rope_scaling == {"factor": 8.0, "rope_type": "linear"}
    assert cfg.post_norms and cfg.qk_norm and cfg.rms_add_unit
    assert cfg.scale_embed and cfg.tie_word_embeddings
    assert cfg.hidden_act == "gelu_tanh" and cfg.max_position_embeddings == 8192
    E, F, V, L = 3840, 15360, 262208, 48
    per_layer = E * 16 * 256 * 2 + E * 8 * 256 * 2 + 3 * E * F + 4 * E + 2 * 256
    assert V * E + L * per_layer + E == pytest.approx(11.77e9, rel=1e-3)
    llama.check_supported(cfg)
    jcfg = JaxModelConfig.from_hf_config(GEMMA3_12B_HF)
    assert jcfg.layer_windows == tuple(1024 if w else 0 for w in cfg.layer_windows)


# ---------------- the tiny model ----------------

W = 8
GEMMA = dict(num_layers=6, layer_windows=(W,) * 5 + (0,), head_dim=256,
             post_norms=True, qk_norm=True, attn_scale_base=32,
             rms_add_unit=True, scale_embed=True, tie_word_embeddings=True,
             hidden_act="gelu_tanh", rope_theta=1000000.0,
             rope_local_theta=10000.0,
             rope_scaling={"rope_type": "linear", "factor": 8.0},
             dtype="float32")
N_BLOCKS, MBS = 48, 4


@functools.lru_cache(maxsize=1)
def _models():
    """(JAX config, port config, JAX params, port params) of the tiny
    Gemma-3: the reference's leaves drawn with numpy, every norm weight
    N(1, 0.3) so that each (the four sandwich norms, the per-head q/k
    norms, the final one) carries weight in the check. Built once for the
    file; no test changes them."""
    from dynamo_tpu_torch.models.weights import from_jax_params

    jcfg, cfg = JaxModelConfig.tiny(**GEMMA), ModelConfig.tiny(**GEMMA)
    jparams = _jax_init(jcfg, 14)
    rng = np.random.default_rng(15)
    lay = {k: (jnp.asarray(rng.normal(1.0, 0.3, v.shape), v.dtype)
               if "norm" in k else v) for k, v in jparams["layers"].items()}
    final = jnp.asarray(rng.normal(1.0, 0.3, jparams["final_norm"].shape),
                        jparams["final_norm"].dtype)
    jparams = {**jparams, "layers": lay, "final_norm": final}
    assert {"attn_post_norm", "mlp_post_norm", "q_norm", "k_norm"} <= set(lay)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, params


def _caches(cfg, rng):
    shape = llama.kv_cache_shapes(cfg, N_BLOCKS, MBS)[0]
    return tuple((rng.standard_normal(shape) * 0.5).astype(np.float32)
                 for _ in range(2))


def _greedy(B):
    return (np.zeros(B, np.int32), np.zeros(B, np.int32),
            np.zeros(B, np.float32), np.zeros(B, np.int32),
            np.ones(B, np.float32))


def test_tiny_gemma3_dense_forward_and_prefill_match_jax():
    """dense_forward over 24 tokens (past the window of 8: the local rope
    and the floors both act) and a prefill chunk of 16 rows (13 real) over
    24 cached tokens, against the reference's dense_forward and XLA
    prefill: logits within 1e-4, argmax equal, the written K/V rows
    alike."""
    jcfg, cfg, jparams, params = _models()
    rng = np.random.default_rng(16)
    V = cfg.vocab_size
    toks = rng.integers(0, V, 24).astype(np.int32)
    _close(llama.dense_forward(params, cfg, torch.from_numpy(toks)),
           jax.jit(functools.partial(jllama.dense_forward, cfg=jcfg))(
               jparams, tokens=jnp.asarray(toks)), **MODEL_TOL)
    kc, vc = _caches(cfg, rng)
    table = rng.permutation(np.arange(1, N_BLOCKS)).astype(np.int32)[:11]
    tokens = rng.integers(0, V, 16).astype(np.int32)
    jl, jk, _ = jllama.prefill(jparams, jcfg, *_j(tokens, table), jnp.int32(24),
                               jnp.int32(13), *_j(kc, vc), use_pallas=False)
    tl, tk, _ = llama.prefill(params, cfg, *_t(tokens, table), 24, 13, *_t(kc, vc))
    _close(tl, jl, **MODEL_TOL)
    assert int(tl.argmax()) == int(jnp.argmax(jl))
    pos = np.arange(24, 37)
    slots = (slice(None), slice(None), table[pos // MBS], pos % MBS)
    _close(_f(tk)[slots], _f(jk)[slots], **MODEL_TOL)


def test_tiny_gemma3_decode_window_and_mixed_step_match_jax():
    """A 4-step merged decode window (one row past the window, an inactive
    slot) and the fused mixed step (2 decode rows + a segment over 20
    cached tokens, one dead segment) against the reference's XLA paths:
    tokens exact, logprobs and segment logits within 1e-4."""
    jcfg, cfg, jparams, params = _models()
    rng = np.random.default_rng(17)
    kc, vc = _caches(cfg, rng)
    V, M = cfg.vocab_size, 11
    pages = rng.permutation(np.arange(1, N_BLOCKS)).astype(np.int32)
    B = 3
    tables = pages[: B * M].reshape(B, M).copy()
    tables[2] = 0
    seq_lens = np.asarray([5, 29, 0], np.int32)
    positions = np.maximum(seq_lens - 1, 0).astype(np.int32)
    last = rng.integers(0, V, B).astype(np.int32)
    seeds, steps, temps, top_ks, top_ps = _greedy(B)
    jt, _, _, jlp = jllama.decode_window(
        jparams, jcfg, *_j(last, positions, tables, seq_lens, seeds, steps,
                           temps, top_ks, top_ps), *_j(kc, vc), n_steps=4,
        use_pallas=False, with_logprobs=True)
    tt, _, _, tlp = llama.decode_window(
        params, cfg, *_t(last, positions, tables, seq_lens), [0] * B, [0] * B,
        *_t(temps, top_ks, top_ps), *_t(kc, vc), n_steps=4, with_logprobs=True)
    np.testing.assert_array_equal(tt.numpy()[:, :2], np.asarray(jt)[:, :2])
    _close(tlp[0][:, :2], jlp[0][:, :2], **MODEL_TOL)

    d_tables = pages[: 2 * M].reshape(2, M)
    p_tables = np.zeros((2, M), np.int32)
    p_tables[0] = pages[2 * M: 3 * M]
    d_seq_lens = np.asarray([9, 30], np.int32)
    dec = (rng.integers(0, V, 2).astype(np.int32), d_seq_lens - 1, d_tables,
           d_seq_lens)
    pre = (rng.integers(0, V, (2, 16)).astype(np.int32), p_tables,
           np.asarray([20, 0], np.int32), np.asarray([12, 0], np.int32))
    z2 = _greedy(2)
    jn, jpl, _, _ = jllama.mixed_step(jparams, jcfg, *_j(*dec, *z2, *pre),
                                      *_j(kc, vc), use_pallas=False)
    tn, tpl, _, _ = llama.mixed_step(params, cfg, *_t(*dec), [0] * 2, [0] * 2,
                                     *_t(*z2[2:]), *_t(*pre), *_t(kc, vc))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _close(tpl[0], jpl[0], **MODEL_TOL)


def test_tiny_gemma3_verify_window_matches_jax():
    """A gamma-3 verify (the second row's proposals from the port's own
    greedy chain, so it accepts all three) against the reference's: tokens
    and accepted counts exact, logprobs within 1e-4."""
    jcfg, cfg, jparams, params = _models()
    rng = np.random.default_rng(18)
    kc, vc = _caches(cfg, rng)
    V, M = cfg.vocab_size, 11
    pages = rng.permutation(np.arange(1, N_BLOCKS)).astype(np.int32)
    d_tables = pages[: 2 * M].reshape(2, M)
    window = rng.integers(0, V, (2, 4)).astype(np.int32)
    vpos, vlens = np.asarray([4, 27], np.int32), np.asarray([5, 28], np.int32)
    z2 = _greedy(2)
    chain = llama.decode_window(
        params, cfg, *_t(window[:, 0], vpos, d_tables, vlens), [0] * 2,
        [0] * 2, *_t(*z2[2:]), *_t(kc, vc), n_steps=3)[0]
    window[1, 1:] = chain.numpy()[:, 1]
    common = (window, window[:, 1:].copy(), vpos, d_tables, vlens)
    jout = jllama.verify_window(
        jparams, jcfg, *_j(*common, [0, 0], [0, 0], z2[2], z2[3], z2[4], kc, vc),
        n_spec=3, with_logprobs=True)
    tout = llama.verify_window(params, cfg, *_t(*common), [0, 0], [0, 0],
                               *_t(*z2[2:]), *_t(kc, vc), n_spec=3,
                               with_logprobs=True)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    assert int(tout[1][1]) == 3
    for got, want in zip(tout[4], jout[4]):
        _close(got, want, **MODEL_TOL)


def test_gemma3_pieces_match_jax():
    """The pieces one by one: the linear and local ropes' frequencies, the
    per-layer choice, the scaled embedding and GeGLU against the
    reference's (1e-6 relative; f32)."""
    jcfg, cfg, jparams, params = _models()
    np.testing.assert_allclose(llama._rope_freqs(cfg).numpy(),
                               np.asarray(jllama._rope_freqs(jcfg)), rtol=1e-6)
    np.testing.assert_allclose(llama._rope_freqs_local(cfg).numpy(),
                               np.asarray(jllama._rope_freqs_local(jcfg)),
                               rtol=1e-6)
    for l in range(cfg.num_layers):
        assert (llama.rope_freqs_for_layer(cfg, l, "g", "l")
                == jllama.rope_freqs_for_layer(jcfg, l, "g", "l"))
    toks = np.arange(7, dtype=np.int32)
    _close(llama._embed(params, cfg, torch.from_numpy(toks)),
           jllama._embed(jparams, jcfg, jnp.asarray(toks)), rtol=1e-6, atol=0)
    x = np.random.default_rng(19).standard_normal((5, 64)).astype(np.float32)
    lay = {k: v[0] for k, v in params["layers"].items()}
    jlay = {k: v[0] for k, v in jparams["layers"].items()}
    _close(llama.swiglu(torch.from_numpy(x), lay["w_gate"], lay["w_up"],
                        lay["w_down"], "gelu_tanh"),
           jllama.swiglu(jnp.asarray(x), jlay["w_gate"], jlay["w_up"],
                         jlay["w_down"], "gelu_tanh"), rtol=1e-5, atol=1e-6)


# ---------------- the engine ----------------


PROMPT_LEN, ANSWER = 18, 9  # the first token, then two 4-step windows
ENGINE = dict(num_blocks=32, block_size=4, max_batch_size=2, max_context=64,
              prefill_chunk=8)


def _kernel_meaning_chain(kv):
    """The greedy answer of the engine's schedule for one request (8-token
    prefill chunks, then 4-step merged decode windows) through the
    reference's functions on their kernel path (Pallas in interpret mode),
    over fresh ``kv`` pages: each chunk as the only live segment of a fused
    step (the chunk written, then read back from the pages, as the Pallas
    prefill and the port do), then the merged decode windows (history
    from the pages, the new token at full width)."""
    jcfg, cfg, jparams, _ = _models()
    dt = {"int8": jnp.int8, "float8_e4m3": jnp.float8_e4m3fn}[kv]
    shape = llama.kv_cache_shapes(cfg, ENGINE["num_blocks"], MBS)[0]
    kc, vc = jnp.zeros(shape, dt), jnp.zeros(shape, dt)
    planes = {}
    if kv == "int8":
        planes = {k: jnp.full((cfg.num_layers, ENGINE["num_blocks"]), 1e-12,
                              jnp.float32) for k in ("k_scales", "v_scales")}
    prompt = np.asarray(_prompt(cfg), np.int32)
    M = 8
    table = np.arange(1, M + 1, dtype=np.int32)
    idle = (np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.zeros((1, M), np.int32), np.zeros(1, np.int32), *_greedy(1))
    chunk = ENGINE["prefill_chunk"]
    for c in range(0, PROMPT_LEN, chunk):
        part = prompt[c:c + chunk]
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :part.size] = part
        out = jllama.mixed_step(
            jparams, jcfg, *_j(*idle), *_j(toks, table[None], [c], [part.size]),
            kc, vc, use_pallas=True, interpret=True, **planes)
        kc, vc = out[2], out[3]
        if planes:
            planes = dict(k_scales=out[4], v_scales=out[5])
    answer = [int(jnp.argmax(out[1][0]))]
    for w in range(2):
        n = len(answer)
        out = jllama.decode_window(
            jparams, jcfg, *_j([answer[-1]], [PROMPT_LEN + n - 1], table[None],
                               [PROMPT_LEN + n], *_greedy(1)),
            kc, vc, n_steps=4, use_pallas=True, interpret=True, **planes)
        kc, vc = out[1], out[2]
        if planes:
            planes = dict(k_scales=out[3], v_scales=out[4])
        answer += [int(t) for t in np.asarray(out[0])[:, 0]]
    return answer


def _prompt(cfg):
    return [(11 * i + 5) % cfg.vocab_size for i in range(9)] * 2


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "float8_e4m3"])
def test_torch_engine_matches_jax_on_tiny_gemma3(kv, run):
    """TorchEngine on the tiny Gemma-3 (8-token prefill chunks that cross
    its window, 4-step decode windows) over bf16, int8 (with per-page
    scales) and fp8 KV pages: the same greedy tokens as the reference.
    Over bf16 pages, JaxEngine's. Over int8 and fp8 pages the reference has
    two meanings (ROADMAP C.11): JaxEngine on the CPU runs its XLA paths,
    whose chunks attend their own K/V at full width, where its Pallas
    kernels (the TPU's path) and the port read them back from the
    quantized pages; so the port's engine is held to the reference's
    functions on that kernel path, in interpret mode, over the same
    schedule."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime import Context, collect

    jcfg, cfg, jparams, params = _models()
    prompt = _prompt(cfg)
    assert len(prompt) == PROMPT_LEN

    async def stream(engine, req, ctx, collect_fn):
        try:
            outs = await collect_fn(engine.generate(ctx(req)))
        finally:
            await engine.close()
        return [t for o in outs for t in o.token_ids]

    if kv == "bfloat16":
        from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
        from dynamo_tpu.engine import JaxEngine
        from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
        from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
        from dynamo_tpu.protocols.common import StopConditions as JaxStops
        from dynamo_tpu.runtime import Context as JaxContext
        from dynamo_tpu.runtime import collect as jax_collect

        ref = run(stream(
            JaxEngine(JaxEngineConfig(model=jcfg, kv_cache_dtype=kv, **ENGINE),
                      params=jparams),
            JaxRequest(token_ids=list(prompt),
                       stop_conditions=JaxStops(max_tokens=ANSWER, ignore_eos=True),
                       sampling_options=JaxSampling(temperature=0.0),
                       eos_token_ids=[]),
            JaxContext, jax_collect))
    else:
        ref = _kernel_meaning_chain(kv)
    eng = TorchEngine(EngineConfig(model=cfg, kv_cache_dtype=kv, **ENGINE),
                      params=params, device="cpu")
    assert eng.k_cache.dtype == {"bfloat16": torch.bfloat16, "int8": torch.int8,
                                 "float8_e4m3": FP8}[kv]
    got = run(stream(eng, PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=StopConditions(max_tokens=ANSWER, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0), eos_token_ids=[]),
        Context, collect))
    assert got == ref, (kv, got, ref)


def test_dynamo_run_serves_the_gemma3_preset_at_small_depth():
    """``gemma3-12b-sim`` is a dynamo_run preset (the byte tokenizer, the
    published shapes); its forward at a depth of 2 and a narrow width
    serves on the CPU through the paged prefill, and the engine on the CPU
    takes a head width the card's kernels refuse (the plain twins take
    any)."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.launch.dynamo_run import PRESETS
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.launch import dynamo_run

    args = dynamo_run.parse_args(["in=http", "out=torch", "--model-path",
                                  "gemma3-12b-sim", "--device", "cpu"])
    cfg, tok, name, weights = dynamo_run.build_model(args)
    assert name == "gemma3-12b-sim" and weights is None
    assert isinstance(tok, ByteTokenizer)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(PRESETS[name]())
    small = ModelConfig.tiny(**{**GEMMA, "head_dim": 96, "num_layers": 2,
                                "layer_windows": (W, 0)})
    eng = TorchEngine(EngineConfig(model=small, num_blocks=16, block_size=4,
                                   max_batch_size=1, max_context=32),
                      device="cpu")
    kc, vc = llama.init_kv_cache(small, 8, 4)
    logits = llama.prefill(eng.params, small, torch.arange(12), torch.arange(
        1, 5, dtype=torch.int32), 0, 12, kc, vc)[0]
    assert logits.shape == (small.vocab_size,)
    assert bool(torch.isfinite(logits).all())


# ---------------- checkpoints ----------------


def _hf_gemma3(transformers, layers=6, **kw):
    """A tiny random Gemma3ForCausalLM (f32): head_dim 256, windows of 5
    on every layer but every sixth, query scale base 32, both ropes, every
    norm weight drawn (HF stores them as offsets from 1)."""
    cfg = transformers.Gemma3TextConfig(
        vocab_size=256, hidden_size=64, intermediate_size=112,
        num_hidden_layers=layers, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, head_dim=256, pad_token_id=0,
        query_pre_attn_scalar=32, sliding_window=5, rope_theta=1000000.0,
        rope_local_base_freq=10000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0}, **kw)
    torch.manual_seed(0)
    model = transformers.Gemma3ForCausalLM(cfg).eval()
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if "norm" in pname:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return model


def _save_f32(path, model):
    import json

    model.save_pretrained(path, safe_serialization=True)
    cfg_path = path / "config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["torch_dtype"] = "float32"
    cfg_path.write_text(json.dumps(cfg))
    return str(path)


TOKENS = [(t * 11) % 256 for t in range(12)]


@pytest.mark.parametrize("layout", ["text", "multimodal"])
def test_gemma3_checkpoint_matches_hf(layout, tmp_path):
    """The port's loader and dense_forward on a tiny Gemma-3 checkpoint
    against HF's logits (5e-4, the JAX package's tolerance for Gemma-3:
    tests/test_hf_parity.py), every leaf equal to the JAX loader's; the
    multimodal layout (``language_model.`` prefixed weights, the text
    config under ``text_config``, a vision config beside it) the same."""
    import json

    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "Gemma3TextConfig"):
        pytest.skip("transformers too old for Gemma-3")
    from dynamo_tpu.models.weights import load_llama_params as jax_load
    from dynamo_tpu_torch.models.weights import (
        SafetensorsFile,
        load_llama_params,
        write_safetensors,
    )

    model = _hf_gemma3(transformers)
    path = _save_f32(tmp_path, model)
    if layout == "multimodal":
        st = tmp_path / "model.safetensors"
        f = SafetensorsFile(str(st))
        tensors = {"language_model." + k: f.get(k).clone() for k in f.keys()}
        del f
        write_safetensors(str(st), tensors)
        text = json.loads((tmp_path / "config.json").read_text())
        (tmp_path / "config.json").write_text(json.dumps({
            "architectures": ["Gemma3ForConditionalGeneration"],
            "model_type": "gemma3", "torch_dtype": "float32",
            "text_config": {k: v for k, v in text.items()
                            if k not in ("architectures", "torch_dtype")},
            "vision_config": {"model_type": "siglip_vision_model"},
        }))
    cfg = ModelConfig.from_local_path(path)
    assert cfg.post_norms and cfg.qk_norm and cfg.rms_add_unit
    assert cfg.layer_windows == (5, 5, 5, 5, 5, 0) and cfg.dtype == "float32"
    params = load_llama_params(path, cfg, device="cpu")
    ours = llama.dense_forward(params, cfg, torch.tensor(TOKENS))
    with torch.no_grad():
        theirs = model(torch.tensor(TOKENS)[None]).logits[0]
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=5e-4, rtol=2e-3)
    jparams = jax_load(path, JaxModelConfig.from_local_path(path))
    flat = {("layers", k): v for k, v in params["layers"].items()}
    flat.update({(k,): v for k, v in params.items() if k != "layers"})
    for key, leaf in flat.items():
        ref = jparams[key[0]] if len(key) == 1 else jparams["layers"][key[1]]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref), err_msg=key)
    assert set(params["layers"]) == set(jparams["layers"])


def test_gemma3_saver_round_trip_and_the_reference_savers_qk_norms(tmp_path):
    """The port's saver writes every gemma norm as its offset (w - 1), so
    its file reads back through the port's loader bit for bit and its
    tensors equal the HF checkpoint's; the JAX package's saver leaves the
    per-head q/k norms folded (ROADMAP C.12): its file differs from the
    port's by exactly 1 on those and nowhere else."""
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "Gemma3TextConfig"):
        pytest.skip("transformers too old for Gemma-3")
    from dynamo_tpu.models.weights import save_llama_params as jax_save
    from dynamo_tpu_torch.models.weights import (
        SafetensorsFile,
        load_llama_params,
        save_llama_params,
    )

    model = _hf_gemma3(transformers, layers=2,
                       layer_types=["sliding_attention", "full_attention"])
    src = tmp_path / "hf"
    path = _save_f32(src, model)
    cfg = ModelConfig.from_local_path(path)
    params = load_llama_params(path, cfg, device="cpu")
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    save_llama_params(str(ours), params, cfg)
    (ours / "config.json").write_text((src / "config.json").read_text())
    again = load_llama_params(str(ours), cfg, device="cpu")
    for k, v in params["layers"].items():
        assert torch.equal(again["layers"][k], v), k
    for k in ("embed", "final_norm"):
        assert torch.equal(again[k], params[k]), k
    hf = SafetensorsFile(str(src / "model.safetensors"))
    mine = SafetensorsFile(str(ours / "model.safetensors"))
    for name in mine.keys():
        np.testing.assert_allclose(mine.get(name).numpy(), hf.get(name).numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    jcfg = JaxModelConfig.from_local_path(path)
    jax_save(str(theirs), {
        "embed": params["embed"].numpy(), "final_norm": params["final_norm"].numpy(),
        "layers": {k: v.numpy() for k, v in params["layers"].items()}}, jcfg)
    ref = SafetensorsFile(str(theirs / "model.safetensors"))
    assert set(ref.keys()) == set(mine.keys())
    for name in mine.keys():
        diff = ref.get(name).float() - mine.get(name).float()
        if name.endswith(("q_norm.weight", "k_norm.weight")):
            np.testing.assert_allclose(diff.numpy(), 1.0, rtol=0, atol=1e-6,
                                       err_msg=name)
        else:
            assert float(diff.abs().max()) == 0.0, name
