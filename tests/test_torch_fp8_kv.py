"""The scale-free fp8 KV cache (``kv_cache_dtype="float8_e4m3"``) in the port
against the JAX package, on the CPU.

Same inputs (numpy, from seeds) through the JAX function and its port:

* ``models/quant.to_e4m3`` against ``jnp.astype(float8_e4m3fn)`` byte for
  byte over all 65 536 bf16 bit patterns and a seeded f32 sample (NaN for
  ``|x| > 464`` and +-inf, where PyTorch's own cast saturates);
* the plain twins of the two appends (what the row-store kernel is held to
  on the card) against the JAX Pallas kernels in interpret mode, and the
  chunk and decode-token writers against the JAX ones: bytes equal,
  overflowing rows included;
* the three GQA attention twins (and the merged decode, the verify and the
  dense ``*_xla`` twins) over fp8 pages against the JAX functions (Pallas
  in interpret mode, or XLA), without and with a window and sinks at
  D = 64: within 2e-5 (f32 queries; the pages widen exactly on both sides);
* the tiny dense model and the tiny gpt-oss over an fp8 cache through
  prefill, the merged decode window, the fused mixed step and the verify
  against ``dynamo_tpu.models.llama``'s: greedy tokens exact, logits within
  the tolerances stated at each check;
* ``TorchEngine`` against ``JaxEngine`` with an fp8 cache (spec_gamma 0
  and 3): the same greedy tokens, ``load_metrics()`` keys and KV pool
  bytes; ``dynamo_run --kv-cache-dtype float8_e4m3`` builds an engine (GQA
  and MLA).

The reference's prefill paths round differently: its XLA path (the CPU's)
attends the chunk's own K/V at full width, its Pallas path reads them back
from the fp8 pages, as the port's kernels and twins do. Each port path is
held to the reference path of the same meaning, as the int8 cache's tests
do (tests/test_torch_quant.py).
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops.kv_cache_update_pallas import kv_cache_append as j_append
from dynamo_tpu.ops.kv_cache_update_pallas import (
    kv_cache_append_tokens as j_append_tokens,
)
from dynamo_tpu.ops.paged_attention_pallas import (
    paged_decode_attention as j_decode,
)
from dynamo_tpu.ops.paged_attention_pallas import (
    paged_prefill_attention as j_prefill,
)
from dynamo_tpu.ops.ragged_paged_attention_pallas import (
    ragged_mixed_attention as j_ragged,
)
from dynamo_tpu_torch.models import llama, quant
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import kv_cache_update as kvu
from dynamo_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)
from dynamo_tpu_torch.ops.ragged_paged_attention import ragged_mixed_attention
from tests.test_torch_gptoss import _jax_init, _tiny

FP8 = torch.float8_e4m3fn
TOL = dict(rtol=2e-5, atol=2e-5)


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


def _bytes(x):
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _f(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _close(got, ref, **tol):
    np.testing.assert_allclose(_f(got), _f(ref), **(tol or TOL))


def _j_cast(x):
    """The reference's cast, jitted as the JAX package runs it."""
    return np.asarray(jax.jit(lambda a: a.astype(jnp.float8_e4m3fn))(x))


def _fp8_pages(rng, shape):
    """fp8 pages of values up to ~8 (the reference's cast of N(0, 2))."""
    return (rng.standard_normal(shape) * 2).astype(np.float32).astype(
        ml_dtypes.float8_e4m3fn)


def _overflowing(rng, shape):
    """f32 rows with a share of values the two casts treat differently:
    above 464 (and the edge 464 / 465 / 466), +-inf and NaN, beside
    subnormal-sized and ordinary ones."""
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    flat = x.reshape(-1)
    special = np.asarray([464.0, -464.0, 465.0, -466.0, 500.0, -1e6, np.inf,
                          -np.inf, np.nan, 1e-3, -2.0 ** -10, 2.0 ** -9 * 1.5,
                          0.0, -0.0, 448.0, 456.0], np.float32)
    idx = rng.choice(flat.size, special.size, replace=False)
    flat[idx] = special
    return x


# ---------------- the cast ----------------


def test_to_e4m3_bytes_equal_the_reference_cast():
    """Every bf16 bit pattern and a seeded f32 sample: to_e4m3 stores the
    bytes of jnp's astype(float8_e4m3fn); PyTorch's own cast differs on
    exactly the 30 512 bf16 patterns with |x| >= 466 or +-inf (it
    saturates where the reference writes NaN)."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    xb = bits.view(ml_dtypes.bfloat16)
    ref = _j_cast(jnp.asarray(xb)).view(np.uint8)
    tb = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    np.testing.assert_array_equal(_bytes(quant.to_e4m3(tb)), ref)
    torch_cast = _bytes(tb.float().to(FP8))
    assert int((torch_cast != ref).sum()) == 30512
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (rng.standard_normal(50_000) * 150).astype(np.float32),
        rng.uniform(460, 470, 2_000).astype(np.float32) * rng.choice([-1, 1], 2_000),
        (rng.standard_normal(2_000) * 2.0 ** -8).astype(np.float32),
        np.asarray([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0], np.float32)])
    np.testing.assert_array_equal(_bytes(quant.to_e4m3(torch.from_numpy(x))),
                                  _j_cast(jnp.asarray(x)).view(np.uint8))


# ---------------- the appends and the writers ----------------


@pytest.mark.parametrize("tokens,rows", [(False, "float32"), (False, "bfloat16"),
                                         (True, "float32"), (True, "bfloat16")])
def test_append_twins_store_the_reference_bytes(tokens, rows):
    """kv_cache_append (one row per sequence) and kv_cache_append_tokens
    (T = 3 rows crossing a page) into fp8 caches, f32 and bf16 rows with
    overflowing values, against the JAX Pallas kernels in interpret mode
    (their store casts with .astype): every byte equal, the padded rows'
    trash page 0 excluded."""
    rng = np.random.default_rng(21 + 2 * tokens + (rows == "bfloat16"))
    L, B, Hkv, N, bs, D = 2, 3, 2, 12, 4, 16
    T = 3 if tokens else 1
    kc, vc = _fp8_pages(rng, (L, Hkv, N, bs, D)), _fp8_pages(rng, (L, Hkv, N, bs, D))
    jdt = jnp.bfloat16 if rows == "bfloat16" else jnp.float32
    k_new = np.array(jnp.asarray(_overflowing(rng, (L, B, T, Hkv, D))).astype(jdt))
    v_new = np.array(jnp.asarray(_overflowing(rng, (L, B, T, Hkv, D))).astype(jdt))
    off0 = np.asarray([2, 3, 0], np.int32)  # sequence 1's window crosses a page
    pos = off0[:, None] + np.arange(T)[None]
    first = np.asarray([5, 7, 0], np.int32)  # sequence 2 is padding (page 0)
    blk = np.where(pos < bs, first[:, None], first[:, None] + 1).astype(np.int32)
    blk[2] = 0
    off = (pos % bs).astype(np.int32)
    tk = lambda a: (  # noqa: E731  the same bits on both sides, NaN signs too
        torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        if rows == "bfloat16" else torch.from_numpy(a))
    if tokens:
        got = kvu.kv_cache_append_tokens(tk(k_new), tk(v_new), *_t(kc, vc, blk, off))
        ref = j_append_tokens(*_j(k_new, v_new, kc, vc, blk, off), interpret=True)
    else:
        got = kvu.kv_cache_append(tk(k_new[:, :, 0]), tk(v_new[:, :, 0]),
                                  *_t(kc, vc, blk[:, 0], off[:, 0]))
        ref = j_append(*_j(k_new[:, :, 0], v_new[:, :, 0], kc, vc, blk[:, 0],
                           off[:, 0]), interpret=True)
    for g, r in zip(got, ref):
        assert g.dtype == FP8
        np.testing.assert_array_equal(_bytes(g)[:, :, 1:], _bytes(r)[:, :, 1:])
    # the rows landed, NaN bytes where the reference's cast overflows
    assert (_bytes(got[0])[:, :, 1:] & 0x7F == 0x7F).any()


def test_chunk_and_decode_writers_store_the_reference_bytes():
    """write_chunk_to_cache (a padded chunk crossing pages) and
    write_decode_token_to_cache into an fp8 cache layer against the JAX
    package's XLA writers: bytes equal (page 0, the padded rows' trash,
    excluded)."""
    rng = np.random.default_rng(23)
    Hkv, N, bs, D, T = 2, 10, 4, 16, 7
    cache = _fp8_pages(rng, (Hkv, N, bs, D))
    chunk = _overflowing(rng, (T, Hkv, D))
    table = np.asarray([3, 6, 2, 0], np.int32)
    got = att.write_chunk_to_cache(*_t(cache, chunk, table), 5)
    ref = jax.jit(jatt.write_chunk_to_cache)(*_j(cache, chunk, table), jnp.int32(5))
    np.testing.assert_array_equal(_bytes(got)[:, 1:], _bytes(ref)[:, 1:])
    tok = _overflowing(rng, (3, Hkv, D))
    tables = np.asarray([[4, 8], [9, 1], [0, 0]], np.int32)
    positions = np.asarray([2, 5, 0], np.int32)
    got = att.write_decode_token_to_cache(*_t(cache, tok, tables, positions))
    ref = jax.jit(jatt.write_decode_token_to_cache)(*_j(cache, tok, tables, positions))
    np.testing.assert_array_equal(_bytes(got)[:, 1:], _bytes(ref)[:, 1:])


# ---------------- attention over fp8 pages ----------------


@pytest.mark.parametrize("D,window,with_sinks", [(16, 0, False), (64, 20, True)])
def test_attention_twins_over_fp8_pages_match_jax(D, window, with_sinks):
    """paged_decode_attention (with (m, l), and with the sink folded),
    paged_prefill_attention, ragged_mixed_attention, the merged decode and
    the verify over fp8 pages against the JAX Pallas kernels in interpret
    mode (their page reads cast to f32), and the dense decode / chunk
    twins against the JAX XLA paths: within 2e-5. At D = 64 with a window
    shorter than the histories and sinks (gpt-oss's options)."""
    rng = np.random.default_rng(31 + D)
    B, Hkv, G, bs, M = 3, 2, 4, 16, 5
    H = Hkv * G
    N = (B + 2) * M + 1
    kc, vc = _fp8_pages(rng, (Hkv, N, bs, D)), _fp8_pages(rng, (Hkv, N, bs, D))
    pages = rng.permutation(np.arange(1, N)).astype(np.int32)
    tables = pages[: B * M].reshape(B, M)
    p_tables = pages[B * M: (B + 2) * M].reshape(2, M)
    sinks = rng.standard_normal(H).astype(np.float32) + 2.0 if with_sinks else None
    ts = {} if sinks is None else {"sinks": torch.from_numpy(sinks)}
    js = {} if sinks is None else {"sinks": jnp.asarray(sinks)}
    scale = D ** -0.5
    cache = (kc, vc)

    seq_lens = np.asarray([0, 27, M * bs], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    args = (q, *cache, tables, seq_lens)
    o, m, l = paged_decode_attention(*_t(*args), scale, return_stats=True,
                                     window=window)
    jo, jm, jl = j_decode(*_j(*args), scale, return_stats=True, window=window,
                          interpret=True)
    for g, r in ((o, jo), (m, jm), (l, jl)):
        _close(g, r)
    if sinks is not None:
        _close(paged_decode_attention(*_t(*args), scale, window=window, **ts),
               jax.jit(jatt.decode_attention, static_argnames=(
                   "scale", "use_pallas", "window", "interpret"))(
                   *_j(*args), scale, use_pallas=True, window=window,
                   interpret=True, **js))

    T, hist = 16, 37
    qp = rng.standard_normal((T, H, D)).astype(np.float32)
    pargs = (qp, *cache, p_tables[0])
    _close(paged_prefill_attention(*_t(*pargs), hist, scale, window=window, **ts),
           j_prefill(*_j(*pargs), jnp.int32(hist), scale, window=window,
                     interpret=True, **js))

    p_hists = np.asarray([37, 5], np.int32)
    p_valids = np.asarray([T, 9], np.int32)
    qc = rng.standard_normal((2, T, H, D)).astype(np.float32)
    rargs = (q, qc, *cache, tables, seq_lens, p_tables, p_hists, p_valids)
    od, oc = ragged_mixed_attention(*_t(*rargs), scale, window=window, **ts)
    jd, jc = j_ragged(*_j(*rargs), scale, window=window, interpret=True, **js)
    _close(od[1:], jd[1:])  # slot 0 is inactive (the JAX rows are garbage)
    _close(oc[0], jc[0])
    _close(oc[1, :9], jc[1, :9])

    hist_lens = np.asarray([0, 30, 58], np.int32)
    vq = rng.standard_normal((B, 3, H, D)).astype(np.float32)
    kw, vw = (rng.standard_normal((B, 3, Hkv, D)).astype(np.float32) for _ in range(2))
    vargs = (vq, kw, vw, *cache, tables, hist_lens)
    _close(att.verify_attention(*_t(*vargs), scale, window=window, **ts),
           jax.jit(jatt.verify_attention, static_argnames=(
               "scale", "use_pallas", "window", "interpret"))(
               *_j(*vargs), scale, use_pallas=True, window=window,
               interpret=True, **js))
    margs = (vq[:, 0], kw[:, 0], vw[:, 0], *cache, tables, hist_lens)
    _close(att.decode_attention_merged(*_t(*margs), scale, window=window, **ts),
           jax.jit(jatt.decode_attention_merged, static_argnames=(
               "scale", "window", "interpret"))(
               *_j(*margs), scale, window=window, interpret=True, **js))
    if window:
        return
    # the dense twins read the pages widened to the query's type
    lens = seq_lens + 1
    _close(att.decode_attention_xla(*_t(q, *cache, tables, lens), scale),
           jax.jit(functools.partial(jatt.decode_attention_xla, scale=scale))(
               *_j(q, *cache, tables, lens)))
    kch, vch = (rng.standard_normal((T, Hkv, D)).astype(np.float32) for _ in range(2))
    dense = att.chunk_attention_with_cache_xla(
        *_t(qp, kch, vch, *cache, p_tables[0]), hist, 13, scale)
    jdense = jax.jit(functools.partial(jatt.chunk_attention_with_cache_xla,
                                       scale=scale))(
        *_j(qp, kch, vch, *cache, p_tables[0]), jnp.int32(hist), jnp.int32(13))
    _close(dense[:13], np.asarray(jdense)[:13])


def test_wrappers_refuse_scales_with_fp8_pages():
    """fp8 pages take no scale planes: the kernels' wrapper refuses them
    before it launches, and the model functions refuse planes beside an
    fp8 cache."""
    from dynamo_tpu_torch.ops.paged_attention import _kv_dtype_code

    kc = torch.zeros(2, 4, 16, 64, dtype=FP8)
    q = torch.zeros(1, 2, 4, 64, dtype=torch.bfloat16)
    assert _kv_dtype_code("x", q, kc, kc, None, None) == 3
    with pytest.raises(ValueError, match="no per-page scales"):
        _kv_dtype_code("x", q, kc, kc, torch.ones(4), torch.ones(4))
    cfg = ModelConfig.tiny(dtype="float32")
    with pytest.raises(ValueError, match="no scale planes"):
        llama._check_planes(cfg, kc, torch.ones(1), torch.ones(1))


# ---------------- the tiny models over an fp8 cache ----------------

N_BLOCKS, MBS = 48, 4


@functools.lru_cache(maxsize=None)
def _models(kind):
    """(JAX config, port config, JAX params, port params): the tiny dense
    model (its layers' matrices x5: decisive logits, and greedy answers
    that repeat, so prompt lookup proposes), or test_torch_gptoss's two-layer
    tiny gpt-oss (a 16-token window, sinks, biases, clamped MoE)."""
    if kind == "tiny-gptoss":
        return _tiny("tiny-gptoss")
    from dynamo_tpu_torch.models.weights import from_jax_params

    jcfg = JaxModelConfig.tiny(dtype="float32")
    cfg = ModelConfig.tiny(dtype="float32")
    jparams = jax.tree.map(lambda a: a * 5.0 if a.ndim > 2 else a,
                           _jax_init(jcfg, 2))
    return jcfg, cfg, jparams, from_jax_params(jax.tree.map(np.asarray, jparams), cfg)


def _caches(cfg, rng):
    shape = llama.kv_cache_shapes(cfg, N_BLOCKS, MBS)[0]
    return (rng.standard_normal(shape) * 0.5).astype(np.float32).astype(
        ml_dtypes.float8_e4m3fn), (rng.standard_normal(shape) * 0.5).astype(
        np.float32).astype(ml_dtypes.float8_e4m3fn)


def _near_bytes(got, want, pad=()):
    """fp8 pages written from K/V rows that two frameworks sum in another
    order: every byte equal but a few adjacent codes (a row value on a
    rounding edge), under 1% of the written ones. Page 0 (the trash page)
    and ``pad``, the slots of a chunk's padded rows (garbage that nothing
    reads, which the two write differently), are excluded."""
    g, w = _bytes(got).astype(int), _bytes(want).astype(int)
    for page, off in pad:
        g[:, :, page, off] = w[:, :, page, off]
    d = np.abs(g[:, :, 1:] - w[:, :, 1:])
    assert d.max() <= 1, d.max()
    assert (d > 0).sum() < 0.01 * (_bytes(got) != _bytes(np.asarray(want))).size


def _pad_slots(table, hist, valid, T):
    return [(int(table[p // MBS]), p % MBS) for p in range(hist + valid, hist + T)]


def _greedy(B):
    z_f, z_i = np.zeros(B, np.float32), np.zeros(B, np.int32)
    return z_i, z_i, z_f, z_i, np.ones(B, np.float32)


@pytest.mark.parametrize("kind", ["dense", "tiny-gptoss"])
def test_tiny_model_paths_over_fp8_match_jax(kind):
    """prefill, a 3-step merged decode window, the fused mixed step and a
    gamma-3 verify over an fp8 cache with history in it.

    * prefill against the reference's XLA prefill (its CPU path, which
      attends the chunk's own K/V at full width where the port reads them
      back from the fp8 pages): argmax equal, logits within 5e-2 (the
      chunk's K/V rounded to e4m3's 4 significant bits on one side only;
      logits of magnitude ~0.5); then against the
      reference's fused mixed step with the chunk as its only live segment
      (its ragged Pallas kernel in interpret mode reads the chunk back as
      the port does): logits within 1e-4, pages within one code;
    * the merged decode window and the mixed step against the reference's
      (Pallas in interpret mode): tokens exact, segment logits within
      1e-4, pages within one code;
    * the verify against the reference's (its XLA verify keeps the
      in-flight window at full width, as the port's merge does): tokens
      and accepted counts exact, logprobs within 1e-4."""
    jcfg, cfg, jparams, params = _models(kind)
    rng = np.random.default_rng(41)
    kc, vc = _caches(cfg, rng)
    V, M = cfg.vocab_size, 11
    pages = rng.permutation(np.arange(1, N_BLOCKS)).astype(np.int32)

    # ---- prefill: 16 rows (13 real) after 24 cached tokens ----
    table = pages[:M]
    tokens = rng.integers(0, V, 16).astype(np.int32)
    jl, jk, _ = jllama.prefill(jparams, jcfg, *_j(tokens, table), jnp.int32(24),
                               jnp.int32(13), *_j(kc, vc), use_pallas=False)
    tk, tv = _t(kc, vc)
    tl, tk2, _ = llama.prefill(params, cfg, *_t(tokens, table), 24, 13, tk, tv)
    assert tk2 is tk and tk.dtype == FP8
    _close(tl, jl, rtol=5e-2, atol=5e-2)
    assert int(tl.argmax()) == int(jnp.argmax(jl))
    dec = (np.zeros(2, np.int32), np.zeros(2, np.int32),
           np.zeros((2, M), np.int32), np.zeros(2, np.int32))
    pre = (np.stack([tokens, tokens]), np.stack([table, 0 * table]),
           np.asarray([24, 0], np.int32), np.asarray([13, 0], np.int32))
    jout = jllama.mixed_step(jparams, jcfg, *_j(*dec, *_greedy(2), *pre),
                             *_j(kc, vc), use_pallas=True, interpret=True)
    _close(tl, np.asarray(jout[1])[0], rtol=1e-4, atol=1e-4)
    pad = _pad_slots(table, 24, 13, 16)
    _near_bytes(tk, jout[2], pad)
    _near_bytes(tv, jout[3], pad)

    # ---- a 3-step merged decode window (an inactive slot) ----
    B = 3
    tables = pages[: B * M].reshape(B, M).copy()
    tables[2] = 0
    seq_lens = np.asarray([5, 29, 0], np.int32)
    positions = np.maximum(seq_lens - 1, 0).astype(np.int32)
    last = rng.integers(0, V, B).astype(np.int32)
    seeds, steps, temps, top_ks, top_ps = _greedy(B)
    jt, jk, jv = jllama.decode_window(
        jparams, jcfg, *_j(last, positions, tables, seq_lens, seeds, steps,
                           temps, top_ks, top_ps), *_j(kc, vc), n_steps=3,
        use_pallas=True, interpret=True)
    tk, tv = _t(kc, vc)
    tt, tk, tv = llama.decode_window(
        params, cfg, *_t(last, positions, tables, seq_lens), [0] * B, [0] * B,
        *_t(temps, top_ks, top_ps), tk, tv, n_steps=3)
    np.testing.assert_array_equal(tt.numpy()[:, :2], np.asarray(jt)[:, :2])
    _near_bytes(tk, jk)
    _near_bytes(tv, jv)

    # ---- the fused mixed step: 2 decode rows + a segment (one dead) ----
    d_tables = pages[: 2 * M].reshape(2, M)
    p_tables = np.zeros((2, M), np.int32)
    p_tables[0] = pages[2 * M: 3 * M]
    d_seq_lens = np.asarray([9, 30], np.int32)
    dec = (rng.integers(0, V, 2).astype(np.int32), d_seq_lens - 1, d_tables,
           d_seq_lens)
    pre = (rng.integers(0, V, (2, 16)).astype(np.int32), p_tables,
           np.asarray([20, 0], np.int32), np.asarray([12, 0], np.int32))
    jn, jpl, jk, jv = jllama.mixed_step(
        jparams, jcfg, *_j(*dec, *_greedy(2), *pre), *_j(kc, vc),
        use_pallas=True, interpret=True)
    tk, tv = _t(kc, vc)
    tn, tpl, tk, tv = llama.mixed_step(
        params, cfg, *_t(*dec), [0] * 2, [0] * 2, *_t(*_greedy(2)[2:]), *_t(*pre),
        tk, tv)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _close(tpl[0], jpl[0], rtol=1e-4, atol=1e-4)
    pad = _pad_slots(p_tables[0], 20, 12, 16)
    _near_bytes(tk, jk, pad)
    _near_bytes(tv, jv, pad)

    # ---- the verify: 3 proposals per row, the second row's from the
    # port's own greedy chain (so it accepts), logprobs of every position
    window = rng.integers(0, V, (2, 4)).astype(np.int32)
    vpos, vlens = np.asarray([4, 27], np.int32), np.asarray([5, 28], np.int32)
    z2 = _greedy(2)
    chain = llama.decode_window(
        params, cfg, *_t(window[:, 0], vpos, d_tables, vlens), [0] * 2, [0] * 2,
        *_t(*z2[2:]), *_t(kc, vc), n_steps=3)[0]
    window[1, 1:] = chain.numpy()[:, 1]
    common = (window, window[:, 1:].copy(), vpos, d_tables, vlens)
    jout = jllama.verify_window(
        jparams, jcfg, *_j(*common, [0, 0], [0, 0], z2[2], z2[3], z2[4], kc, vc),
        n_spec=3, with_logprobs=True)
    tk, tv = _t(kc, vc)
    tout = llama.verify_window(params, cfg, *_t(*common), [0, 0], [0, 0],
                               *_t(*z2[2:]), tk, tv, n_spec=3, with_logprobs=True)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    assert int(tout[1][1]) == 3
    for got, want in zip(tout[4], jout[4]):
        _close(got, want, rtol=1e-4, atol=1e-4)
    _near_bytes(tout[2], jout[2])


# ---------------- the engine ----------------

GEOMETRY = dict(num_blocks=32, block_size=4, max_batch_size=2, max_context=64,
                prefill_chunk=8, kv_cache_dtype="float8_e4m3")


@pytest.mark.parametrize("kind", ["dense", "tiny-gptoss"])
def test_torch_engine_matches_jax_engine_over_fp8(kind, run):
    """TorchEngine and JaxEngine over an fp8 cache on one tiny model (8-token
    prefill chunks that cross the tiny gpt-oss's window, 4-step windows): the same greedy tokens with
    spec_gamma=0 and with spec_gamma=3 (2-gram prompt lookup: proposals
    made and verified over fp8 pages), the same load_metrics() keys and
    KV pool bytes. JaxEngine on the CPU runs the reference's XLA paths
    (its chunks attend their own K/V at full width, its decode steps read
    the new token back from the fp8 page); the port runs the kernels'
    meaning; the greedy tokens agree all the same."""
    from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine import JaxEngine
    from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
    from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
    from dynamo_tpu.protocols.common import StopConditions as JaxStops
    from dynamo_tpu.runtime import Context as JaxContext
    from dynamo_tpu.runtime import collect as jax_collect
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime import Context, collect

    jcfg, cfg, jparams, params = _models(kind)
    prompt = [(11 * i + 5) % cfg.vocab_size for i in range(9)] * 2
    n = 17

    async def stream(engine, req, ctx, collect_fn):
        try:
            outs = await collect_fn(engine.generate(ctx(req)))
        finally:
            await engine.close()
        return [t for o in outs for t in o.token_ids]

    jeng = JaxEngine(JaxEngineConfig(model=jcfg, **GEOMETRY), params=jparams)
    ref = run(stream(
        jeng, JaxRequest(token_ids=list(prompt),
                         stop_conditions=JaxStops(max_tokens=n, ignore_eos=True),
                         sampling_options=JaxSampling(temperature=0.0),
                         eos_token_ids=[]),
        JaxContext, jax_collect))
    jm = jeng.load_metrics()
    for gamma in (0, 3):
        eng = TorchEngine(EngineConfig(model=cfg, spec_gamma=gamma, spec_ngram=2,
                                       **GEOMETRY), params=params, device="cpu")
        assert eng.k_cache.dtype == FP8 and eng.k_scales is None
        got = run(stream(eng, PreprocessedRequest(
            token_ids=list(prompt),
            stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0), eos_token_ids=[]),
            Context, collect))
        assert got == ref, (gamma, got, ref)
        if gamma:
            assert eng.stats["spec_proposed"] > 0
            assert eng.stats["spec_accepted"] > 0
        tm = eng.load_metrics()
        assert set(tm) == set(jm)
        assert tm["hbm_kv_pool_bytes"] == jm["hbm_kv_pool_bytes"]
        assert tm["kv_block_bytes"] == jm["kv_block_bytes"]


def test_dynamo_run_builds_fp8_engines_gqa_and_mla():
    """``--kv-cache-dtype float8_e4m3`` builds a served engine over fp8
    pages (no planes); the same flag on an MLA model builds over fp8
    latent pages, in the launcher and in the engine."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.launch import dynamo_run

    args = dynamo_run.parse_args(["in=http", "out=torch", "--model-path", "tiny",
                                  "--device", "cpu", "--num-blocks", "16",
                                  "--kv-cache-dtype", "float8_e4m3"])
    _worker, engine, _name = dynamo_run.build_engine(args)
    try:
        assert engine.k_cache.dtype == FP8 and engine.v_cache.dtype == FP8
        assert engine.k_scales is None
        assert engine._hbm_stats()["kv_pool"] == (engine.k_cache.numel()
                                                  + engine.v_cache.numel())
    finally:
        asyncio.run(engine.close())
    mla = ModelConfig.tiny_mla()
    assert dynamo_run.engine_config(args, mla).kv_cache_dtype == "float8_e4m3"
    eng = TorchEngine(EngineConfig(model=mla, num_blocks=8, block_size=4,
                                   max_batch_size=1, kv_cache_dtype="float8_e4m3"),
                      device="cpu")
    assert eng.k_cache.dtype == FP8 and eng.v_cache.dtype == FP8
    assert eng.k_scales is None and eng.v_scales is None
    assert eng._hbm_stats()["kv_pool"] == eng.k_cache.numel() + eng.v_cache.numel()
