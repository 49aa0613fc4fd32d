"""The port's quantized serving path against the JAX package, on the CPU.

Same inputs (numpy, from a seed) through the JAX function and its port:

* weight quantization (``int8``, ``fp8_e4m3``, ``int8_native``; projection
  leaves, expert stacks and the MLA keys): codes and scales bit-equal, and
  ``from_jax_params`` carries the JAX codes over unchanged;
* ``ragged_int8_plain`` (the kernel's formula, what the CUDA kernel is held
  to) against the JAX Pallas kernel in interpret mode, int8 and fp8 codes,
  f32 and bf16 lhs, empty groups and unowned rows (exact zeros), within
  rtol 1e-5: codes widen exactly and the products are exact in f32, so
  only the order of the f32 sums differs; ``ragged_int8_xla`` against the
  JAX fallback;
* ``_mm`` with ``int8_native`` (an exact int32 product: f32 rounding only);
* the quantized KV append's plain twin against the JAX Pallas kernel in
  interpret mode, and both quantized writers against JAX's: codes, planes
  and ``n_requants`` bit-equal (page 0, the trash page, excluded). The JAX
  side runs jitted, as it serves: XLA then computes a division by the
  constant qmax as a product with its f32 reciprocal, and the port does
  the same, so the scales agree bit for bit;
* the three attention twins on int8 pages with per-page scales against the
  JAX Pallas kernels in interpret mode: outputs within 2e-5 (f32) and (m,
  l) within rtol 1e-3;
* a tiny GQA model (f32, int8 KV + int8 weights) and a tiny MLA + MoE model
  (int8 and fp8 weights) through prefill / merged decode window / mixed
  step against the JAX forward, with the same planes;
* ``TorchEngine`` with ``kv_cache_dtype="int8"`` (after tests/test_lowprec.py:
  planes, HBM accounting, recycled-page resets, prefix claims, requant
  counting, the ``load_metrics`` keys) and the refused pairs.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import mla as jmla_model
from dynamo_tpu.models import quant as jquant
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops.kv_cache_update_pallas import (
    kv_cache_append_quantized as j_append_q,
)
from dynamo_tpu.ops.moe_gmm_pallas import ragged_int8_gmm as j_gmm
from dynamo_tpu.ops.moe_gmm_pallas import ragged_int8_xla as j_gmm_xla
from dynamo_tpu.ops.paged_attention_pallas import (
    paged_decode_attention as j_decode,
)
from dynamo_tpu.ops.paged_attention_pallas import (
    paged_prefill_attention as j_prefill,
)
from dynamo_tpu.ops.ragged_paged_attention_pallas import (
    ragged_mixed_attention as j_ragged,
)
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import llama, quant
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import kv_cache_update as kvu
from dynamo_tpu_torch.ops import moe_gmm
from dynamo_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)
from dynamo_tpu_torch.ops.ragged_paged_attention import ragged_mixed_attention
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
    """Torch copies (the port updates caches and planes in place)."""
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _jit(fn, **static):
    """A JAX reference function jitted (one compile, not one per eager
    primitive), its non-array arguments fixed."""
    return jax.jit(functools.partial(fn, **static))


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a).astype(np.float32),
                               _np(b).astype(np.float32), rtol=tol, atol=tol)


def _codes(x):
    """Codes as raw bytes (int8 / fp8 compare bit for bit)."""
    if torch.is_tensor(x):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _same_quantized(tree, jtree):
    """Every leaf of the port's tree bit-equal to the JAX tree's."""
    assert tree.keys() == jtree.keys()
    for k, v in tree.items():
        if isinstance(v, dict):
            _same_quantized(v, jtree[k])
        elif v.dtype in (torch.int8, torch.float8_e4m3fn):
            np.testing.assert_array_equal(_codes(v), _codes(jtree[k]), err_msg=k)
        else:
            np.testing.assert_array_equal(_np(v), np.asarray(jtree[k], np.float32),
                                          err_msg=k)


# ---------------- weight quantization ----------------


def _to_jax(tree):
    """The port's parameter tree as JAX arrays, codes bit for bit."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if tree.dtype == torch.float8_e4m3fn:
        return jnp.asarray(tree.contiguous().view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    return jnp.asarray(tree.numpy())


def _key_tree(rng):
    """Every leaf quantize_params knows in both layer groups (projections,
    MLA keys, expert stacks) plus leaves it leaves alone, at two shapes: the
    JAX side quantizes eagerly, compiling each primitive once per shape."""
    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 7.0

    layer = {k: w(2, 24, 40) for k in jquant._QUANT_KEYS}
    layer.update({k: w(2, 3, 24, 40) for k in jquant._EXPERT_QUANT_KEYS})
    layer.update(attn_norm=w(2, 24), moe_gate=w(2, 24, 3))
    layer["wo"][1, :, 5] = 0.0  # an all-zero column: the 1e-12 scale floor
    return {"embed": w(16, 24), "layers": layer, "dense_layers": dict(layer)}


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3", "int8_native"])
def test_quantize_params_bit_equal_to_jax(mode):
    """Projection leaves, expert stacks (the "q" form even for
    int8_native) and the MLA keys: codes and scales bit-equal to the JAX
    package's, the other leaves untouched; int8_native codes stored
    column-major (the card's int8 product reads them so)."""
    cfg = ModelConfig.tiny_mla(**MOE)
    tree = _key_tree(np.random.default_rng(0))
    got = quant.quantize_params(jax.tree.map(torch.from_numpy, tree), cfg, mode)
    ref = jquant.quantize_params(jax.tree.map(jnp.asarray, tree),
                                 JaxModelConfig.tiny_mla(**MOE), mode)
    _same_quantized(got, ref)
    for key in jquant._EXPERT_QUANT_KEYS:
        assert "q" in got["layers"][key]
    for key in jquant._QUANT_KEYS:
        node = got["dense_layers"][key]
        assert ("qn" if mode == "int8_native" else "q") in node
        if mode == "int8_native":
            assert node["qn"].stride()[1:] == (1, 24)
    assert quant.quantize_params(got, cfg, mode)["layers"]["wo"] is \
        got["layers"]["wo"]  # idempotent


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3", "int8_native"])
def test_from_jax_params_carries_codes(mode):
    """A quantized JAX tree (numpy leaves, fp8 as ml_dtypes) of the tiny
    MLA + MoE model comes over code for code; int8_native column-major."""
    cfg = ModelConfig.tiny_mla(**MOE)
    got = quant.quantize_params(llama.init_params(cfg, torch.Generator().manual_seed(0)),
                                cfg, mode)
    ref = _to_jax(got)
    carried = from_jax_params(jax.tree.map(np.asarray, ref), cfg)
    _same_quantized(carried, ref)
    if mode == "int8_native":
        assert carried["layers"]["wo"]["qn"].stride(-2) == 1


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_quantize_array_bf16_and_dequantize_match_jax(mode):
    # the shape of _key_tree's projections: the eager JAX primitives that
    # follow the widening are compiled already
    w = np.random.default_rng(1).standard_normal((2, 24, 40)).astype(np.float32)
    w[1, :, 5] = 0.0  # an all-zero column: the 1e-12 scale floor
    tw = torch.from_numpy(w).to(torch.bfloat16)
    jw = jnp.asarray(w, jnp.bfloat16)
    got, ref = quant.quantize_array(tw, mode), jquant.quantize_array(jw, mode)
    np.testing.assert_array_equal(_codes(got["q"]), _codes(ref["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(ref["s"]))
    np.testing.assert_array_equal(quant.dequantize_array(got).numpy(),
                                  np.asarray(jquant.dequantize_array(ref)))


def test_int8_native_mm_matches_jax():
    """Per-row dynamic activation quantization, then an exact int32
    product: equal to the jitted JAX function to f32 rounding of the
    epilogue."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    w = rng.standard_normal((48, 24)).astype(np.float32)
    qw = quant.quantize_array(torch.from_numpy(w), "int8_native")
    jqw = jquant.quantize_array(jnp.asarray(w), "int8_native")
    got = llama._mm(torch.from_numpy(x), qw)
    ref = jax.jit(jllama._mm)(jnp.asarray(x), jqw)
    _close(got, ref, 1e-6)
    _close(llama._mm(torch.from_numpy(x), quant.quantize_array(
        torch.from_numpy(w), "int8")), jax.jit(jllama._mm)(
            jnp.asarray(x), jquant.quantize_array(jnp.asarray(w), "int8")), 1e-6)


# ---------------- ragged_int8_gmm ----------------

# the shapes of tests/test_moe_quant.py, with unowned rows added to the
# first: (rows, K, N, experts, group sizes, codes, lhs dtype)
GMM_CASES = [
    (24, 64, 128, 4, [7, 0, 9, 3], "int8", "float32"),  # 5 unowned rows
    (64, 32, 256, 8, [64, 0, 0, 0, 0, 0, 0, 0], "fp8_e4m3", "float32"),
    (40, 16, 128, 4, [1, 1, 1, 37], "int8", "bfloat16"),
    (16, 8, 128, 16, [1] * 16, "fp8_e4m3", "bfloat16"),
    (8, 128, 128, 4, [0, 0, 0, 0], "int8", "float32"),  # every row unowned
    (100, 48, 384, 6, [20, 0, 30, 10, 25, 15], "fp8_e4m3", "float32"),
]


def _gmm_inputs(r, k, n, x, sizes, codes, lhs_dt, seed=0):
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((r, k)).astype(np.float32)
    w = rng.standard_normal((x, k, n)).astype(np.float32)
    qw = quant.quantize_array(torch.from_numpy(w), codes)
    tdt = getattr(torch, lhs_dt)
    tl = torch.from_numpy(lhs).to(tdt)
    jl = jnp.asarray(lhs, jnp.bfloat16 if lhs_dt == "bfloat16" else jnp.float32)
    jq = (jnp.asarray(qw["q"].numpy()) if codes == "int8" else
          jnp.asarray(qw["q"].view(torch.uint8).numpy()).view(jnp.float8_e4m3fn))
    gs = np.asarray(sizes, np.int32)
    return (tl, qw["q"], qw["s"], torch.from_numpy(gs)), (
        jl, jq, jnp.asarray(qw["s"].numpy()), jnp.asarray(gs))


@pytest.mark.parametrize("case", GMM_CASES, ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}-{c[5]}-{c[6]}")
def test_ragged_int8_plain_matches_pallas_interpret(case):
    t_args, j_args = _gmm_inputs(*case)
    got = moe_gmm.ragged_int8_gmm(*t_args)  # CPU tensors: the plain twin
    ref = j_gmm(*j_args, tm=8, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (case[0], case[2])
    _close(got, ref, 1e-5)
    total = sum(case[4])
    assert (got[total:] == 0).all()  # unowned rows: exact zeros
    np.testing.assert_array_equal(np.asarray(ref)[total:], 0.0)


def _find_tile(sizes, t, tm, lo, hi):
    """The kernel's warp scan (csrc find_tile): tile ``t`` of the list that
    walks the experts in order, an expert of n rows giving ceil(n / tm)
    tiles when lo <= n <= hi; (expert, first row, rows) or None past the
    last tile (a surplus block)."""
    carry = start = 0
    for e, n in enumerate(sizes):
        tiles = -(-n // tm) if lo <= n <= hi else 0
        if carry <= t < carry + tiles:
            r0 = start + (t - carry) * tm
            return e, r0, min(tm, start + n - r0)
        carry += tiles
        start += n
    return None


def _gmm_emulation(lhs, w_q, w_s, group_sizes, sms=132):
    """The CUDA kernel's block list (csrc/moe_gmm.cu) in torch, for bf16
    rows, every product in f32 over codes widened to bf16, the scale after
    the sums: the tiled blocks, their grid sized by the host bound, each block's row tile found by the warp
    scan (expert-local tiles of TILE_M rows of experts with more than
    FEW_ROWS rows; surplus blocks write nothing), TILE_K-deep K chunks; the
    few-rows blocks of ``few_rows_plan`` (16-row slots x FEW_TILE_N
    columns x K splits; each warp's every FEW_WARPS-th 16-deep step, the
    warps' partials summed in warp order, the splits' in split order);
    then the zero blocks. Returns the output (NaN where no block wrote)
    and how many times each element was written."""
    R, K = lhs.shape
    X, _, N = w_q.shape
    sizes = group_sizes.tolist()
    out = torch.full((R, N), float("nan"))
    writes = torch.zeros(R, N, dtype=torch.int32)
    w = w_q.to(torch.bfloat16).float()
    x = lhs.float()
    plan = moe_gmm.few_rows_plan(R, K, N, X, sms)
    BM, BN, BK = moe_gmm.TILE_M, moe_gmm.TILE_NN, moe_gmm.TILE_K
    nb = -(-N // BN)
    n_tiled = nb * (-(-R // BM) + min(X, R // (moe_gmm.FEW_ROWS + 1)))
    for blk in range(n_tiled):
        found = _find_tile(sizes, blk // nb, BM, moe_gmm.FEW_ROWS + 1, R)
        if found is None:
            continue  # a surplus block
        e, r0, nr = found
        cols = slice((blk % nb) * BN, min(N, (blk % nb + 1) * BN))
        acc = torch.zeros(nr, cols.stop - cols.start)
        for k0 in range(0, K, BK):
            acc += x[r0:r0 + nr, k0:k0 + BK] @ w[e, k0:k0 + BK, cols]
        out[r0:r0 + nr, cols] = acc * w_s[e, cols]
        writes[r0:r0 + nr, cols] += 1
    FS, FW = moe_gmm.FEW_K, moe_gmm.FEW_WARPS
    nk = -(-K // FS)
    for slot in range(plan.slots):
        found = _find_tile(sizes, slot, moe_gmm.FEW_ROWS, 1, moe_gmm.FEW_ROWS)
        if found is None:
            continue  # a surplus block
        e, r0, nr = found
        rows = slice(r0, r0 + nr)
        for ct in range(plan.n_tn):
            cols = slice(ct * moe_gmm.FEW_TILE_N,
                         min(N, (ct + 1) * moe_gmm.FEW_TILE_N))
            seen, partials = [], []
            for z in range(plan.n_split):
                lo, end = z * plan.per, min(nk, (z + 1) * plan.per)
                assert lo < end  # every split holds a step
                warps = []
                for wp in range(FW):
                    acc = torch.zeros(nr, cols.stop - cols.start)
                    for s in range(lo + wp, end, FW):
                        seen.append(s)
                        ks = slice(s * FS, (s + 1) * FS)
                        acc += x[rows, ks] @ w[e, ks, cols]
                    warps.append(acc)
                block = warps[0]
                for acc in warps[1:]:  # the warps in order
                    block = block + acc
                partials.append(block)
            assert sorted(seen) == list(range(nk))  # K covered once
            total = partials[0]
            for p in partials[1:]:  # the splits in order
                total = total + p
            out[rows, cols] = total * w_s[e, cols]
            writes[rows, cols] += 1
    owned = sum(sizes)
    out[owned:] = 0.0  # the zero blocks
    writes[owned:] += 1
    return out, writes


@pytest.mark.parametrize("sizes", [[9, 0, 200, 3, 16, 130, 1], [0, 0, 5, 0]],
                         ids=["ragged tiles", "one expert of 5 rows"])
def test_tiled_gmm_blocks_fit_plain_and_pallas(sizes):
    """The tiled grouped GEMM's block list (row tiles from the device
    scan, ragged row tiles, the few-rows experts beside them, empty
    experts, zeroed unowned rows) covers every row of every column tile
    exactly once and equals ragged_int8_plain (f32 sums in another order:
    1e-5) and the JAX Pallas kernel in interpret mode; N = 160 leaves a
    partial 128-column tile, K = 96 a partial 64-deep chunk."""
    K, N = 96, 160
    R = sum(sizes) + 6
    t_args, j_args = _gmm_inputs(R, K, N, len(sizes), sizes, "int8", "bfloat16", 2)
    got, writes = _gmm_emulation(*t_args)
    assert (writes == 1).all()
    _close(got, moe_gmm.ragged_int8_plain(*t_args), 1e-5)
    _close(got, j_gmm(*j_args, interpret=True), 1e-5)
    assert (got[sum(sizes):] == 0).all()


@pytest.mark.parametrize("K,sms,n_split", [(520, 4, 1), (520, 16, 2), (776, 16, 3)],
                         ids=["one split", "2-way K split", "3-way K split"])
def test_few_rows_gmm_blocks_fit_plain_and_pallas(K, sms, n_split):
    """The few-rows (decode) blocks' plan: experts of 1, 4, 5 and 16 rows
    and empty ones, a 17-row expert on a tiled block beside the slots; K
    not a multiple of the 16-deep step, split across as many blocks as the
    grid needs to fill a card of ``sms`` SMs (a 4-SM card: none; a 16-SM
    card: 2 at K = 520, 3 at K = 776); N = 160, a partial 128-column tile:
    every element written once, K covered once per unit and merged in the
    plan's order, equal to ragged_int8_plain and to the JAX Pallas kernel
    in interpret mode (f32 sums in another order: 1e-5), unowned rows 0."""
    sizes = [1, 0, 4, 5, 16, 0, 17]
    N = 160
    R = sum(sizes) + 5
    t_args, j_args = _gmm_inputs(R, K, N, len(sizes), sizes, "fp8_e4m3", "bfloat16", 3)
    plan = moe_gmm.few_rows_plan(R, K, N, len(sizes), sms)
    assert plan.slots == len(sizes) and plan.n_split == n_split
    got, writes = _gmm_emulation(*t_args, sms=sms)
    assert (writes == 1).all()
    _close(got, moe_gmm.ragged_int8_plain(*t_args), 1e-5)
    _close(got, j_gmm(*j_args, interpret=True), 1e-5)
    assert (got[sum(sizes):] == 0).all()


@pytest.mark.parametrize("lhs_dt", ["float32", "bfloat16"])
def test_ragged_int8_xla_matches_jax_fallback(lhs_dt):
    """The dequantize-then-grouped-product twin rounds like JAX's: equal to
    f32 rounding at f32, and to one bf16 rounding of the output at bf16."""
    t_args, j_args = _gmm_inputs(40, 48, 64, 5, [9, 0, 12, 7, 8], "int8", lhs_dt, 1)
    got = moe_gmm.ragged_int8_xla(*t_args)
    ref = _jit(j_gmm_xla)(*j_args)
    _close(got, ref, 1e-5 if lhs_dt == "float32" else 1e-2)
    assert (got[36:] == 0).all()


# ---------------- quantized KV writes ----------------


def _int8_cache(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def test_append_quantized_twin_matches_pallas_interpret():
    """Scales grow on some pages and not on others (r == 1 round-trips),
    two padded rows share the trash page 0: codes, planes and n_requants
    equal, page 0 excluded from the codes."""
    rng = np.random.default_rng(4)
    L, B, Hkv, D, N, bs = 3, 6, 2, 16, 10, 8
    k_new = rng.standard_normal((L, B, Hkv, D)).astype(np.float32)
    v_new = rng.standard_normal((L, B, Hkv, D)).astype(np.float32) * 0.3
    kc, vc = _int8_cache(rng, (L, Hkv, N, bs, D)), _int8_cache(rng, (L, Hkv, N, bs, D))
    ks = (rng.uniform(0.005, 0.03, (L, N))).astype(np.float32)
    vs = (rng.uniform(0.001, 0.01, (L, N))).astype(np.float32)
    blk = np.asarray([3, 5, 0, 8, 0, 1], np.int32)
    off = np.asarray([0, 7, 2, 4, 5, 1], np.int32)
    tk, tv = _t(kc, vc)
    out = kvu.kv_cache_append_quantized(*_t(k_new, v_new), tk, tv, *_t(ks, vs, blk, off))
    assert out[0] is tk and out[1] is tv  # caches updated in place
    ref = j_append_q(*_j(k_new, v_new, kc, vc, ks, vs, blk, off), interpret=True)
    for got, want in zip(out[:2], ref[:2]):
        np.testing.assert_array_equal(got.numpy()[:, :, 1:], np.asarray(want)[:, :, 1:])
    for got, want in zip(out[2:4], ref[2:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert out[4].dtype == torch.int32 and int(out[4]) == int(ref[4]) > 0
    # some pages kept their scale (r == 1), and their other rows are intact
    kept = [(layer, p) for layer in range(L) for p in (3, 5, 8, 1)
            if out[2][layer, p] == ks[layer, p]]
    grown = [(layer, p) for layer in range(L) for p in (3, 5, 8, 1)
             if out[2][layer, p] > ks[layer, p]]
    assert kept and grown


# the batches of the in-place append: the twin test's rows (live pages that
# grow and pages that keep their scale, two padded rows on page 0), one row,
# and a batch that is all padding
_QBATCHES = {
    "mixed": ([3, 5, 0, 8, 0, 1], [0, 7, 2, 4, 5, 1]),
    "B1": ([6], [3]),
    "all_padding": ([0, 0, 0, 0], [1, 1, 6, 0]),
}


def _quant_append_inputs(batch, rows_dt, seed=4):
    """Numpy inputs at the twin test's shapes (L=3, Hkv=2, D=16, N=10,
    bs=8); rows rounded to bf16 first when ``rows_dt`` is bf16."""
    rng = np.random.default_rng(seed)
    blk, off = (np.asarray(a, np.int32) for a in _QBATCHES[batch])
    L, B, Hkv, D, N, bs = 3, len(blk), 2, 16, 10, 8
    k_new = rng.standard_normal((L, B, Hkv, D)).astype(np.float32)
    v_new = rng.standard_normal((L, B, Hkv, D)).astype(np.float32) * 0.3
    if rows_dt == "bfloat16":
        k_new, v_new = (torch.from_numpy(x).bfloat16().float().numpy()
                        for x in (k_new, v_new))
    kc, vc = _int8_cache(rng, (L, Hkv, N, bs, D)), _int8_cache(rng, (L, Hkv, N, bs, D))
    ks = (rng.uniform(0.005, 0.03, (L, N))).astype(np.float32)
    vs = (rng.uniform(0.001, 0.01, (L, N))).astype(np.float32)
    return k_new, v_new, kc, vc, ks, vs, blk, off


def _quant_append_reference(k_new, v_new, kc, vc, ks, vs, blk, off, rows_dt):
    dt = jnp.bfloat16 if rows_dt == "bfloat16" else jnp.float32
    kn, vn = (jnp.asarray(x).astype(dt) for x in (k_new, v_new))
    return j_append_q(kn, vn, *_j(kc, vc, ks, vs, blk, off), interpret=True)


def _assert_quant_append_equal(caches, planes, n, ref):
    """Codes bit-equal off page 0, planes and n_requants equal."""
    for got, want in zip(caches, ref[:2]):
        np.testing.assert_array_equal(got.numpy()[:, :, 1:], np.asarray(want)[:, :, 1:])
    for got, want in zip(planes, ref[2:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert n.dtype == torch.int32 and int(n) == int(ref[4])


@pytest.mark.parametrize("rows_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", list(_QBATCHES))
def test_append_quantized_rows_in_place_matches_pallas_interpret(batch, rows_dt):
    """The in-place fused append's plain twin (what merged decode calls)
    against the reference in interpret mode: the caches and both planes
    updated in place, codes bit-equal (page 0 excluded), planes bit-equal,
    n_requants equal; bf16 and f32 rows, one row, all padding."""
    k_new, v_new, kc, vc, ks, vs, blk, off = _quant_append_inputs(batch, rows_dt)
    dt = getattr(torch, rows_dt)
    tk, tv, tks, tvs = _t(kc, vc, ks, vs)
    n = kvu.append_quantized_rows(*(x.to(dt) for x in _t(k_new, v_new)), tk, tv,
                                  tks, tvs, *_t(blk, off))
    ref = _quant_append_reference(k_new, v_new, kc, vc, ks, vs, blk, off, rows_dt)
    _assert_quant_append_equal((tk, tv), (tks, tvs), n, ref)
    assert not np.array_equal(tks.numpy(), ks) or batch == "all_padding"


def _kernel_blocks(k_new, v_new, caches, planes, blk, off):
    """The quantized append as ``kv_append_quant_kernel`` cuts it, block by
    block in PyTorch: block (b, l, c) owns page blk[b] of layer l in cache c
    when no earlier row of the batch is on it; the owner reduces the amax
    over every row on its page (batch order), grows the scale, requantizes
    the page by r when r != 1 and the page is not page 0 (skipping the row
    that its row replaces), stores its rows; every block writes a 0/1 flag
    and the last one sums them. Returns (n_requants, owners, flags)."""
    L, B = k_new.shape[:2]
    inv = torch.tensor(1.0 / 127.0, dtype=torch.float32)
    owners, flags = {}, {}
    for c, (x, cache, scale) in enumerate(zip((k_new, v_new), caches, planes)):
        for l in range(L):
            for b in range(B):
                p = int(blk[b])
                old = scale[l, p].clone()
                if any(int(blk[j]) == p for j in range(b)):
                    flags[c, l, b] = 0
                    continue
                assert (c, l, p) not in owners
                owners[c, l, p] = b
                rows = [j for j in range(b, B) if int(blk[j]) == p]
                m = torch.stack([x[l, j].float().abs().amax() for j in rows]).amax()
                s = torch.maximum(old, torch.clamp_min(m * inv, 1e-12))
                r = old / s
                if s > old:
                    scale[l, p] = s
                if p != 0 and r != 1:
                    keep = torch.arange(cache.shape[3]) != int(off[b])
                    page = cache[l, :, p]
                    page[:, keep] = torch.clamp(torch.round(
                        page[:, keep].float() * r), -127, 127).to(torch.int8)
                for j in rows:
                    cache[l, :, p, int(off[j])] = torch.clamp(torch.round(
                        x[l, j].float() / s), -127, 127).to(torch.int8)
                flags[c, l, b] = int(s > old)
    return sum(flags[k] for k in sorted(flags)), owners, flags


@pytest.mark.parametrize("batch", list(_QBATCHES))
def test_quant_append_block_plan_matches_reference(batch):
    """The kernel's block plan: exactly one owner of page 0 per (cache,
    layer) when rows are padded, every live page owned once by its row,
    one flag per block, each grown (cache, layer, page) entry counted once;
    the result equal to the reference's (codes off page 0, planes,
    n_requants)."""
    k_new, v_new, kc, vc, ks, vs, blk, off = _quant_append_inputs(batch, "float32")
    caches, planes = _t(kc, vc), _t(ks, vs)
    n, owners, flags = _kernel_blocks(*_t(k_new, v_new), caches, planes, blk, off)
    L, B = k_new.shape[:2]
    assert len(flags) == 2 * L * B
    live = {int(p) for p in blk if p != 0}
    for c in range(2):
        for l in range(L):
            assert sum(1 for (cc, ll, p) in owners if (cc, ll, p) == (c, l, 0)) \
                == int((blk == 0).any())
            assert {p for (cc, ll, p) in owners if (cc, ll) == (c, l) and p} == live
            for b, p in enumerate(blk):
                if p != 0:
                    assert owners[c, l, int(p)] == b
    grown = int((planes[0].numpy() > ks).sum() + (planes[1].numpy() > vs).sum())
    assert n == grown == sum(flags.values())
    ref = _quant_append_reference(k_new, v_new, kc, vc, ks, vs, blk, off, "float32")
    _assert_quant_append_equal(caches, planes, torch.tensor(n, dtype=torch.int32), ref)


@pytest.mark.parametrize("valid", [11, 16])
def test_write_chunk_to_cache_quantized_bit_equal(valid):
    rng = np.random.default_rng(5)
    Hkv, N, bs, D, T, hist = 2, 12, 4, 16, 16, 6
    cache = _int8_cache(rng, (Hkv, N, bs, D))
    scales = rng.uniform(0.001, 0.02, N).astype(np.float32)
    chunk = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    chunk[3] *= 4.0  # one row grows its page's scale a lot
    table = rng.permutation(np.arange(1, N))[:6].astype(np.int32)
    tc, ts = _t(cache, scales)
    got_c, got_s = att.write_chunk_to_cache_quantized(
        tc, ts, *_t(chunk, table), hist, valid)
    ref_c, ref_s = jax.jit(jatt.write_chunk_to_cache_quantized)(
        *_j(cache, scales, chunk, table), jnp.int32(hist), jnp.int32(valid))
    assert got_c is tc
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


def test_write_decode_token_to_cache_quantized_bit_equal():
    rng = np.random.default_rng(6)
    Hkv, N, bs, D, B, M = 2, 14, 4, 16, 4, 3
    cache = _int8_cache(rng, (Hkv, N, bs, D))
    scales = rng.uniform(0.001, 0.02, N).astype(np.float32)
    rows = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N))[: B * M].reshape(B, M).astype(np.int32)
    tables[3] = 0  # an inactive slot writes the trash page
    positions = np.asarray([0, 5, 11, 0], np.int32)
    tc, ts = _t(cache, scales)
    got_c, got_s = att.write_decode_token_to_cache_quantized(
        tc, ts, *_t(rows, tables, positions))
    ref_c, ref_s = jax.jit(jatt.write_decode_token_to_cache_quantized)(
        *_j(cache, scales, rows, tables, positions))
    np.testing.assert_array_equal(got_c.numpy()[:, 1:], np.asarray(ref_c)[:, 1:])
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


# ---------------- attention over int8 pages ----------------


def _scaled_pages(rng, Hkv, N, bs, D):
    kc, vc = _int8_cache(rng, (Hkv, N, bs, D)), _int8_cache(rng, (Hkv, N, bs, D))
    ks = rng.uniform(0.002, 0.02, N).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, N).astype(np.float32)
    return kc, vc, ks, vs


def test_scaled_decode_twin_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    B, H, Hkv, D, bs, M = 4, 8, 2, 16, 8, 3
    N = B * M + 1
    kc, vc, ks, vs = _scaled_pages(rng, Hkv, N, bs, D)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N))[: B * M].reshape(B, M).astype(np.int32)
    seq_lens = np.asarray([1, 9, 24, 0], np.int32)
    scale = D ** -0.5
    o, m, l = paged_decode_attention(*_t(q, kc, vc, tables, seq_lens), scale,
                                     return_stats=True, k_scales=torch.from_numpy(ks),
                                     v_scales=torch.from_numpy(vs))
    jo, jm, jl = j_decode(*_j(q, kc, vc, tables, seq_lens), scale,
                          return_stats=True, interpret=True,
                          k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    _close(o, jo, 2e-5)
    np.testing.assert_allclose(_np(m)[:3], np.asarray(jm)[:3], rtol=1e-3)
    np.testing.assert_allclose(_np(l)[:3], np.asarray(jl)[:3], rtol=1e-3)
    # the merged decode and the dense oracle read the same scaled pages
    k_new = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    v_new = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    args = (q, k_new, v_new, kc, vc, tables, seq_lens)
    sc = dict(k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    jsc = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    _close(att.decode_attention_merged(*_t(*args), scale, **sc),
           _jit(jatt.decode_attention_merged, scale=scale, interpret=True)(
               *_j(*args), **jsc),
           2e-5)
    lens = seq_lens + 1
    _close(att.decode_attention_xla(*_t(q, kc, vc, tables, lens), scale, **sc),
           _jit(jatt.decode_attention_xla, scale=scale)(
               *_j(q, kc, vc, tables, lens), **jsc),
           2e-5)


def test_scaled_prefill_twin_matches_pallas_interpret():
    rng = np.random.default_rng(8)
    H, Hkv, D, bs, M = 4, 2, 16, 8, 6
    T, valid, hist = 16, 13, 19
    N = M + 4
    kc, vc, ks, vs = _scaled_pages(rng, Hkv, N, bs, D)
    table = rng.permutation(np.arange(1, N))[:M].astype(np.int32)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    scale = D ** -0.5
    sc = dict(k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    jsc = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    got = paged_prefill_attention(*_t(q, kc, vc, table), hist, scale, **sc)
    ref = j_prefill(*_j(q, kc, vc, table), jnp.int32(hist), scale,
                    interpret=True, **jsc)
    _close(got[:valid], np.asarray(ref)[:valid], 2e-5)
    k_chunk = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    v_chunk = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    dense = att.chunk_attention_with_cache_xla(
        *_t(q, k_chunk, v_chunk, kc, vc, table), hist, valid, scale, **sc)
    jdense = _jit(jatt.chunk_attention_with_cache_xla, scale=scale)(
        *_j(q, k_chunk, v_chunk, kc, vc, table), jnp.int32(hist),
        jnp.int32(valid), **jsc)
    _close(dense[:valid], np.asarray(jdense)[:valid], 2e-5)


def test_scaled_ragged_twin_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    B, Hkv, G, D, bs, M = 3, 2, 2, 16, 8, 6
    H = Hkv * G
    MP, T = 2, 16
    N = (B + MP) * M + 1
    kc, vc, ks, vs = _scaled_pages(rng, Hkv, N, bs, D)
    tables = rng.permutation(np.arange(1, N))[: (B + MP) * M].reshape(
        B + MP, M).astype(np.int32)
    d_tables, p_tables = tables[:B], tables[B:].copy()
    p_tables[1] = 0  # dead segment
    d_seq_lens = np.asarray([5, 0, 33], np.int32)
    p_hists, p_valids = np.asarray([9, 0], np.int32), np.asarray([13, 0], np.int32)
    q_dec = rng.standard_normal((B, H, D)).astype(np.float32)
    q_chunks = rng.standard_normal((MP, T, H, D)).astype(np.float32)
    scale = D ** -0.5
    args = (q_dec, q_chunks, kc, vc, d_tables, d_seq_lens, p_tables, p_hists,
            p_valids)
    o_dec, o_chunks = ragged_mixed_attention(
        *_t(*args), scale, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs))
    jo_dec, jo_chunks = j_ragged(*_j(*args), scale, q_tile=8, interpret=True,
                                 k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    _close(o_dec, jo_dec, 2e-5)
    _close(o_chunks[0, :13], np.asarray(jo_chunks)[0, :13], 2e-5)
    assert (o_dec[1] == 0).all() and (o_chunks[1] == 0).all()


# ---------------- tiny models, quantized ----------------


def _quantized_pair(jcfg, cfg, mode):
    """Tiny (f32) weights x5 quantized by the port, and the same codes and
    scales as the JAX tree (the port's quantization is bit-equal to the
    JAX package's, test_quantize_params_bit_equal_to_jax)."""
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    params = jax.tree.map(lambda t: t * (5.0 if t.dim() > 1 else 1.0), params)
    params = quant.quantize_params(params, cfg, mode)
    return jcfg, cfg, _to_jax(params), params


@functools.lru_cache(maxsize=None)
def _gqa(mode):
    """Tiny GQA; the kv cache is int8 with per-page scales."""
    return _quantized_pair(JaxModelConfig.tiny(dtype="float32"),
                           ModelConfig.tiny(dtype="float32"), mode)


@functools.lru_cache(maxsize=None)
def _mla(mode):
    return _quantized_pair(JaxModelConfig.tiny_mla(**MOE), ModelConfig.tiny_mla(**MOE),
                           mode)


def _int8_kv(cfg, rng):
    """An int8 cache with history already in it and its planes."""
    shape = llama.kv_cache_shapes(cfg, N_BLOCKS, BS)[0]
    kc, vc = _int8_cache(rng, shape), _int8_cache(rng, shape)
    L = cfg.num_layers
    ks = rng.uniform(0.005, 0.02, (L, N_BLOCKS)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (L, N_BLOCKS)).astype(np.float32)
    return kc, vc, ks, vs


def _greedy(B):
    z_f, z_i = np.zeros(B, np.float32), np.zeros(B, np.int32)
    return z_i, z_i, z_f, z_i, np.ones(B, np.float32)


def test_gqa_int8_kv_prefill_matches_jax():
    """Two references. JAX's prefill (XLA path) reads the chunk's own K/V
    at full precision where the port reads them back from the int8 cache
    (write-before-attend, the kernels' way): logits within 5e-2 (int8
    rounding of K/V, logits of magnitude ~1), greedy token equal, layer
    0's planes (written before any attention) equal to 1e-6 (the K/V rows
    feeding every plane come out of f32 GEMMs whose sums the two
    frameworks order differently, so a scale may differ in its last
    bits). JAX's fused mixed
    step with the chunk as its only live segment beside one inactive
    decode slot (its ragged Pallas kernel in interpret mode) reads the
    chunk back as the port does: logits within 1e-4, the planes of every
    page but the trash page equal, the codes within one step (a code can
    flip where the f32 sums of the two frameworks round apart)."""
    jcfg, cfg, jparams, params = _gqa("int8")
    rng = np.random.default_rng(10)
    kc, vc, ks, vs = _int8_kv(cfg, rng)
    T, hist, valid = 16, 8, 11
    table = rng.permutation(np.arange(1, N_BLOCKS))[:8].astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    jl, _, _, jks, jvs = jllama.prefill(
        jparams, jcfg, *_j(tokens, table), jnp.int32(hist), jnp.int32(valid),
        *_j(kc, vc), use_pallas=False, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs))
    tk, tv, tks, tvs = _t(kc, vc, ks, vs)
    tl, tk2, _, tks2, tvs2 = llama.prefill(params, cfg, *_t(tokens, table), hist,
                                           valid, tk, tv, tks, tvs)
    assert tk2 is tk and tks2 is tks  # updated in place
    _close(tl, jl, 5e-2)
    assert int(torch.argmax(tl)) == int(jnp.argmax(jl))
    _close(tks[0], jks[0], 1e-6)
    _close(tvs[0], jvs[0], 1e-6)
    # the chunk as the only live segment of a fused step (the shapes of
    # the mixed-step test below: two inactive decode slots, one dead segment)
    dec = (np.zeros(2, np.int32), np.zeros(2, np.int32),
           np.zeros((2, 8), np.int32), np.zeros(2, np.int32))
    pre = (np.stack([tokens, tokens]), np.stack([table, 0 * table]),
           np.asarray([hist, 0], np.int32), np.asarray([valid, 0], np.int32))
    jout = jllama.mixed_step(jparams, jcfg, *_j(*dec, *_greedy(2), *pre),
                             *_j(kc, vc), use_pallas=True, interpret=True,
                             k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    _close(tl, np.asarray(jout[1])[0], 1e-4)
    _close(tks[:, 1:], np.asarray(jout[4])[:, 1:], 1e-6)
    _close(tvs[:, 1:], np.asarray(jout[5])[:, 1:], 1e-6)
    for got, want in ((tk, jout[2]), (tv, jout[3])):
        diff = np.abs(got.numpy()[:, :, 1:].astype(int)
                      - np.asarray(want)[:, :, 1:].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_gqa_int8_kv_merged_decode_window_matches_jax():
    """The merged branch on both sides (JAX with its Pallas kernels in
    interpret mode): tokens exact and n_requants equal; every page but the
    trash page within one code step (at most 1% of them apart) and the
    planes within rtol 1e-4, since the K/V rows come out of f32 GEMMs
    summed in another order and the differences carry through the layers
    and the steps."""
    jcfg, cfg, jparams, params = _gqa("int8")
    rng = np.random.default_rng(11)
    kc, vc, ks, vs = _int8_kv(cfg, rng)
    B, M, n = 3, 6, 3
    tables = rng.permutation(np.arange(1, N_BLOCKS))[: B * M].reshape(B, M).astype(np.int32)
    tables[2] = 0  # inactive slot
    seq_lens = np.asarray([5, 13, 0], np.int32)
    positions = np.maximum(seq_lens - 1, 0).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    seeds, steps, temps, top_ks, top_ps = _greedy(B)
    jt, jk, jv, jks, jvs, jn = jllama.decode_window(
        jparams, jcfg, *_j(tokens, positions, tables, seq_lens, seeds, steps,
                           temps, top_ks, top_ps), *_j(kc, vc), n_steps=n,
        use_pallas=True, interpret=True, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs))
    tk, tv, tks, tvs = _t(kc, vc, ks, vs)
    tt, _, _, _, _, tn = llama.decode_window(
        params, cfg, *_t(tokens, positions, tables, seq_lens), [0] * B, [0] * B,
        *_t(temps, top_ks, top_ps), tk, tv, n_steps=n, k_scales=tks, v_scales=tvs)
    np.testing.assert_array_equal(tt.numpy()[:, :2], np.asarray(jt)[:, :2])
    for got, want in ((tk, jk), (tv, jv)):
        diff = np.abs(got.numpy()[:, :, 1:].astype(int)
                      - np.asarray(want)[:, :, 1:].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    _close(tks, jks, 1e-4)
    _close(tvs, jvs, 1e-4)
    assert int(tn) == int(jn) > 0


def test_gqa_int8_kv_mixed_step_matches_jax():
    """The fused mixed step (JAX: the ragged Pallas kernel in interpret
    mode with scales): tokens exact, the live segment's logits within
    1e-4, planes and n_requants equal."""
    jcfg, cfg, jparams, params = _gqa("int8")
    rng = np.random.default_rng(12)
    kc, vc, ks, vs = _int8_kv(cfg, rng)
    B, M, MP, T = 2, 8, 2, 16
    pages = rng.permutation(np.arange(1, N_BLOCKS))
    d_tables = np.asarray(pages[: B * M].reshape(B, M), np.int32)
    p_tables = np.zeros((MP, M), np.int32)
    p_tables[0] = pages[B * M: (B + 1) * M]  # segment 1 is dead
    d_seq_lens = np.asarray([9, 20], np.int32)
    dec = (rng.integers(0, cfg.vocab_size, B).astype(np.int32), d_seq_lens - 1,
           d_tables, d_seq_lens)
    pre = (rng.integers(0, cfg.vocab_size, (MP, T)).astype(np.int32), p_tables,
           np.asarray([4, 0], np.int32), np.asarray([12, 0], np.int32))
    samp = _greedy(B)
    jout = jllama.mixed_step(jparams, jcfg, *_j(*dec, *samp, *pre), *_j(kc, vc),
                             use_pallas=True, interpret=True,
                             k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    tk, tv, tks, tvs = _t(kc, vc, ks, vs)
    tout = llama.mixed_step(params, cfg, *_t(*dec), [0] * B, [0] * B,
                            *_t(*samp[2:]), *_t(*pre), tk, tv,
                            k_scales=tks, v_scales=tvs)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    _close(tout[1][0], np.asarray(jout[1])[0], 1e-4)
    _close(tks, jout[4], 1e-6)
    _close(tvs, jout[5], 1e-6)
    assert int(tout[6]) == int(jout[6]) > 0


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_mla_moe_quantized_weights_match_jax(mode):
    """Quantized MLA projections (wkv_b dequantized in bf16 for the
    absorbed fold) and expert stacks (ragged_int8_gmm's twin against JAX's
    dequantize-then-ragged_dot at f32): prefill logits to 1e-4 and its
    greedy token, then the merged decode window's greedy tokens exact
    (fp8: prefill only, the forwards are the int8 ones with other codes).
    The MLA mixed step is prefill and the merged decode body run one after
    the other (tests/test_torch_mla.py holds it to JAX's), so it has no
    weight path of its own to check here."""
    jcfg, cfg, jparams, params = _mla(mode)
    assert isinstance(params["layers"]["we_gate"], dict)
    rng = np.random.default_rng(13)
    ks_, vs_ = llama.kv_cache_shapes(cfg, N_BLOCKS, BS)
    kc = rng.standard_normal(ks_).astype(np.float32) * 0.5
    vc = rng.standard_normal(vs_).astype(np.float32) * 0.5
    T, hist, valid = 16, 8, 11
    table = rng.permutation(np.arange(1, N_BLOCKS))[:8].astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    jl, _, _ = jllama.prefill(jparams, jcfg, *_j(tokens, table), jnp.int32(hist),
                              jnp.int32(valid), *_j(kc, vc), use_pallas=False)
    tl, _, _ = llama.prefill(params, cfg, *_t(tokens, table), hist, valid,
                             *_t(kc, vc))
    _close(tl, jl, 1e-4)
    assert int(torch.argmax(tl)) == int(jnp.argmax(jl))
    if mode != "int8":
        return
    # merged decode window, three steps
    B, M, n = 2, 6, 3
    tables = rng.permutation(np.arange(1, N_BLOCKS))[: B * M].reshape(B, M).astype(np.int32)
    seq_lens = np.asarray([5, 13], np.int32)
    dec = (rng.integers(0, cfg.vocab_size, B).astype(np.int32),
           seq_lens - 1, tables, seq_lens)
    seeds, steps, temps, top_ks, top_ps = _greedy(B)
    jt, _, _ = jllama.decode_window(
        jparams, jcfg, *_j(*dec, seeds, steps, temps, top_ks, top_ps),
        *_j(kc, vc), n_steps=n, use_pallas=False)
    tt, _, _ = llama.decode_window(params, cfg, *_t(*dec), [0] * B, [0] * B,
                                   *_t(temps, top_ks, top_ps), *_t(kc, vc),
                                   n_steps=n)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_mla_int8_native_fails_in_the_reference_and_is_refused_by_the_port():
    """The JAX package's int8_native tree (the port's codes, bit-equal to
    its own, test_quantize_params_bit_equal_to_jax) breaks its MLA absorbed
    fold, which reads wkv_b's "q" key; the port refuses the pair."""
    jcfg, cfg = JaxModelConfig.tiny_mla(**MOE), ModelConfig.tiny_mla(**MOE)
    tree = llama.init_params(cfg, torch.Generator().manual_seed(0))
    qtree = quant.quantize_params(tree, cfg, "int8_native")
    jlp = jax.tree.map(lambda a: a[0], _to_jax(qtree)["layers"])
    with pytest.raises(KeyError, match="'q'"):
        jmla_model._wkv_b_parts(jlp, jcfg)
    with pytest.raises(ValueError, match="int8_native"):
        llama.prefill(qtree, cfg, torch.zeros(16, dtype=torch.int32),
                      torch.arange(1, 5, dtype=torch.int32), 0, 4,
                      *llama.init_kv_cache(cfg, 8, BS))
    with pytest.raises(ValueError, match="MLA.*int8_native"):
        TorchEngine(EngineConfig(model=cfg, num_blocks=16, block_size=BS,
                                 quantization="int8_native"),
                    params=tree, device="cpu")


# ---------------- the engine with the int8 device cache ----------------

GEOMETRY = dict(num_blocks=64, block_size=4, max_batch_size=4,
                max_context=128, prefill_chunk=32)


def _engine(**kw):
    cfg = ModelConfig.tiny(dtype="float32")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    return TorchEngine(EngineConfig(model=cfg, kv_cache_dtype="int8",
                                    quantization="int8", **GEOMETRY, **kw),
                       params=params, device="cpu")


async def _serve_tokens(eng, prompt, max_tokens=6):
    req = PreprocessedRequest(
        token_ids=list(prompt), stop_conditions=StopConditions(max_tokens=max_tokens),
        sampling_options=SamplingOptions(temperature=0.0))
    outs = await collect(eng.generate(Context(req)))
    return [t for o in outs for t in o.token_ids]


def test_engine_int8_cache_creates_planes_and_counts_hbm():
    eng = _engine()
    L = eng.cfg.model.num_layers
    assert eng.k_cache.dtype == torch.int8 and eng.v_cache.dtype == torch.int8
    assert eng.k_scales.shape == (L, GEOMETRY["num_blocks"])
    assert eng.k_scales is not eng.v_scales  # updated in place, one each
    assert (eng.k_scales == quant.KV_SCALE_EPS).all()
    assert isinstance(eng.params["layers"]["wq"], dict)  # weights quantized
    hbm = eng._hbm_stats()
    assert hbm["kv_pool"] == (eng.k_cache.nbytes + eng.v_cache.nbytes
                              + eng.k_scales.nbytes + eng.v_scales.nbytes)


def test_engine_refuses_unported_and_unsupported_kv_dtypes():
    """MLA refuses the int8 cache (ValueError, as the reference does); MLA
    builds over fp8 latent pages (no planes), and so does a GQA model, in
    the engine and through dynamo_run."""
    mla = ModelConfig.tiny_mla(**MOE)
    mla_params = llama.init_params(mla, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="MLA"):
        TorchEngine(EngineConfig(model=mla, kv_cache_dtype="int8", **GEOMETRY),
                    params=mla_params, device="cpu")
    eng = TorchEngine(EngineConfig(model=mla, kv_cache_dtype="float8_e4m3",
                                   **GEOMETRY), params=mla_params, device="cpu")
    assert eng.k_cache.dtype == torch.float8_e4m3fn
    assert eng.v_cache.dtype == torch.float8_e4m3fn and eng.k_scales is None
    assert eng.k_cache.shape[-1] == mla.kv_lora_rank
    eng = TorchEngine(EngineConfig(model=ModelConfig.tiny(),
                                   kv_cache_dtype="float8_e4m3", **GEOMETRY),
                      device="cpu")
    assert eng.k_cache.dtype == torch.float8_e4m3fn and eng.k_scales is None
    from dynamo_tpu_torch.launch import dynamo_run
    args = dynamo_run.parse_args(["in=http", "out=torch", "--model-path", "tiny",
                                  "--kv-cache-dtype", "float8_e4m3"])
    assert dynamo_run.engine_config(args, ModelConfig.tiny()).kv_cache_dtype == (
        "float8_e4m3")
    assert dynamo_run.engine_config(args, mla).kv_cache_dtype == "float8_e4m3"


def test_engine_decode_grows_scales_and_counts_requants(run):
    async def main():
        eng = _engine()
        try:
            toks = await _serve_tokens(eng, range(10, 42), max_tokens=12)
            assert len(toks) == 12
            assert eng._requants_dev is not None  # a device scalar until scraped
            lm = eng.load_metrics()
            assert eng._requants_dev is None
            for key in ("kv_device_quant_pages", "kv_device_requants_total",
                        "kv_device_bytes_saved_total"):
                assert lm[key] > 0, key
            assert "lowprec_tok_s" in lm and lm["hbm_kv_pool_bytes"] > 0
            assert (eng.k_scales > quant.KV_SCALE_EPS * 2).any()
        finally:
            await eng.close()

    run(main())


def test_engine_resets_recycled_scales_and_prefix_claims_keep_theirs(run):
    async def main():
        eng = _engine()
        try:
            eng.k_scales[:, 5] = 99.0
            eng.v_scales[:, 7] = 42.0
            before = eng.k_scales[:, 9].clone()
            eng._pending_scale_resets.extend([5, 7])
            eng._flush_scale_resets()
            assert (eng.k_scales[:, 5] == quant.KV_SCALE_EPS).all()
            assert (eng.v_scales[:, 7] == quant.KV_SCALE_EPS).all()
            assert torch.equal(eng.k_scales[:, 9], before)
            assert not eng._pending_scale_resets
            # every fresh allocation queues a reset, drained by the dispatch
            seen = []
            inner = eng.allocator.on_allocated
            eng.allocator.on_allocated = lambda i: (seen.append(i), inner(i))
            prompt = list(range(100, 124))
            first = await _serve_tokens(eng, prompt)
            assert seen and not eng._pending_scale_resets
            # a prefix re-serve (match_prefix claim: no reset) reproduces
            # the greedy stream
            hits0 = eng.stats["prefix_cache_hits_tokens"]
            again = await _serve_tokens(eng, prompt)
            assert eng.stats["prefix_cache_hits_tokens"] > hits0
            assert first == again
        finally:
            await eng.close()

    run(main())


def test_engine_int8_cache_serves_overlapping_requests(run):
    """Chunked prefill, fused mixed steps and decode windows over the int8
    cache with fp8 weights: every request gets its tokens."""
    async def main():
        cfg = ModelConfig.tiny(dtype="float32")
        eng = TorchEngine(EngineConfig(model=cfg, kv_cache_dtype="int8",
                                       quantization="fp8_e4m3", **GEOMETRY),
                          params=llama.init_params(cfg, torch.Generator().manual_seed(1)),
                          device="cpu")
        prompts = [(list(range(10, 80)), 6), (list(range(100, 145)), 5),
                   (list(range(200, 213)), 4)]

        async def one(i, p, n):
            await asyncio.sleep(0.002 * i)
            return await _serve_tokens(eng, p, n)

        try:
            got = await asyncio.gather(*[one(i, p, n) for i, (p, n) in enumerate(prompts)])
        finally:
            await eng.close()
        assert [len(g) for g in got] == [n for _, n in prompts]
        assert eng.stats["mixed_steps"] > 0 and eng.stats["decode_windows"] > 0

    run(main())
