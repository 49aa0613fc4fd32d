"""Grouped matmul with int8/fp8 expert weights: CUDA kernel + plain twins.

Counterpart of ``dynamo_tpu/ops/moe_gmm_pallas.py``. Shape contract (rows
sorted by expert, as the MoE dispatch hands them over):

    lhs          [R, K]    bf16/f32  rows sorted by expert
    w_q          [X, K, N] int8 or float8_e4m3fn, per-expert codes
    w_s          [X, N]    f32       per-(expert, output column) scales
    group_sizes  [X]       int       rows per expert (sum <= R)
    -> out       [R, N]    f32       == (lhs[rows_e] @ w_q[e]) * w_s[e]

Rows at or beyond ``sum(group_sizes)`` belong to no expert and come out as
exact zeros. On CUDA tensors :func:`ragged_int8_gmm` launches
``csrc/moe_gmm.cu`` (offsets from a device cumsum, no host sync); on CPU
tensors it takes :func:`ragged_int8_plain`. Two plain twins, because in
bf16 they round differently:

  * :func:`ragged_int8_plain` follows the KERNEL's formula: codes widened
    to the lhs dtype, products accumulated in f32, the scale applied after
    the dot;
  * :func:`ragged_int8_xla` follows the JAX package's XLA fallback:
    dequantize the stack to the lhs dtype, then the grouped product in the
    lhs dtype.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

_SRC = "moe_gmm.cu"
#: output columns of a per-expert block (csrc TN): N must be a multiple
TILE_N = 32
#: an expert's rows the kernel's few-rows (decode) mode takes (csrc RS);
#: a bf16 expert with more rows runs the tiled tensor-core blocks
FEW_ROWS = 4
#: the tiled blocks' output tile (csrc BM x BN) and K chunk (csrc BK)
TILE_M, TILE_NN, TILE_K = 128, 128, 64
#: f32 lhs: an expert with more than FEW_ROWS rows holds its whole K x 32
#: code tile in shared memory beside a 64 x 66 f32 row staging (csrc
#: core_smem), so K is bounded there; bf16 lhs streams the codes and takes
#: any K that is a multiple of 8
_SMEM_F32_FIXED = 64 * 66 * 4
_SMEM_MAX = 232448  # an H100 block's dynamic shared memory limit
_W_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}


def _groups(group_sizes: torch.Tensor):
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            yield e, start, start + n
        start += n


def ragged_int8_plain(lhs, w_q, w_s, group_sizes) -> torch.Tensor:
    """The kernel's formula, one product per expert with rows."""
    out = torch.zeros(lhs.shape[0], w_q.shape[-1], dtype=torch.float32,
                      device=lhs.device)
    for e, a, b in _groups(group_sizes):
        w = w_q[e].to(lhs.dtype).float()
        out[a:b] = (lhs[a:b].float() @ w) * w_s[e].float()
    return out


def ragged_int8_xla(lhs, w_q, w_s, group_sizes) -> torch.Tensor:
    """The reference's fallback: dequantize to the lhs dtype, then the
    grouped product in that dtype (output rounded to it), as f32."""
    w = (w_q.float() * w_s.float()[:, None, :]).to(lhs.dtype)
    out = torch.zeros(lhs.shape[0], w_q.shape[-1], dtype=torch.float32,
                      device=lhs.device)
    for e, a, b in _groups(group_sizes):
        out[a:b] = (lhs[a:b] @ w[e]).float()
    return out


def ragged_int8_gmm(
    lhs: torch.Tensor,  # [R, K] bf16/f32, rows sorted by expert
    w_q: torch.Tensor,  # [X, K, N] int8 / float8_e4m3fn
    w_s: torch.Tensor,  # [X, N] f32
    group_sizes: torch.Tensor,  # [X] rows per expert
) -> torch.Tensor:  # [R, N] f32, unowned rows 0
    """The quantized grouped matmul (module docstring)."""
    if lhs.device.type == "cpu":
        return ragged_int8_plain(lhs, w_q, w_s, group_sizes)
    name = "ragged_int8_gmm"
    R, K = lhs.shape
    X, Kw, N = w_q.shape
    _cuda.require_cuda(name, lhs, w_q, w_s, group_sizes)
    if lhs.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"{name}: lhs dtype {lhs.dtype} not supported")
    if w_q.dtype not in _W_CODES or w_s.dtype != torch.float32:
        raise ValueError(f"{name}: codes must be int8/float8_e4m3fn and "
                         f"scales f32, got {w_q.dtype} / {w_s.dtype}")
    if Kw != K or w_s.shape != (X, N) or group_sizes.shape != (X,):
        raise ValueError(f"{name}: shapes do not fit: lhs {tuple(lhs.shape)}, "
                         f"w_q {tuple(w_q.shape)}, w_s {tuple(w_s.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")
    if N % TILE_N:
        raise ValueError(f"{name}: N={N} must be a multiple of {TILE_N}")
    if lhs.dtype == torch.bfloat16 and K % 8:
        raise ValueError(f"{name}: bf16 rows stream in 16-byte copies: K={K} "
                         "must be a multiple of 8")
    if (lhs.dtype == torch.float32
            and K * TILE_N + _SMEM_F32_FIXED > _SMEM_MAX):
        raise ValueError(f"{name}: f32 rows take K at most "
                         f"{(_SMEM_MAX - _SMEM_F32_FIXED) // TILE_N}, got {K}")
    if w_q.data_ptr() % 16 or lhs.data_ptr() % 16:
        raise ValueError(f"{name}: the rows and the code stack must be "
                         "16-byte aligned")
    ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    out = torch.empty((R, N), dtype=torch.float32, device=lhs.device)
    err = _cuda.lib(_SRC).ragged_int8_gmm_launch(
        ctypes.c_void_p(lhs.data_ptr()), ctypes.c_void_p(w_q.data_ptr()),
        ctypes.c_void_p(w_s.data_ptr()), ctypes.c_void_p(ends.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), R, K, N, X,
        _cuda.DTYPE_CODES[lhs.dtype], _W_CODES[w_q.dtype],
        ctypes.c_void_p(_cuda.stream_ptr(lhs)),
    )
    _cuda.check(err, name)
    ragged_int8_gmm.launches += 1
    if R > FEW_ROWS * X:
        # more rows than the few-rows mode takes for every expert: at
        # least one expert ran the many-rows mode (a prompt's rows)
        ragged_int8_gmm.prefill_launches += 1
    return out


ragged_int8_gmm.launches = 0
#: the subset of ``launches`` with more than FEW_ROWS rows per expert
ragged_int8_gmm.prefill_launches = 0
