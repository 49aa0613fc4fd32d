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
``csrc/moe_gmm.cu`` (one launch: each block reads ``group_sizes`` on the
device, no host sync); on CPU tensors it takes :func:`ragged_int8_plain`.
Two plain twins, because in bf16 they round differently:

  * :func:`ragged_int8_plain` follows the KERNEL's formula: codes widened
    to the lhs dtype, products accumulated in f32, the scale applied after
    the dot;
  * :func:`ragged_int8_xla` follows the JAX package's XLA fallback:
    dequantize the stack to the lhs dtype, then the grouped product in the
    lhs dtype.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _cuda

_SRC = "moe_gmm.cu"
#: output columns of an f32 per-expert block and of a zero block (csrc
#: TN): N must be a multiple
TILE_N = 32
#: an expert's rows the kernel's few-rows (decode) mode takes, one 16-row
#: slot (csrc FEW); a bf16 expert with more rows runs the tiled tensor-core
#: blocks
FEW_ROWS = 16
#: a few-rows block's output columns (csrc FTN), its warps (each taking
#: every WARPS-th 16-deep K step, csrc NW) and the K step
FEW_TILE_N, FEW_WARPS, FEW_K = 128, 8, 16
#: most K splits of a few-rows unit across blocks (csrc MAX_FSPLIT)
MAX_K_SPLITS = 16
#: the tiled blocks' output tile (csrc BM x BN) and K chunk (csrc BK)
TILE_M, TILE_NN, TILE_K = 128, 128, 64
#: f32 lhs: every expert holds its whole K x 32 code tile in shared memory
#: beside a 64 x 66 f32 row staging (csrc core_smem), so K is bounded there;
#: bf16 lhs streams the codes and takes any K that is a multiple of 8
_SMEM_F32_FIXED = 64 * 66 * 4
_SMEM_MAX = 232448  # an H100 block's dynamic shared memory limit
_W_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}


class FewPlan(NamedTuple):
    """How a bf16 launch cuts its few-rows work into blocks (``csrc/
    moe_gmm.cu`` few_rows_tile): ``slots`` (the 1-16 rows of one expert
    each, found on the device; min(X, R) bounds them) x ``n_tn`` column
    tiles of FEW_TILE_N x ``n_split`` K splits of ``per`` 16-deep steps."""

    slots: int
    n_tn: int
    n_split: int
    per: int


def few_rows_plan(R: int, K: int, N: int, X: int, sms: int = 132) -> FewPlan:
    """The few-rows blocks of a bf16 launch of ``R`` rows over ``X``
    experts. K splits across blocks only until the grid's bound on
    (slot, column tile) units fills the card once at 2 blocks per SM, and
    each warp keeps at least 2 steps of a split; every split holds a
    step."""
    slots = min(X, R)
    n_tn = -(-N // FEW_TILE_N)
    nk = -(-K // FEW_K)
    n_split = max(1, min(MAX_K_SPLITS, -(-2 * sms // max(1, slots * n_tn)),
                         nk // (2 * FEW_WARPS)))
    per = -(-nk // n_split)
    return FewPlan(slots, n_tn, -(-nk // per), per)


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
    group_sizes: torch.Tensor,  # [X] int64 / int32 rows per expert
) -> torch.Tensor:  # [R, N] f32, unowned rows 0
    """The quantized grouped matmul (module docstring)."""
    if lhs.device.type == "cpu":
        return ragged_int8_plain(lhs, w_q, w_s, group_sizes)
    name = "ragged_int8_gmm"
    R, K = lhs.shape
    X, Kw, N = w_q.shape
    dev = _cuda.require_cuda(name, lhs, w_q, w_s, group_sizes)
    if lhs.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"{name}: lhs dtype {lhs.dtype} not supported")
    if w_q.dtype not in _W_CODES or w_s.dtype != torch.float32:
        raise ValueError(f"{name}: codes must be int8/float8_e4m3fn and "
                         f"scales f32, got {w_q.dtype} / {w_s.dtype}")
    if group_sizes.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: group_sizes must be int32/int64, got "
                         f"{group_sizes.dtype}")
    group_sizes = group_sizes.long()  # the kernel reads int64 (the MoE route's)
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
    out = torch.empty((R, N), dtype=torch.float32, device=dev)
    plan = few_rows_plan(R, K, N, X, _cuda.sm_count(dev))
    part = tickets = None
    if lhs.dtype == torch.bfloat16 and plan.n_split > 1:
        units = plan.slots * plan.n_tn
        part = _cuda.device_buffer(
            "gmm partials", dev,
            units * plan.n_split * FEW_ROWS * FEW_TILE_N, torch.float32)
        tickets = _cuda.device_buffer("tickets", dev, units, torch.int32)
    err = _cuda.lib(_SRC).ragged_int8_gmm_launch(
        ctypes.c_void_p(lhs.data_ptr()), ctypes.c_void_p(w_q.data_ptr()),
        ctypes.c_void_p(w_s.data_ptr()),
        ctypes.c_void_p(group_sizes.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), R, K, N, X, plan.n_split,
        _ptr(part), _ptr(tickets),
        _cuda.DTYPE_CODES[lhs.dtype], _W_CODES[w_q.dtype],
        ctypes.c_void_p(_cuda.stream_ptr(lhs)),
    )
    _cuda.check(err, name)
    ragged_int8_gmm.launches += 1
    if lhs.dtype == torch.bfloat16 and R > FEW_ROWS * X:
        # more rows than the few-rows blocks take for every expert: at
        # least one expert ran the tiled blocks (a prompt's rows)
        ragged_int8_gmm.prefill_launches += 1
    return out


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


#: ``prefill_launches``: the subset of ``launches`` with bf16 rows, more
#: than FEW_ROWS per expert
_cuda.counted(ragged_int8_gmm, "prefill_launches")
