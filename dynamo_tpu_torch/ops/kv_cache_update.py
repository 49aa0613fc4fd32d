"""In-place KV-cache append: one new token per sequence, all layers at once.

Counterpart of ``dynamo_tpu/ops/kv_cache_update_pallas.py::kv_cache_append``.
The JAX version DONATES the caches and returns aliased outputs; this port
MUTATES ``k_cache``/``v_cache`` in place (and returns them, so call sites
read like the reference). On CUDA tensors it launches
``csrc/kv_cache_append.cu``; on CPU tensors it takes the plain version
(``index_put_``).

Merged decode uses it: the layer loop stacks each layer's new K/V ([L, B,
Hkv, D], tiny) and writes them with ONE call after attention, which
handled the current token out of the cache. The K and V rows may differ in
width: MLA's k cache holds the latent ``c_kv`` ``[L, 1, N, bs, C]`` and its
v cache the rotated ``k_pe`` ``[L, 1, N, bs, R]``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

_SRC = "kv_cache_append.cu"


def kv_cache_append_plain(k_new, v_new, k_cache, v_cache, blk, off):
    """``cache[l, :, blk[b], off[b]] = new[l, b]`` through ``index_put_``."""
    idx = (blk.long(), off.long())
    k_cache[:, :, idx[0], idx[1]] = k_new.permute(0, 2, 1, 3).to(k_cache.dtype)
    v_cache[:, :, idx[0], idx[1]] = v_new.permute(0, 2, 1, 3).to(v_cache.dtype)
    return k_cache, v_cache


def kv_cache_append(
    k_new: torch.Tensor,  # [L, B, Hkv, Dk] this step's keys, all layers
    v_new: torch.Tensor,  # [L, B, Hkv, Dv]
    k_cache: torch.Tensor,  # [L, Hkv, N, bs, Dk] — updated IN PLACE
    v_cache: torch.Tensor,  # [L, Hkv, N, bs, Dv] — updated IN PLACE
    blk: torch.Tensor,  # [B] int32 physical page of each sequence's slot
    off: torch.Tensor,  # [B] int32 row within that page
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one new token per sequence into both caches, in place.

    Live rows must have distinct ``blk`` entries (the allocator gives every
    sequence its own tail page); padded rows may all point at trash page 0,
    where their writes race harmlessly."""
    if k_cache.device.type == "cpu":
        return kv_cache_append_plain(k_new, v_new, k_cache, v_cache, blk, off)
    name = "kv_cache_append"
    _cuda.require_cuda(name, k_new, v_new, k_cache, v_cache, blk, off)
    _cuda.require_int32(name, blk, off)
    L, B, Hkv, Dk = k_new.shape
    Dv = v_new.shape[-1]
    N, bs = k_cache.shape[2:4]
    if (
        v_new.shape != (L, B, Hkv, Dv)
        or k_cache.shape != (L, Hkv, N, bs, Dk)
        or v_cache.shape != (L, Hkv, N, bs, Dv)
        or blk.shape != (B,) or off.shape != (B,)
    ):
        raise ValueError(f"{name}: shapes do not fit: new {tuple(k_new.shape)}"
                         f" / {tuple(v_new.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, "
                         f"blk {tuple(blk.shape)}")
    dtypes = {k_new.dtype, v_new.dtype, k_cache.dtype, v_cache.dtype}
    if len(dtypes) != 1 or k_cache.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"{name}: new rows and caches must share one of "
                         f"{list(_cuda.DTYPE_CODES)}, got {dtypes}")
    err = _cuda.lib(_SRC).kv_cache_append_launch(
        ctypes.c_void_p(k_new.data_ptr()), ctypes.c_void_p(v_new.data_ptr()),
        ctypes.c_void_p(k_cache.data_ptr()),
        ctypes.c_void_p(v_cache.data_ptr()),
        ctypes.c_void_p(blk.data_ptr()), ctypes.c_void_p(off.data_ptr()),
        L, B, Hkv, N, bs, Dk, Dv, _cuda.DTYPE_CODES[k_cache.dtype],
        ctypes.c_void_p(_cuda.stream_ptr(k_cache)),
    )
    _cuda.check(err, name)
    kv_cache_append.launches += 1
    return k_cache, v_cache


kv_cache_append.launches = 0
