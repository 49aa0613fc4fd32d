"""In-place KV-cache appends, all layers at once.

Counterparts of ``dynamo_tpu/ops/kv_cache_update_pallas.py``:
:func:`kv_cache_append` (one new token per sequence) and
:func:`kv_cache_append_tokens` (T <= bs consecutive rows per sequence, the
speculative verify's in-flight window). The JAX versions DONATE the caches
and return aliased outputs; this port MUTATES ``k_cache``/``v_cache`` in
place (and returns them, so call sites read like the reference). On CUDA
tensors both launch the one row-store kernel of ``csrc/kv_cache_append.cu``
(``kv_rows_kernel``, a block per (layer, sequence, token) row group; the
one-token append is its T = 1 case); on CPU tensors they take the plain
version (``index_put_``). Into a ``float8_e4m3fn`` cache the kernel casts
f32 / bf16 rows on store with the reference's overflow (NaN above 464),
as ``models/quant.to_e4m3`` does for the plain version.

Merged decode and the verify use them: the layer loop stacks each layer's
new K/V ([L, B, (T,) Hkv, D], tiny) and writes them with ONE call after
attention, which handled the new tokens out of the cache. The K and V rows
may differ in width: MLA's k cache holds the latent ``c_kv`` ``[L, 1, N,
bs, C]`` and its v cache the rotated ``k_pe`` ``[L, 1, N, bs, R]``.

:func:`kv_cache_append_quantized` is the append of the int8-with-scales
cache (``dynamo_tpu/ops/kv_cache_update_pallas.py::kv_cache_append_quantized``):
the scale math, the page read-modify-write, the rows and ``n_requants`` in
one CUDA launch (:func:`append_quantized_rows`, which grows the planes in
place; merged decode calls it directly). Its plain twin
:func:`append_quantized_rows_plain` (:func:`quant_scale_update`, then the
read-modify-write in PyTorch) runs on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.quant import KV_INT8_QMAX, KV_SCALE_EPS, store_codes
from . import _cuda

_SRC = "kv_cache_append.cu"


def kv_cache_append_tokens_plain(k_new, v_new, k_cache, v_cache, blk, off):
    """``cache[l, :, blk[b, t], off[b, t]] = new[l, b, t]`` through
    ``index_put_``, cast to the cache's type (an fp8 cache with the
    reference's cast, ``models/quant.to_e4m3``)."""
    lidx = torch.arange(k_new.shape[0], device=k_new.device)[:, None, None]
    b, o = blk.long()[None], off.long()[None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        target, values = store_codes(cache, new)
        target[lidx, :, b, o] = values
    return k_cache, v_cache


def kv_cache_append_plain(k_new, v_new, k_cache, v_cache, blk, off):
    """``cache[l, :, blk[b], off[b]] = new[l, b]`` through ``index_put_``."""
    return kv_cache_append_tokens_plain(k_new[:, :, None], v_new[:, :, None],
                                        k_cache, v_cache, blk[:, None],
                                        off[:, None])


def _launch_rows(name, k_new, v_new, k_cache, v_cache, blk, off) -> None:
    """Validate and launch ``kv_cache_append_tokens_launch``: ``k_new [L,
    B, T, Hkv, Dk]``, ``v_new [L, B, T, Hkv, Dv]``, ``blk``/``off [B, T]``
    int32, every tensor contiguous on one card; the rows and the caches of
    one dtype, or f32 / bf16 rows into ``float8_e4m3fn`` caches (cast on
    store, the reference's bytes). Raises on what the kernel does not
    take."""
    _cuda.require_cuda(name, k_new, v_new, k_cache, v_cache, blk, off)
    _cuda.require_int32(name, blk, off)
    L, B, T, Hkv, Dk = k_new.shape
    Dv = v_new.shape[-1]
    N, bs = k_cache.shape[2:4]
    if (
        v_new.shape != (L, B, T, Hkv, Dv)
        or k_cache.shape != (L, Hkv, N, bs, Dk)
        or v_cache.shape != (L, Hkv, N, bs, Dv)
        or blk.shape != (B, T) or off.shape != (B, T)
    ):
        raise ValueError(f"{name}: shapes do not fit: new {tuple(k_new.shape)}"
                         f" / {tuple(v_new.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, "
                         f"blk {tuple(blk.shape)}")
    rows = {k_new.dtype, v_new.dtype}
    caches = {k_cache.dtype, v_cache.dtype}
    if (len(rows) != 1 or len(caches) != 1
            or k_new.dtype not in _cuda.DTYPE_CODES
            or k_cache.dtype not in (k_new.dtype, torch.float8_e4m3fn)):
        raise ValueError(f"{name}: new rows of one of "
                         f"{list(_cuda.DTYPE_CODES)} into caches of their "
                         f"dtype or float8_e4m3fn, got rows {rows}, caches "
                         f"{caches}")
    err = _cuda.lib(_SRC).kv_cache_append_tokens_launch(
        ctypes.c_void_p(k_new.data_ptr()), ctypes.c_void_p(v_new.data_ptr()),
        ctypes.c_void_p(k_cache.data_ptr()),
        ctypes.c_void_p(v_cache.data_ptr()),
        ctypes.c_void_p(blk.data_ptr()), ctypes.c_void_p(off.data_ptr()),
        L, B, T, Hkv, N, bs, Dk, Dv, _cuda.DTYPE_CODES[k_new.dtype],
        int(k_cache.dtype == torch.float8_e4m3fn),
        ctypes.c_void_p(_cuda.stream_ptr(k_cache)),
    )
    _cuda.check(err, name)


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
    if k_new.dim() != 4 or blk.dim() != 1:
        raise ValueError(f"kv_cache_append: new rows [L, B, Hkv, D] and "
                         f"blk [B], got {tuple(k_new.shape)} / "
                         f"{tuple(blk.shape)}")
    _launch_rows("kv_cache_append", k_new[:, :, None], v_new[:, :, None],
                 k_cache, v_cache, blk[:, None], off[:, None])
    kv_cache_append.launches += 1
    return k_cache, v_cache


_cuda.counted(kv_cache_append)


def kv_cache_append_tokens(
    k_new: torch.Tensor,  # [L, B, T, Hkv, Dk] T in-flight tokens per sequence
    v_new: torch.Tensor,  # [L, B, T, Hkv, Dv]
    k_cache: torch.Tensor,  # [L, Hkv, N, bs, Dk] — updated IN PLACE
    v_cache: torch.Tensor,  # [L, Hkv, N, bs, Dv] — updated IN PLACE
    blk: torch.Tensor,  # [B, T] int32 physical page per (sequence, token)
    off: torch.Tensor,  # [B, T] int32 row within the page
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-token :func:`kv_cache_append` (the speculative verify): writes
    T consecutive-position rows per sequence, all layers, in place.
    Requires T <= block_size, as the reference does (its window spans at
    most two pages). Padded sequences may point all T rows at trash page
    0, where their writes race harmlessly."""
    T, bs = k_new.shape[2], k_cache.shape[3]
    if T > bs:
        raise ValueError(f"T={T} in-flight rows must fit a page (bs={bs})")
    if k_cache.device.type == "cpu":
        return kv_cache_append_tokens_plain(k_new, v_new, k_cache, v_cache,
                                            blk, off)
    _launch_rows("kv_cache_append_tokens", k_new, v_new, k_cache, v_cache,
                 blk, off)
    kv_cache_append_tokens.launches += 1
    return k_cache, v_cache


_cuda.counted(kv_cache_append_tokens)


def quant_scale_update(x_new, scales, blk, qmax: float = KV_INT8_QMAX,
                       eps: float = KV_SCALE_EPS):
    """Scale-plane update for one appended row per sequence. ``x_new [L,
    B, Hkv, D]`` new rows, ``scales [L, N]`` per-page f32, ``blk [B]``
    target pages. Returns ``(new_scales, r, q)``: the grown plane (running
    absmax / qmax per page, a scatter-max, so the duplicate trash page 0
    resolves deterministically), the old/new ratio per (layer, row) and the
    rows quantized against the NEW scales (int8)."""
    xf = x_new.float()
    # times the f32 reciprocal: what the jitted reference computes for its
    # division by the constant qmax (XLA rewrites it so), bit for bit
    amax = xf.abs().amax(dim=(2, 3)) * (1.0 / qmax)  # [L, B]
    idx = blk.long()[None, :].expand(amax.shape[0], -1)
    new_scales = scales.scatter_reduce(
        1, idx, torch.clamp_min(amax, eps), reduce="amax", include_self=True
    )
    new_at = new_scales.gather(1, idx)
    r = scales.gather(1, idx) / new_at  # [L, B], <= 1
    q = torch.clamp(torch.round(xf / new_at[:, :, None, None]), -qmax, qmax)
    return new_scales, r, q.to(torch.int8)


def _requantize_pages_plain(kq, vq, k_cache, v_cache, rk, rv, blk, off):
    """Every target page other than the trash page 0 requantized by its
    ratio, then the rows quantized against the new scales."""
    L = kq.shape[0]
    lidx = torch.arange(L, device=kq.device)[:, None]
    pg = blk.long()[None, :]
    real = (blk != 0)[None, :]
    for cache, ratio in ((k_cache, rk), (v_cache, rv)):
        pages = cache[lidx, :, pg]  # [L, B, Hkv, bs, D]
        req = torch.clamp(torch.round(pages.float() * ratio[:, :, None, None, None]),
                          -127, 127).to(cache.dtype)
        cache[lidx, :, pg] = torch.where(real[..., None, None, None], req, pages)
    offs = off.long()[None, :]
    k_cache[lidx, :, pg, offs] = kq
    v_cache[lidx, :, pg, offs] = vq


def append_quantized_rows_plain(k_new, v_new, k_cache, v_cache, k_scales,
                                v_scales, blk, off) -> torch.Tensor:
    """:func:`append_quantized_rows` in PyTorch: the scale math
    (:func:`quant_scale_update`), the page read-modify-write, the planes
    grown in place; returns ``n_requants``."""
    new_ks, rk, kq = quant_scale_update(k_new, k_scales, blk)
    new_vs, rv, vq = quant_scale_update(v_new, v_scales, blk)
    _requantize_pages_plain(kq, vq, k_cache, v_cache, rk, rv, blk, off)
    n = ((new_ks > k_scales).sum() + (new_vs > v_scales).sum()).to(torch.int32)
    k_scales.copy_(new_ks)
    v_scales.copy_(new_vs)
    return n


def append_quantized_rows(
    k_new: torch.Tensor,  # [L, B, Hkv, Dk] this step's keys, bf16 or f32
    v_new: torch.Tensor,  # [L, B, Hkv, Dv]
    k_cache: torch.Tensor,  # [L, Hkv, N, bs, Dk] int8 — updated IN PLACE
    v_cache: torch.Tensor,  # [L, Hkv, N, bs, Dv] int8 — updated IN PLACE
    k_scales: torch.Tensor,  # [L, N] f32 per-page scales — grown IN PLACE
    v_scales: torch.Tensor,  # [L, N] f32 — grown IN PLACE
    blk: torch.Tensor,  # [B] int32
    off: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """The quantized append in place, the whole function in ONE launch of
    ``kv_append_quant_kernel`` on the card (no PyTorch op before it, no
    host sync; launches count in ``kv_cache_append_quantized.launches``),
    its plain twin on the CPU. Grows each written page's scale, requantizes
    the pages that grew, lands the rows; returns ``n_requants``, the
    (layer, page) scale entries that grew, an int32 scalar on the device."""
    if k_cache.device.type == "cpu":
        return append_quantized_rows_plain(k_new, v_new, k_cache, v_cache,
                                           k_scales, v_scales, blk, off)
    name = "kv_cache_append_quantized"
    dev = _cuda.require_cuda(name, k_new, v_new, k_cache, v_cache, k_scales,
                             v_scales, blk, off)
    _cuda.require_int32(name, blk, off)
    L, B, Hkv, Dk = k_new.shape
    Dv = v_new.shape[-1]
    N, bs = k_cache.shape[2:4]
    if (
        v_new.shape != (L, B, Hkv, Dv)
        or k_cache.shape != (L, Hkv, N, bs, Dk)
        or v_cache.shape != (L, Hkv, N, bs, Dv)
        or k_scales.shape != (L, N) or v_scales.shape != (L, N)
        or blk.shape != (B,) or off.shape != (B,)
    ):
        raise ValueError(f"{name}: shapes do not fit: rows {tuple(k_new.shape)}"
                         f" / {tuple(v_new.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, "
                         f"planes {tuple(k_scales.shape)} / "
                         f"{tuple(v_scales.shape)}")
    if k_new.dtype != v_new.dtype or k_new.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"{name}: new rows must share one of "
                         f"{list(_cuda.DTYPE_CODES)}, got {k_new.dtype} / "
                         f"{v_new.dtype}")
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise ValueError(f"{name}: caches must be int8")
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise ValueError(f"{name}: scale planes must be f32")
    flags = _cuda.device_buffer("append_flags", dev, 2 * L * B, torch.int32)
    ticket = _cuda.device_buffer("tickets", dev, 1, torch.int32)
    n = torch.empty((), dtype=torch.int32, device=dev)
    err = _cuda.lib(_SRC).kv_cache_append_quantized_launch(
        *(ctypes.c_void_p(t.data_ptr()) for t in (
            k_new, v_new, k_cache, v_cache, k_scales, v_scales, blk, off,
            flags, ticket, n)),
        L, B, Hkv, N, bs, Dk, Dv, _cuda.DTYPE_CODES[k_new.dtype],
        ctypes.c_void_p(_cuda.stream_ptr(k_cache)),
    )
    _cuda.check(err, name)
    kv_cache_append_quantized.launches += 1
    return n


def _check_planes(k_cache, k_scales, v_scales) -> None:
    if k_scales.shape != (k_cache.shape[0], k_cache.shape[2]) or \
            v_scales.shape != k_scales.shape:
        raise ValueError(f"kv_cache_append_quantized: planes "
                         f"{tuple(k_scales.shape)} do not fit the caches "
                         f"{tuple(k_cache.shape)}")


def kv_cache_append_quantized_plain(k_new, v_new, k_cache, v_cache, k_scales,
                                    v_scales, blk, off):
    """:func:`kv_cache_append_quantized` through the plain twin."""
    _check_planes(k_cache, k_scales, v_scales)
    ks, vs = k_scales.clone(), v_scales.clone()
    n = append_quantized_rows_plain(k_new, v_new, k_cache, v_cache, ks, vs,
                                    blk, off)
    return k_cache, v_cache, ks, vs, n


def kv_cache_append_quantized(
    k_new: torch.Tensor,  # [L, B, Hkv, D] this step's keys, full precision
    v_new: torch.Tensor,  # [L, B, Hkv, D]
    k_cache: torch.Tensor,  # [L, Hkv, N, bs, D] int8 — updated IN PLACE
    v_cache: torch.Tensor,  # [L, Hkv, N, bs, D] int8 — updated IN PLACE
    k_scales: torch.Tensor,  # [L, N] f32 per-page scale plane (not changed)
    v_scales: torch.Tensor,  # [L, N] f32
    blk: torch.Tensor,  # [B] int32
    off: torch.Tensor,  # [B] int32
):
    """The append of the int8-with-scales cache with the reference's
    contract: grow each written page's running absmax scale, requantize
    the page when its scale grew, land the new row quantized against the
    new scale. Returns ``(k_cache, v_cache, k_scales, v_scales,
    n_requants)``: the caches updated in place, the grown planes as new
    tensors (copies of the inputs grown by :func:`append_quantized_rows`),
    and the number of (layer, page) scale entries that grew, an int32
    scalar ON THE DEVICE."""
    _check_planes(k_cache, k_scales, v_scales)
    ks, vs = k_scales.clone(), v_scales.clone()
    n = append_quantized_rows(k_new, v_new, k_cache, v_cache, ks, vs, blk, off)
    return k_cache, v_cache, ks, vs, n


_cuda.counted(kv_cache_append_quantized)
