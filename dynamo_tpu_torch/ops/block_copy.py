"""Block copies between the paged KV cache and contiguous block stacks.

The device half of the host-DRAM and disk KV tiers (``engine/offload.py``):
counterparts of ``dynamo_tpu/engine/offload.py``'s jitted cores, which are
XLA gathers and scatters outside any Pallas kernel:

  * :func:`gather_blocks`: ``gather_blocks_core`` (:125) and, with the int8
    cache's scale planes, ``gather_blocks_s_core`` (:185);
  * :func:`scatter_blocks`: ``scatter_blocks_core`` (:132) and, with the
    planes, ``scatter_blocks_adopt_core`` (:209);
  * :func:`scatter_blocks_dequant`: ``scatter_blocks_q_core`` (:163);
  * :func:`scatter_blocks_requant`: ``scatter_blocks_requant_core`` (:231).

Shapes are the reference's: caches ``[L, H, N, bs, D]`` (K and V may differ
in H and D: MLA's latent rows), index vectors ``[n]`` int32 padded with the
trash page 0, stacks ``[L, H, m, bs, D]`` with ``m <= n`` (the scatters land
zeros for the ``n - m`` pad indices, as the reference pads on device),
scale planes ``[L, N]`` f32 and scale stacks ``[L, m]`` f32.

The JAX cores are functional (the caches are donated and rebound); these
write the caches and the planes IN PLACE, so a CUDA graph that captured
their addresses keeps reading the live memory. On CUDA tensors each
launches its entry point of ``csrc/block_copy.cu``; on CPU tensors each
takes its plain twin (``index_select`` / ``index_copy_`` and the
arithmetic), which the tests hold byte for byte to the reference's cores.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.quant import KV_INT8_QMAX, KV_SCALE_EPS, to_e4m3
from . import _cuda

_SRC = "block_copy.cu"

#: payload formats of the C interface
_FMT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
        torch.float8_e4m3fn: 3}


def _raw(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` (its last axis times its item size): one copy
    path for every dtype."""
    return t.view(torch.uint8)


def _pad_rows(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """``x`` padded with zeros to ``n`` rows along ``axis``."""
    m = x.shape[axis]
    if m >= n:
        return x
    shape = list(x.shape)
    shape[axis] = n - m
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``: an fp8 cache with the reference's cast."""
    return to_e4m3(x) if dtype == torch.float8_e4m3fn else x.to(dtype)


# ---------------- the plain twins ----------------


def gather_blocks_plain(k_cache, v_cache, idxs, k_scales=None, v_scales=None):
    """``take(cache, idxs, axis=2)`` for both caches (and ``take(plane,
    idxs, axis=1)`` for both planes when given)."""
    idx = idxs.long()
    kg = _raw(k_cache).index_select(2, idx).view(k_cache.dtype)
    vg = _raw(v_cache).index_select(2, idx).view(v_cache.dtype)
    if k_scales is None:
        return kg, vg
    return kg, vg, k_scales.index_select(1, idx), v_scales.index_select(1, idx)


def scatter_blocks_plain(k_cache, v_cache, idxs, k_data, v_data,
                         k_scales=None, v_scales=None, ks=None, vs=None):
    """``cache[:, :, idxs] = pad(data)`` in place (cast to the cache's
    dtype), and with the planes the adopt core: ``plane[:, idxs] =
    max(pad(scales), 1e-12)``."""
    idx = idxs.long()
    n = idx.shape[0]
    for cache, data in ((k_cache, k_data), (v_cache, v_data)):
        data = _pad_rows(_cast(data, cache.dtype), n, 2)
        _raw(cache).index_copy_(2, idx, _raw(data))
    if k_scales is not None:
        for plane, s in ((k_scales, ks), (v_scales, vs)):
            s = _pad_rows(s.float(), n, 1)
            plane.index_copy_(1, idx, torch.clamp_min(s, KV_SCALE_EPS))
    return k_cache, v_cache


def scatter_blocks_dequant_plain(k_cache, v_cache, idxs, k_data, v_data,
                                 ks, vs):
    """``cache[:, :, idxs] = (pad(codes) * pad(scales)).astype(cache)``
    in place."""
    idx = idxs.long()
    n = idx.shape[0]
    for cache, data, s in ((k_cache, k_data, ks), (v_cache, v_data, vs)):
        d = _pad_rows(data, n, 2).float() * _pad_rows(s.float(), n, 1)[
            :, None, :, None, None]
        _raw(cache).index_copy_(2, idx, _raw(_cast(d, cache.dtype)))
    return k_cache, v_cache


def scatter_blocks_requant_plain(k_cache, v_cache, k_scales, v_scales, idxs,
                                 k_data, v_data, ks, vs):
    """Dequantize with the carried scales, a fresh absmax scale per (layer,
    block), ``clip(round(x / scale), +-127)`` codes and the new scales
    landed in place."""
    idx = idxs.long()
    n = idx.shape[0]
    for cache, plane, data, s in ((k_cache, k_scales, k_data, ks),
                                  (v_cache, v_scales, v_data, vs)):
        d = _pad_rows(data, n, 2).float() * _pad_rows(s.float(), n, 1)[
            :, None, :, None, None]
        # amax / 127 as the reference's jitted core computes it: XLA turns
        # the division by a constant into a product with its f32 reciprocal
        amax = torch.amax(d.abs(), dim=(1, 3, 4))
        new = torch.clamp_min(amax * amax.new_tensor(1.0 / KV_INT8_QMAX),
                              KV_SCALE_EPS)
        q = torch.clamp(torch.round(d / new[:, None, :, None, None]),
                        -KV_INT8_QMAX, KV_INT8_QMAX)
        cache.index_copy_(2, idx, q.to(torch.int8))
        plane.index_copy_(1, idx, new)
    return k_cache, v_cache


# ---------------- the kernels ----------------


def _check(name, caches, idxs, stacks, planes=(), scales=()):
    """Device, contiguity and shapes the kernel takes; returns (L, Hk, Hv,
    N, n, m)."""
    k_cache, v_cache = caches
    _cuda.require_cuda(name, *caches, idxs, *stacks, *planes, *scales)
    _cuda.require_int32(name, idxs)
    L, Hk, N = k_cache.shape[:3]
    Hv = v_cache.shape[1]
    n = idxs.shape[0]
    m = stacks[0].shape[2]
    ok = (
        k_cache.dim() == 5 and v_cache.shape[0] == L and v_cache.shape[2] == N
        and k_cache.shape[3] == v_cache.shape[3] and idxs.dim() == 1
        and m <= n and stacks[0].shape == (L, Hk, m, *k_cache.shape[3:])
        and stacks[1].shape == (L, Hv, m, *v_cache.shape[3:])
        and all(p.shape == (L, N) and p.dtype == torch.float32 for p in planes)
        and all(s.shape == (L, m) and s.dtype == torch.float32 for s in scales)
    )
    if not ok:
        raise ValueError(
            f"{name}: shapes do not fit: caches {tuple(k_cache.shape)} / "
            f"{tuple(v_cache.shape)}, idxs {tuple(idxs.shape)}, stacks "
            f"{[tuple(s.shape) for s in stacks]}, planes "
            f"{[tuple(p.shape) for p in planes]}, scales "
            f"{[tuple(s.shape) for s in scales]}")
    return L, Hk, Hv, N, n, m


def _page(cache: torch.Tensor) -> tuple[int, int]:
    """(bytes, elements) of one head's page of ``cache``."""
    e = cache.shape[3] * cache.shape[4]
    return e * cache.element_size(), e


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def gather_blocks(k_cache, v_cache, idxs, k_scales=None, v_scales=None):
    """Two ``[L, H, n, bs, D]`` stacks of the pages at ``idxs`` (and the
    planes' ``[L, n]`` stacks when given): one ``block_gather_launch``."""
    if k_cache.device.type == "cpu":
        return gather_blocks_plain(k_cache, v_cache, idxs, k_scales, v_scales)
    planes = () if k_scales is None else (k_scales, v_scales)
    n = idxs.shape[0]
    L = k_cache.shape[0]
    kg = k_cache.new_empty((L, k_cache.shape[1], n, *k_cache.shape[3:]))
    vg = v_cache.new_empty((L, v_cache.shape[1], n, *v_cache.shape[3:]))
    L, Hk, Hv, N, n, _ = _check("gather_blocks", (k_cache, v_cache), idxs,
                                (kg, vg), planes)
    ksg = vsg = None
    if planes:
        ksg = k_scales.new_empty((L, n))
        vsg = v_scales.new_empty((L, n))
    err = _cuda.lib(_SRC).block_gather_launch(
        _ptr(k_cache), _ptr(v_cache), _ptr(k_scales), _ptr(v_scales),
        _ptr(idxs), _ptr(kg), _ptr(vg), _ptr(ksg), _ptr(vsg), L, Hk, Hv, N, n,
        _page(k_cache)[0], _page(v_cache)[0],
        ctypes.c_void_p(_cuda.stream_ptr(k_cache)))
    _cuda.check(err, "gather_blocks")
    gather_blocks.launches += 1
    if planes:
        gather_blocks.plane_launches += 1
        return kg, vg, ksg, vsg
    return kg, vg


def scatter_blocks(k_cache, v_cache, idxs, k_data, v_data, k_scales=None,
                   v_scales=None, ks=None, vs=None):
    """Land ``[L, H, m, bs, D]`` stacks at the first ``m`` of ``idxs`` in
    place (zeros at the pad indices); with the planes, adopt the carried
    ``[L, m]`` scales (clamped to 1e-12). One ``block_scatter_launch``.
    A stack of another dtype than the cache is cast first (the reference's
    ``astype``)."""
    if k_cache.device.type == "cpu":
        return scatter_blocks_plain(k_cache, v_cache, idxs, k_data, v_data,
                                    k_scales, v_scales, ks, vs)
    k_data = _cast(k_data, k_cache.dtype).contiguous()
    v_data = _cast(v_data, v_cache.dtype).contiguous()
    planes = () if k_scales is None else (k_scales, v_scales)
    scales = () if k_scales is None else (ks, vs)
    L, Hk, Hv, N, n, m = _check("scatter_blocks", (k_cache, v_cache), idxs,
                                (k_data, v_data), planes, scales)
    err = _cuda.lib(_SRC).block_scatter_launch(
        _ptr(k_cache), _ptr(v_cache), _ptr(k_scales), _ptr(v_scales),
        _ptr(idxs), _ptr(k_data), _ptr(v_data), _ptr(ks), _ptr(vs), L, Hk, Hv,
        N, n, m, _page(k_cache)[0], _page(v_cache)[0],
        ctypes.c_void_p(_cuda.stream_ptr(k_cache)))
    _cuda.check(err, "scatter_blocks")
    scatter_blocks.launches += 1
    if planes:
        scatter_blocks.adopt_launches += 1
    return k_cache, v_cache


def scatter_blocks_dequant(k_cache, v_cache, idxs, k_data, v_data, ks, vs):
    """Land int8 / e4m3 code stacks times their ``[L, m]`` scales into an
    f32, bf16 or e4m3 cache in place: one ``block_scatter_dequant_launch``."""
    if k_cache.device.type == "cpu":
        return scatter_blocks_dequant_plain(k_cache, v_cache, idxs, k_data,
                                            v_data, ks, vs)
    L, Hk, Hv, N, n, m = _check("scatter_blocks_dequant", (k_cache, v_cache),
                                idxs, (k_data, v_data), (), (ks, vs))
    code, cache = k_data.dtype, k_cache.dtype
    if (code not in (torch.int8, torch.float8_e4m3fn) or v_data.dtype != code
            or cache not in (torch.float32, torch.bfloat16,
                             torch.float8_e4m3fn)
            or v_cache.dtype != cache):
        raise ValueError(f"scatter_blocks_dequant: int8 or e4m3 codes into "
                         f"f32, bf16 or e4m3 caches, got {code} into {cache}")
    err = _cuda.lib(_SRC).block_scatter_dequant_launch(
        _ptr(k_cache), _ptr(v_cache), _ptr(idxs), _ptr(k_data), _ptr(v_data),
        _ptr(ks), _ptr(vs), L, Hk, Hv, N, n, m, _page(k_cache)[1],
        _page(v_cache)[1], _FMT[code], _FMT[cache],
        ctypes.c_void_p(_cuda.stream_ptr(k_cache)))
    _cuda.check(err, "scatter_blocks_dequant")
    scatter_blocks_dequant.launches += 1
    return k_cache, v_cache


def scatter_blocks_requant(k_cache, v_cache, k_scales, v_scales, idxs, k_data,
                           v_data, ks, vs):
    """Land f32 / bf16 / int8 / e4m3 stacks (times their ``[L, m]`` scales)
    into the int8 cache, requantized against a fresh absmax per (layer,
    block), codes and plane scales in place: one
    ``block_scatter_requant_launch``."""
    if k_cache.device.type == "cpu":
        return scatter_blocks_requant_plain(k_cache, v_cache, k_scales,
                                            v_scales, idxs, k_data, v_data,
                                            ks, vs)
    L, Hk, Hv, N, n, m = _check(
        "scatter_blocks_requant", (k_cache, v_cache), idxs, (k_data, v_data),
        (k_scales, v_scales), (ks, vs))
    if (k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8
            or k_data.dtype not in _FMT or v_data.dtype != k_data.dtype):
        raise ValueError(f"scatter_blocks_requant: stacks of one of "
                         f"{list(_FMT)} into int8 caches, got {k_data.dtype} "
                         f"into {k_cache.dtype}")
    err = _cuda.lib(_SRC).block_scatter_requant_launch(
        _ptr(k_cache), _ptr(v_cache), _ptr(k_scales), _ptr(v_scales),
        _ptr(idxs), _ptr(k_data), _ptr(v_data), _ptr(ks), _ptr(vs), L, Hk, Hv,
        N, n, m, _page(k_cache)[1], _page(v_cache)[1], _FMT[k_data.dtype],
        ctypes.c_void_p(_cuda.stream_ptr(k_cache)))
    _cuda.check(err, "scatter_blocks_requant")
    scatter_blocks_requant.launches += 1
    return k_cache, v_cache


_cuda.counted(gather_blocks, "plane_launches")
_cuda.counted(scatter_blocks, "adopt_launches")
_cuda.counted(scatter_blocks_dequant)
_cuda.counted(scatter_blocks_requant)
