"""Paged attention for decode and prefill: CUDA kernel + plain twin.

Counterpart of ``dynamo_tpu/ops/paged_attention_pallas.py``. Both entry
points launch the one hand-written kernel in ``csrc/paged_attention.cu``
on CUDA tensors and take their plain PyTorch version on CPU tensors:

  * :func:`paged_decode_attention` — one query token per sequence (``Gq``
    query rows per kv head, so the verify path's T*G packing works),
    optionally with the softmax statistics (m, l) the flash merge needs;
  * :func:`paged_prefill_attention` — a chunk of T queries over history
    plus the chunk itself, already written into the cache, through one
    block table, causal at absolute positions ``history_len + t``.

A bf16 launch runs its segment tiles on the tensor cores (``TC_TILE_ROWS``
query rows per tile, ``mma.sync`` over 64-position steps) and its decode
tiles on the tensor-core decode body (``DECODE_ROWS`` rows of one kv head
per block, any number of rows per kv head, the horizon split across warps
and, as far as fills the card, across blocks merged in the same launch); an
f32 launch runs every tile on the CUDA-core body (``MAX_TILE_ROWS`` rows per
segment tile). The choice is by dtype and tile type, stated in the kernel's
source note; no launch falls back to another body.

Cache layout (as in the JAX package): ``[Hkv, N, bs, D]`` per layer, block
tables of physical page ids, page 0 reserved as trash. The pages are of the
query dtype, int8 with one f32 scale per physical page for K and for V
(``k_scales`` / ``v_scales``, this layer's ``[N]`` slice of the engine's
planes), dequantized as each page is read, or ``float8_e4m3fn`` with no
scale (the scale-free fp8 cache), widened exactly as each page is read.

The kernels take head widths 64, 128, 192 and 256 (:data:`HEAD_DIMS`;
the two wider ones from their own source, ``csrc/paged_attention_wide.cu``).
Both take the TPU kernels' two gpt-oss options: a sliding ``window`` (a row
keeps ``q_pos - kv_pos < window``; the kernel's walk starts at the tile's
window floor, so pages below it are never read) and per-head ``sinks``
(a logit that joins each row's softmax normalizer with no value row).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda

NEG_INF = -1e30
#: query rows one block of the CUDA-core body holds (8 warps x 8 rows, csrc
#: NW * RPW): a segment tile of an f32 launch, or a chunk of a decode tile's
MAX_TILE_ROWS = 64
#: query rows of one tensor-core segment tile (8 warps x 16 rows, csrc
#: TC_ROWS): the segment tiles of a bf16 launch
TC_TILE_ROWS = 128
#: query rows of one tensor-core decode block (csrc DROWS): a decode tile of
#: a bf16 launch spans ceil(rows / 16) blocks per kv head
DECODE_ROWS = 16
#: most horizon splits per tile (flash-decoding partials)
MAX_SPLITS = 16
#: kv positions per step of the decode bodies (csrc DKT, KT), and the least
#: steps a tensor-core decode split takes (csrc DMIN_STEPS)
DECODE_STEP = 16
DECODE_MIN_STEPS = 8
#: the head widths the kernels take: 64 and 128 from ``csrc/paged_attention.cu``,
#: 192 and 256 (Gemma-3) from ``csrc/paged_attention_wide.cu`` (the TPU
#: kernels take any multiple of 64: ROADMAP B.7 holds the rest)
HEAD_DIMS = (64, 128, 192, 256)
_SRC = {64: "paged_attention.cu", 128: "paged_attention.cu",
        192: "paged_attention_wide.cu", 256: "paged_attention_wide.cu"}


def check_head_dim(name: str, D: int) -> None:
    """Raise ``ValueError`` for a head width the kernels do not take."""
    if D not in HEAD_DIMS:
        raise ValueError(
            f"{name}: head_dim {D} is not ported: the CUDA kernels take "
            f"{', '.join(map(str, HEAD_DIMS))} (ROADMAP B.7)")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def launch_paged_attention(
    q: torch.Tensor,  # [Ntok, Hkv, Gq, D]
    k_cache_layer: torch.Tensor,  # [Hkv, N, bs, D]
    v_cache_layer: torch.Tensor,
    scale: float,
    *,
    d_tables: Optional[torch.Tensor] = None,  # [B, M] int32
    d_seq_lens: Optional[torch.Tensor] = None,  # [B] int32
    p_tables: Optional[torch.Tensor] = None,  # [MP, M] int32
    p_hists: Optional[torch.Tensor] = None,  # [MP] int32
    p_valids: Optional[torch.Tensor] = None,  # [MP] int32 or None (= T)
    T: int = 0,
    Tq: int = 0,  # tokens per segment tile; 0 -> as many as fill a tile
    stats: bool = False,
    k_scales: Optional[torch.Tensor] = None,  # [N] f32 with an int8 cache
    v_scales: Optional[torch.Tensor] = None,
    window: int = 0,  # sliding window; 0 = full
    q_off: int = 0,  # decode rows sit at seq_len - 1 + q_off ...
    group: int = 0,  # ... + r // group (the verify's packed rows)
    sinks: Optional[torch.Tensor] = None,  # [Hkv * Gq] f32 sink logits
    name: str = "paged_attention",
):
    """Launch ``csrc/paged_attention.cu`` (``paged_attention_wide.cu``
    above D = 128) on its tile list: B one-token decode tiles, then MP
    segments of T tokens in Tq-token tiles (on the tensor cores when ``q``
    is bf16). Returns ``o`` (like ``q``) and, with
    ``stats``, ``m``/``l`` f32 ``[Ntok, Hkv, Gq]`` (never with ``sinks``:
    the merge that reads the statistics folds them). Validates every input
    and raises on what the kernel does not take."""
    Ntok, Hkv, Gq, D = q.shape
    check_head_dim(name, D)
    Hc, N, bs, Dc = k_cache_layer.shape
    B = 0 if d_tables is None else d_tables.shape[0]
    MP = 0 if p_tables is None else p_tables.shape[0]
    tensors = [q, k_cache_layer, v_cache_layer] + [
        t for t in (d_tables, d_seq_lens, p_tables, p_hists, p_valids)
        if t is not None
    ]
    _cuda.require_cuda(name, *tensors)
    _cuda.require_int32(name, *tensors[3:])
    if q.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported")
    kv_dtype = _kv_dtype_code(name, q, k_cache_layer, v_cache_layer,
                              k_scales, v_scales)
    if (Hc, Dc) != (Hkv, D) or v_cache_layer.shape != k_cache_layer.shape:
        raise ValueError(f"{name}: cache shape {tuple(k_cache_layer.shape)} "
                         f"does not fit q {tuple(q.shape)}")
    if Ntok != B + MP * T:
        raise ValueError(f"{name}: {Ntok} query tokens for B={B} + "
                         f"MP={MP} x T={T}")
    if sinks is not None:
        if stats:
            raise ValueError(f"{name}: sinks fold into the caller's merge "
                             "when it asks for (m, l)")
        if sinks.dtype != torch.float32 or sinks.shape != (Hkv * Gq,):
            raise ValueError(f"{name}: sinks must be f32 [{Hkv * Gq}]")
        _cuda.require_cuda(name, q, sinks)
    # a bf16 query (over bf16, int8 or fp8 pages) runs on the tensor-core
    # bodies; f32 launches (the tiny f32 models) keep the CUDA-core body
    tc = q.dtype == torch.bfloat16
    seg_rows = TC_TILE_ROWS if tc else MAX_TILE_ROWS
    Tq = Tq or max(1, seg_rows // Gq)
    if MP and Tq * Gq > seg_rows:
        raise ValueError(f"{name}: {Tq} tokens x {Gq} rows per segment tile "
                         f"(at most {seg_rows})")
    M = (d_tables if B else p_tables).shape[1] if (B or MP) else 0
    if B and MP and p_tables.shape[1] != M:
        raise ValueError(f"{name}: decode and prefill tables differ in width")
    o = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((Ntok, Hkv, Gq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    # split horizons only as far as fills the card (decode: B x Hkv tiles
    # leave most of it idle). A bf16 launch splits its decode row groups
    # until they and the segment tiles (which take no split) hold a block
    # per SM, the tensor-core bodies' one block per SM; an f32 launch splits
    # every tile until they hold ~2 blocks per SM
    sms = _cuda.sm_count(q.device) if (B or MP) else 0
    if tc:
        split_units = B * Hkv * -(-Gq // DECODE_ROWS)
        want = max(sms - MP * -(-T // Tq) * Hkv, split_units)
    else:
        split_units = (B * -(-Gq // MAX_TILE_ROWS) + MP * -(-T // Tq)) * Hkv
        want = 2 * sms
    n_split = 1
    if split_units:
        n_split = min(MAX_SPLITS, max(1, -(-want // split_units)))
    if window > 0:
        # a windowed horizon spans at most window + the tile's rows'
        # spread: no more splits than its steps (tensor-core decode: than
        # its DECODE_MIN_STEPS runs) can fill
        steps = -(-(window + max(Gq, T)) // DECODE_STEP) + 1
        n_split = min(n_split, -(-steps // DECODE_MIN_STEPS) if tc else steps)
    scratch = tickets = None
    if n_split > 1:
        split_rows = (B if tc else Ntok) * Hkv * Gq
        scratch = torch.empty(n_split * split_rows * (D + 2),
                              dtype=torch.float32, device=q.device)
        if tc and B:
            tickets = _cuda.device_buffer("tickets", q.device, split_units,
                                          torch.int32)
    lib = _cuda.lib(_SRC[D])
    launch = (lib.paged_attention_wide_launch if D > 128
              else lib.paged_attention_launch)
    err = launch(
        _ptr(q), _ptr(o), _ptr(m), _ptr(l), _ptr(k_cache_layer),
        _ptr(v_cache_layer), _ptr(d_tables), _ptr(d_seq_lens), B,
        _ptr(p_tables), _ptr(p_hists), _ptr(p_valids), MP, T, Tq, Hkv, Gq,
        N, bs, M, D, float(scale), n_split, _ptr(scratch),
        _cuda.DTYPE_CODES[q.dtype], _ptr(k_scales), _ptr(v_scales), kv_dtype,
        _ptr(tickets), max(int(window), 0), int(q_off), int(group),
        _ptr(sinks), ctypes.c_void_p(_cuda.stream_ptr(q)),
    )
    _cuda.check(err, name)
    return o, m, l


def _kv_dtype_code(name, q, k_cache_layer, v_cache_layer, k_scales, v_scales):
    """The kernel's cache-type code: the query's own, 2 for int8 pages with
    their per-page f32 scales (both required, ``[N]`` each), or 3 for
    ``float8_e4m3fn`` pages, which take no scales."""
    if k_cache_layer.dtype != v_cache_layer.dtype:
        raise ValueError(f"{name}: k and v caches differ in dtype")
    if k_cache_layer.dtype == torch.float8_e4m3fn:
        if k_scales is not None or v_scales is not None:
            raise ValueError(f"{name}: fp8 pages take no per-page scales")
        return 3
    if k_cache_layer.dtype == torch.int8:
        N = k_cache_layer.shape[1]
        for s in (k_scales, v_scales):
            if s is None or s.dtype != torch.float32 or s.shape != (N,):
                raise ValueError(f"{name}: an int8 cache needs f32 [N={N}] "
                                 "k_scales and v_scales")
        _cuda.require_cuda(name, q, k_scales, v_scales)
        return 2
    if k_scales is not None or v_scales is not None:
        raise ValueError(f"{name}: per-page scales come with an int8 cache")
    if k_cache_layer.dtype != q.dtype:
        raise ValueError(f"{name}: cache dtype must equal the query dtype "
                         "(or be int8 with per-page scales)")
    return _cuda.DTYPE_CODES[q.dtype]


# ---------------- plain PyTorch twins (CPU path + kernel oracle) ----------------


def gather_pages(cache_layer: torch.Tensor, table: torch.Tensor,
                 scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[Hkv, N, bs, D]`` pages of ``table [..., M]`` -> ``[Hkv, ...,
    M*bs, D]`` (logical positions in order). With ``scales`` ([N] f32 per
    page, an int8 cache) the pages come out dequantized, f32; fp8 pages
    come out as they are (the caller widens them)."""
    Hkv, _, bs, D = cache_layer.shape
    if cache_layer.dtype == torch.float8_e4m3fn:  # gathered as its bytes
        g = cache_layer.view(torch.uint8)[:, table.long()].view(
            cache_layer.dtype)
    else:
        g = cache_layer[:, table.long()]
    if scales is not None:  # [Hkv, ..., M, bs, D] * its page's scale
        g = g.float() * scales[table.long()][..., None, None]
    return g.reshape(Hkv, *table.shape[:-1], table.shape[-1] * bs, D)


def masked_attention(
    qg: torch.Tensor,  # [R, Hkv, Gq, D] f32, already scaled
    k: torch.Tensor,  # [Hkv, R or 1, S, D]
    v: torch.Tensor,
    limit: torch.Tensor,  # [R] last attended position per row (-1 = none)
    lo: Optional[torch.Tensor] = None,  # [R] or [R, Gq] window floors
    sinks: Optional[torch.Tensor] = None,  # [Hkv, Gq] f32 sink logits
):
    """Row r attends positions ``lo[r]..limit[r]`` (``lo`` per token, or
    per query row of a kv head; None = from 0); fp32 softmax with the TPU
    kernels' statistics: ``m`` the row max (``NEG_INF`` when nothing is
    attended), ``l`` the normalizer (0 then), ``o`` normalized (0 then).
    A head's sink logit s joins the normalizer of ``o`` (``m``/``l`` stay
    without it): ``o = (p @ v) e^(m - m_f) / (l e^(m - m_f) + e^(s - m_f))``,
    ``m_f = max(m, s)``. Returns ``o [R, Hkv, Gq, D]`` f32, ``m``/``l``
    ``[R, Hkv, Gq]``."""
    S = k.shape[-2]
    s = qg.permute(1, 0, 2, 3) @ k.float().transpose(-1, -2)  # [Hkv,R,Gq,S]
    pos = torch.arange(S, device=qg.device)
    valid = pos <= limit.long()[:, None, None]  # [R, 1, S]
    if lo is not None:
        valid = valid & (pos >= lo.long().reshape(lo.shape[0], -1, 1))
    valid = valid[None]  # [1, R, Gq or 1, S]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]) * valid
    l = p.sum(-1)
    if sinks is None:
        o = (p @ v.float()) / l.clamp_min(1e-20)[..., None]
    else:
        sk = sinks.float()[:, None, :]  # [Hkv, 1, Gq]
        m_f = torch.maximum(m, sk)
        a = torch.exp(m - m_f)
        o = (p @ v.float()) * (a / (l * a + torch.exp(sk - m_f)))[..., None]
    return o.permute(1, 0, 2, 3), m.permute(1, 0, 2), l.permute(1, 0, 2)


def _sinks_hg(sinks: Optional[torch.Tensor], Hkv: int):
    """``[H]`` sink logits as ``[Hkv, G]`` f32 (None stays None)."""
    return None if sinks is None else sinks.float().reshape(Hkv, -1)


def paged_decode_attention_plain(
    q, k_cache_layer, v_cache_layer, block_tables, seq_lens, scale,
    return_stats: bool = False, k_scales=None, v_scales=None,
    window: int = 0, q_pos_offset: int = 0, group: int = 0, sinks=None,
):
    """Gather the pages through the tables (dequantized with per-page
    scales), masked softmax in f32; with a window, row r of a kv head keeps
    positions from ``seq_len + q_pos_offset - window (+ r // group)``."""
    B, H, D = q.shape
    Hkv = k_cache_layer.shape[0]
    Gq = H // Hkv
    qg = q.reshape(B, Hkv, Gq, D).float() * scale
    lo = None
    if window > 0:
        r = torch.arange(Gq, device=q.device)
        lo = (seq_lens.long()[:, None] + q_pos_offset - window
              + (r // group if group else 0))
    o, m, l = masked_attention(
        qg, gather_pages(k_cache_layer, block_tables, k_scales),
        gather_pages(v_cache_layer, block_tables, v_scales),
        seq_lens.long() - 1, lo, _sinks_hg(sinks, Hkv),
    )
    o = o.reshape(B, H, D).to(q.dtype)
    return (o, m, l) if return_stats else o


def paged_prefill_attention_plain(
    q, k_cache_layer, v_cache_layer, block_table, history_len, scale,
    valid_len=None, k_scales=None, v_scales=None, window: int = 0,
    sinks=None,
):
    T, H, D = q.shape
    Hkv = k_cache_layer.shape[0]
    hist = torch.as_tensor(history_len, device=q.device).reshape(())
    t = torch.arange(T, device=q.device)
    limit = hist + t
    lo = limit - window + 1 if window > 0 else None
    if valid_len is not None:
        valid = torch.as_tensor(valid_len, device=q.device).reshape(())
        limit = torch.where(t < valid, limit, -1)
    qg = q.reshape(T, Hkv, H // Hkv, D).float() * scale
    o, _, _ = masked_attention(
        qg, gather_pages(k_cache_layer, block_table, k_scales)[:, None],
        gather_pages(v_cache_layer, block_table, v_scales)[:, None], limit,
        lo, _sinks_hg(sinks, Hkv),
    )
    return o.reshape(T, H, D).to(q.dtype)


# ---------------- entry points ----------------


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, D]
    k_cache_layer: torch.Tensor,  # [Hkv, N, bs, D]
    v_cache_layer: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,  # [B] int32
    scale: float,
    pages_per_step: int = 0,
    return_stats: bool = False,
    window: int = 0,
    q_pos_offset: int = 0,
    group: int = 0,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    sinks: Optional[torch.Tensor] = None,
):  # [B, H, D] or (out, m [B, Hkv, G], l [B, Hkv, G]) with return_stats
    """GQA paged decode attention over ``seq_lens[b]`` cached positions.

    ``pages_per_step`` is the TPU kernel's DMA grouping and is ignored.
    ``group`` is the query heads per kv head of ONE token where the rows
    pack several (the verify's T*G rows per kv head): a launch with more
    rows than that also counts in ``verify_launches``, one with a window in
    ``window_launches``. A ``window`` keeps
    row r of a kv head to positions from ``seq_len + q_pos_offset - window
    (+ r // group)`` (the query sits at ``seq_len - 1 + q_pos_offset``,
    one past the cache for the merged decode and the verify).
    ``k_scales``/``v_scales`` ([N] f32) come with int8 pages. ``sinks``
    ([H] f32) fold into the output (the JAX package's
    ``_decode_kernel_with_sinks``); with ``return_stats`` the caller's
    merge folds them instead, so the two exclude each other. Rows with
    ``seq_len == 0`` return o = 0, m = -1e30, l = 0."""
    if sinks is not None and return_stats:
        raise ValueError("paged_decode_attention: with return_stats the "
                         "merge folds the sinks (m, l come without them)")
    B, H, D = q.shape
    Hkv = k_cache_layer.shape[0]
    G = H // Hkv
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache_layer, v_cache_layer, block_tables, seq_lens, scale,
            return_stats, k_scales, v_scales, window, q_pos_offset, group,
            sinks,
        )
    o, m, l = launch_paged_attention(
        q.reshape(B, Hkv, G, D), k_cache_layer, v_cache_layer, scale,
        d_tables=block_tables, d_seq_lens=seq_lens, stats=return_stats,
        k_scales=k_scales, v_scales=v_scales, window=window,
        q_off=q_pos_offset, group=group, sinks=sinks,
        name="paged_decode_attention",
    )
    paged_decode_attention.launches += 1
    if group and G > group:
        paged_decode_attention.verify_launches += 1
    if window > 0:
        paged_decode_attention.window_launches += 1
    o = o.reshape(B, H, D)
    return (o, m, l) if return_stats else o


_cuda.counted(paged_decode_attention, "verify_launches", "window_launches")


def paged_prefill_attention(
    q: torch.Tensor,  # [T, H, D] chunk queries
    k_cache_layer: torch.Tensor,  # [Hkv, N, bs, D] — chunk ALREADY written
    v_cache_layer: torch.Tensor,
    block_table: torch.Tensor,  # [M] int32, covers history + padded chunk
    history_len,  # int, or int32 tensor of one element on q's device
    scale: float,
    pages_per_step: int = 0,
    window: int = 0,
    sinks: Optional[torch.Tensor] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    valid_len=None,  # int or one-element int32 tensor; None = all T rows
) -> torch.Tensor:  # [T, H, D]
    """Chunked-prefill attention over the paged cache (write-before-attend:
    the caller scattered this chunk's K/V into the cache first). Row t
    attends positions ``<= history_len + t``. Padded tail rows are
    discarded by every caller: as in the JAX kernel they compute values
    anyway, unless ``valid_len`` (the port's addition) says where the
    padding starts — then they come out zero and cost nothing.
    ``k_scales``/``v_scales`` ([N] f32) come with int8 pages; ``window``
    keeps ``q_pos - kv_pos < window``; ``sinks`` ([H] f32) join each row's
    normalizer."""
    T, H, D = q.shape
    Hkv = k_cache_layer.shape[0]
    G = H // Hkv
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_cache_layer, v_cache_layer, block_table, history_len, scale,
            valid_len, k_scales, v_scales, window, sinks,
        )

    def dev_i32(x):
        if torch.is_tensor(x):
            return x.reshape(1)
        return torch.tensor([x], dtype=torch.int32, device=q.device)

    o, _, _ = launch_paged_attention(
        q.reshape(T, Hkv, G, D), k_cache_layer, v_cache_layer, scale,
        p_tables=block_table.reshape(1, -1), p_hists=dev_i32(history_len),
        p_valids=None if valid_len is None else dev_i32(valid_len),
        T=T, k_scales=k_scales, v_scales=v_scales, window=window,
        sinks=sinks, name="paged_prefill_attention",
    )
    paged_prefill_attention.launches += 1
    if window > 0:
        paged_prefill_attention.window_launches += 1
    return o.reshape(T, H, D)


_cuda.counted(paged_prefill_attention, "window_launches")
