"""Paged attention over a block-table-indirect KV cache (PyTorch).

Counterpart of ``dynamo_tpu/ops/attention.py`` for the main path. Cache
layout, as in the JAX package (one array per K/V for all layers):

    k_cache, v_cache: [num_layers, num_kv_heads, num_blocks, block_size, head_dim]

Block tables are ``[batch, max_blocks_per_seq]`` int32 page ids, page 0
reserved as trash; sequence lengths mask the unused tail.

  * The dispatchers :func:`chunk_attention_with_cache` and
    :func:`decode_attention_merged` go through the kernel wrappers
    (``paged_prefill_attention`` / ``paged_decode_attention`` with stats),
    which launch the CUDA kernel on CUDA tensors and take their plain
    version on CPU tensors — never anything in between.
  * ``decode_attention_xla``, ``_history_attention_xla`` and
    ``chunk_attention_with_cache_xla`` keep the JAX names of the dense
    gather paths they mirror (there they lower through XLA; here they are
    plain PyTorch). They are the oracles the tests hold the kernels to.
  * ``write_chunk_to_cache``, ``decode_slot_indices`` and
    ``write_decode_token_to_cache`` are the slot-mapping writers. Unlike
    the JAX functions (which return an updated copy), the writers update
    the cache layer IN PLACE and return it.
  * The scale-free fp8 cache (``float8_e4m3fn`` pages): the writers cast
    with ``models/quant.to_e4m3`` (the reference's bytes), and every read
    widens the codes exactly to the query's type.
  * The int8-with-scales cache: every attention path takes ``k_scales`` /
    ``v_scales`` (this layer's ``[N]`` f32 slice of the scale planes; the
    pages dequantize as they are read), and
    ``write_chunk_to_cache_quantized`` / ``write_decode_token_to_cache_quantized``
    grow the written pages' scales, requantize their resident rows and land
    the new rows quantized (plain PyTorch, as they are XLA in the JAX
    package). They update the cache layer in place and return the grown
    scale slice as a new tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.quant import KV_INT8_QMAX, KV_SCALE_EPS, store_codes
from .paged_attention import (
    NEG_INF,
    gather_pages,
    paged_decode_attention,
    paged_prefill_attention,
)


def _no_softcap(fn: str, cap=0.0):
    """Softcap has no kernel in the JAX package either (its Gemma-2 path
    is XLA only): the port serves it nowhere yet."""
    if cap:
        raise NotImplementedError(f"{fn}: softcap is not ported yet")


def decode_attention_merged(
    q: torch.Tensor,  # [B, H, D] current token's queries
    k_new: torch.Tensor,  # [B, Hkv, D] current token's key (rope'd)
    v_new: torch.Tensor,  # [B, Hkv, D]
    k_cache_layer: torch.Tensor,  # [Hkv, N, bs, D] — current token NOT written
    v_cache_layer: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    hist_lens: torch.Tensor,  # [B] int32 tokens in cache (EXCLUDES current)
    scale: float,
    window: int = 0,
    sinks: Optional[torch.Tensor] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:  # [B, H, D]
    """Decode attention with the current token handled OUT of the cache:
    history from the stats-emitting paged kernel, the current token folded
    in with the flash merge. It removes the write-before-attend dependency,
    so all layers' cache writes batch into one in-place
    :func:`~dynamo_tpu_torch.ops.kv_cache_update.kv_cache_append` (or its
    quantized twin; the current token merges in at full precision). The
    window floor and the sink's place in the merge are verify_attention's
    at T = 1."""
    return verify_attention(
        q[:, None], k_new[:, None], v_new[:, None], k_cache_layer,
        v_cache_layer, block_tables, hist_lens, scale, window=window,
        sinks=sinks, k_scales=k_scales, v_scales=v_scales,
    )[:, 0]


def verify_attention(
    q: torch.Tensor,  # [B, T, H, D] queries for T in-flight tokens per seq
    k_win: torch.Tensor,  # [B, T, Hkv, D] their keys (rope'd, NOT in cache)
    v_win: torch.Tensor,  # [B, T, Hkv, D]
    k_cache_layer: torch.Tensor,  # [Hkv, N, bs, D] history only
    v_cache_layer: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M]
    hist_lens: torch.Tensor,  # [B] tokens in cache (before the T in-flight)
    scale: float,
    window: int = 0,
    sinks: Optional[torch.Tensor] = None,
    cap: float = 0.0,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:  # [B, T, H, D]
    """T in-flight tokens per sequence attend the cached history (through
    the stats-emitting decode kernel: the T*G rows of a kv head pack into
    its query-row dimension, each with its exact window floor ``hist + 1 +
    t - window``) plus the causal prefix of the window (dense, tiny),
    merged with the flash-decoding rule. A head's sink logit joins the
    merge denominator with no value row (the JAX package's
    ``ops/attention.py`` verify_attention)."""
    _no_softcap("verify_attention", cap)
    B, T, H, D = q.shape
    Hkv = k_cache_layer.shape[0]
    G = H // Hkv
    # rows ordered (hkv, t, g): the kernel's [B, Hkv, T*G] row layout
    qp = q.reshape(B, T, Hkv, G, D).permute(0, 2, 1, 3, 4)
    o_h, m_h, l_h = paged_decode_attention(
        qp.reshape(B, Hkv * T * G, D).contiguous(), k_cache_layer,
        v_cache_layer, block_tables, hist_lens, scale, return_stats=True,
        window=window, q_pos_offset=1, group=G, k_scales=k_scales,
        v_scales=v_scales,
    )
    o_h = o_h.reshape(B, Hkv, T, G, D).float()
    m_h = m_h.reshape(B, Hkv, T, G)
    l_h = l_h.reshape(B, Hkv, T, G)
    qg = q.reshape(B, T, Hkv, G, D).float() * scale
    s_w = torch.einsum("btkgd,bukd->bktgu", qg, k_win.float())
    if T > 1:  # the window's causal part (nothing to mask at T = 1)
        t = torch.arange(T, device=q.device)
        drop = t[None, :] > t[:, None]  # [T, T'] the future
        if window > 0:  # binds only when T > window
            drop |= (t[:, None] - t[None, :]) >= window
        s_w = s_w.masked_fill(drop[None, None, :, None, :], NEG_INF)
    m_f = torch.maximum(m_h, s_w.amax(-1))
    if sinks is not None:
        s_k = sinks.float().reshape(1, Hkv, 1, G)
        m_f = torch.maximum(m_f, s_k)
    kept = l_h * torch.exp(m_h - m_f)  # history's share of the normalizer
    p_w = torch.exp(s_w - m_f[..., None])  # [B, Hkv, T, G, T']
    o_w = torch.einsum("bktgu,bukd->bktgd", p_w, v_win.float())
    num = kept[..., None] * o_h + o_w
    den = kept + p_w.sum(-1)  # >= the diagonal's own term
    if sinks is not None:
        den = den + torch.exp(s_k - m_f)
    out = num / den[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(B, T, H, D).to(q.dtype)


def _history_attention_xla(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache_layer: torch.Tensor,
    v_cache_layer: torch.Tensor,
    block_tables: torch.Tensor,
    hist_lens: torch.Tensor,
    scale: float,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
):
    """Dense twin of the stats-emitting kernel path: history-only attention
    with raw softmax stats (o normalized, m row max, l normalizer) in the
    ``[B, Hkv, T, G(, D)]`` layout verify_attention merges over."""
    B, T, H, D = q.shape
    Hkv = k_cache_layer.shape[0]
    G = H // Hkv
    k = gather_pages(k_cache_layer, block_tables, k_scales).float()  # [Hkv, B, S, D]
    v = gather_pages(v_cache_layer, block_tables, v_scales).float()
    qg = q.reshape(B, T, Hkv, G, D).float() * scale
    s = torch.einsum("btkgd,kbsd->bktgs", qg, k)
    valid = torch.arange(k.shape[2], device=q.device)[None, :] < hist_lens[:, None]
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]) * valid[:, None, None, None, :]
    l = p.sum(-1)
    o = torch.einsum("bktgs,kbsd->bktgd", p, v) / l.clamp_min(1e-20)[..., None]
    return o, m, l


def decode_attention_xla(
    q: torch.Tensor,  # [B, H, D] one new token per sequence
    k_cache_layer: torch.Tensor,  # [Hkv, N, bs, D]
    v_cache_layer: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,  # [B] int32 (includes the new token)
    scale: float,
    k_scales: Optional[torch.Tensor] = None,  # [N] f32 with int8 pages
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:  # [B, H, D]
    """Dense gather + masked softmax in the query dtype (the JAX XLA path's
    arithmetic: scores in the compute dtype, softmax in f32; int8 pages
    dequantize in f32, then cast to the query dtype)."""
    B, H, D = q.shape
    Hkv = k_cache_layer.shape[0]
    G = H // Hkv
    k = gather_pages(k_cache_layer, block_tables, k_scales).to(q.dtype)
    v = gather_pages(v_cache_layer, block_tables, v_scales).to(q.dtype)
    qg = q.reshape(B, Hkv, G, D)
    scores = torch.einsum("bkgd,kbtd->bkgt", qg * scale, k).float()
    mask = torch.arange(k.shape[2], device=q.device)[None, :] < seq_lens[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p * mask[:, None, None, :]
    probs = (p / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(v.dtype)
    return torch.einsum("bkgt,kbtd->bkgd", probs, v).reshape(B, H, D)


def chunk_attention_with_cache(
    q: torch.Tensor,  # [T, H, D] chunk queries
    k_chunk: torch.Tensor,  # [T, Hkv, D]
    v_chunk: torch.Tensor,
    k_cache_layer: torch.Tensor,  # [Hkv, num_blocks, bs, D]
    v_cache_layer: torch.Tensor,
    block_table: torch.Tensor,  # [M]
    history_len,
    valid_len,
    scale: float,
    window: int = 0,
    sinks: Optional[torch.Tensor] = None,
    cap: float = 0.0,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Prefill dispatcher: the paged prefill kernel (plain twin on CPU).
    Write-before-attend: the chunk's K/V must ALREADY be in the cache, so
    ``k_chunk``/``v_chunk`` are unused (they feed the dense twin
    :func:`chunk_attention_with_cache_xla`). Real rows (t < valid_len)
    agree between the two; padded rows come out zero (discarded by every
    caller). ``window`` and ``sinks`` go to the kernel."""
    _no_softcap("chunk_attention_with_cache", cap)
    return paged_prefill_attention(
        q, k_cache_layer, v_cache_layer, block_table, history_len, scale,
        window=window, sinks=sinks, valid_len=valid_len, k_scales=k_scales,
        v_scales=v_scales,
    )


def chunk_attention_with_cache_xla(
    q: torch.Tensor,  # [T, H, D] chunk queries
    k_chunk: torch.Tensor,  # [T, Hkv, D]
    v_chunk: torch.Tensor,  # [T, Hkv, D]
    k_cache_layer: torch.Tensor,  # [Hkv, num_blocks, bs, D]
    v_cache_layer: torch.Tensor,
    block_table: torch.Tensor,  # [M] this sequence's blocks
    history_len,  # tokens already in cache
    valid_len,  # real tokens in this chunk
    scale: float,
    k_scales: Optional[torch.Tensor] = None,  # [N] f32 with int8 pages
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Queries attend cached history (read from the cache, dequantized with
    per-page scales) plus the causal prefix of the chunk (read from the
    arguments, at full precision)."""
    T, H, D = q.shape
    Hkv, _, bs, _ = k_cache_layer.shape
    G = H // Hkv
    S_hist = block_table.shape[0] * bs
    dev = q.device
    hist = torch.as_tensor(history_len, device=dev).reshape(())
    valid = torch.as_tensor(valid_len, device=dev).reshape(())
    k_hist = gather_pages(k_cache_layer, block_table, k_scales).to(k_chunk.dtype)
    v_hist = gather_pages(v_cache_layer, block_table, v_scales).to(v_chunk.dtype)
    k_all = torch.cat([k_hist, k_chunk.transpose(0, 1)], dim=1)  # [Hkv, S, D]
    v_all = torch.cat([v_hist, v_chunk.transpose(0, 1)], dim=1)
    qg = q.reshape(T, Hkv, G, D)
    scores = torch.einsum("tkgd,ksd->tkgs", qg * scale, k_all).float()
    ar = torch.arange(S_hist + T, device=dev)
    q_pos = hist + torch.arange(T, device=dev)
    kv_pos = torch.cat([torch.arange(S_hist, device=dev), q_pos])
    kv_valid = torch.where(ar < S_hist, ar < hist, (ar - S_hist) < valid)
    mask = (q_pos[:, None] >= kv_pos[None, :]) & kv_valid[None, :]  # [T, S]
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p * mask[:, None, None, :]
    probs = (p / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(v_all.dtype)
    return torch.einsum("tkgs,ksd->tkgd", probs, v_all).reshape(T, H, D)


def chunk_slot_indices(
    block_tables: torch.Tensor,  # [M] or [MP, M]
    start_pos,  # int / 0-d tensor, or [MP] tensor: first position per chunk
    T: int,
    block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical block, in-block offset) of every row of a T-row chunk
    (``[T]``, or ``[MP, T]`` for stacked tables). Padded tail rows that run
    past the table land in the reserved trash page 0 (the JAX gather
    clamps the index instead)."""
    M = block_tables.shape[-1]
    ar = torch.arange(T, device=block_tables.device)
    if torch.is_tensor(start_pos) and start_pos.dim() == 1:
        pos = start_pos.long()[:, None] + ar[None, :]
    else:
        pos = ar + start_pos
    idx = pos // block_size
    blk = torch.gather(
        block_tables.long(), -1,
        idx.clamp_max(M - 1).reshape(*block_tables.shape[:-1], -1),
    ).reshape(idx.shape)
    return torch.where(idx < M, blk, 0), pos % block_size


def write_slots(
    cache_layer: torch.Tensor,  # [Hkv, num_blocks, bs, D] — updated IN PLACE
    rows: torch.Tensor,  # [R, Hkv, D]
    blk: torch.Tensor,  # [R] physical page per row
    off: torch.Tensor,  # [R] row within the page
) -> torch.Tensor:
    """Store ``rows`` at their slots, cast to the cache's type (an fp8
    cache with the reference's cast, ``models/quant.to_e4m3``)."""
    target, values = store_codes(cache_layer, rows.transpose(0, 1))
    target[:, blk.long(), off.long()] = values
    return cache_layer


def write_chunk_to_cache(
    cache_layer: torch.Tensor,  # [Hkv, num_blocks, bs, D] — updated IN PLACE
    chunk: torch.Tensor,  # [T, Hkv, D]
    block_table: torch.Tensor,  # [M]
    start_pos,  # first absolute position of the chunk (int or 0-d tensor)
) -> torch.Tensor:
    """Scatter a chunk's K or V into its paged blocks."""
    blk, off = chunk_slot_indices(
        block_table, start_pos, chunk.shape[0], cache_layer.shape[2]
    )
    return write_slots(cache_layer, chunk, blk, off)


def decode_slot_indices(
    block_tables: torch.Tensor,  # [B, M]
    positions: torch.Tensor,  # [B]
    block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical block, in-block offset) of each sequence's write slot."""
    blk = torch.gather(block_tables, 1, (positions // block_size)[:, None].long())
    return blk[:, 0], positions % block_size


def write_decode_token_to_cache(
    cache_layer: torch.Tensor,  # [Hkv, num_blocks, bs, D] — updated IN PLACE
    token_kv: torch.Tensor,  # [B, Hkv, D]
    block_tables: torch.Tensor,  # [B, M]
    positions: torch.Tensor,  # [B] absolute position of the new token
) -> torch.Tensor:
    blk, off = decode_slot_indices(block_tables, positions, cache_layer.shape[2])
    return write_slots(cache_layer, token_kv, blk, off)


def _requantize_and_write(cache_layer, scales, rows, blk, off, amax_rows,
                          qmax: float, eps: float):
    """The shared core of the quantized writers: grow the pages' scales by
    a scatter-max of the rows' absmax / qmax, requantize every touched page
    by its old/new ratio (duplicates carry identical ratios and contents,
    so the scatter is deterministic), land the rows quantized against the
    NEW scales. ``rows [R, Hkv, D]`` f32; returns the new scale slice."""
    pages = blk.long()
    # times the f32 reciprocal of qmax: the jitted reference's arithmetic
    # (XLA rewrites a division by a constant so), bit for bit
    new_scales = scales.scatter_reduce(
        0, pages, torch.clamp_min(amax_rows * (1.0 / qmax), eps), reduce="amax",
        include_self=True,
    )
    new_at = new_scales[pages]
    r = scales[pages] / new_at  # [R], <= 1; == 1 round-trips exactly
    resident = cache_layer[:, pages].float() * r[None, :, None, None]
    cache_layer[:, pages] = torch.clamp(torch.round(resident), -qmax, qmax).to(
        cache_layer.dtype)
    q = torch.clamp(torch.round(rows / new_at[:, None, None]), -qmax, qmax)
    cache_layer[:, pages, off.long()] = q.transpose(0, 1).to(cache_layer.dtype)
    return new_scales


def write_chunk_to_cache_quantized(
    cache_layer: torch.Tensor,  # [Hkv, N, bs, D] int8 — updated IN PLACE
    scales: torch.Tensor,  # [N] f32 this layer's per-page scale plane
    chunk: torch.Tensor,  # [T, Hkv, D] full-precision K or V rows
    block_table: torch.Tensor,  # [M]
    start_pos,  # first absolute position of the chunk
    valid_len,  # real (unpadded) tokens in the chunk
    qmax: float = KV_INT8_QMAX,
    eps: float = KV_SCALE_EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`write_chunk_to_cache` for the int8-with-scales cache. Padded
    tail rows are zeroed first, so they neither inflate a real page's scale
    nor write garbage into its tail slots. Returns ``(cache_layer,
    new_scales)``."""
    T = chunk.shape[0]
    blk, off = chunk_slot_indices(block_table, start_pos, T,
                                  cache_layer.shape[2])
    valid = torch.as_tensor(valid_len, device=chunk.device).reshape(())
    real = torch.arange(T, device=chunk.device) < valid
    cf = chunk.float() * real[:, None, None]
    new_scales = _requantize_and_write(
        cache_layer, scales, cf, blk, off, cf.abs().amax(dim=(1, 2)), qmax, eps)
    return cache_layer, new_scales


def write_decode_token_to_cache_quantized(
    cache_layer: torch.Tensor,  # [Hkv, N, bs, D] int8 — updated IN PLACE
    scales: torch.Tensor,  # [N] f32 this layer's per-page scale plane
    token_kv: torch.Tensor,  # [B, Hkv, D] full-precision rows
    block_tables: torch.Tensor,  # [B, M]
    positions: torch.Tensor,  # [B] absolute position of the new token
    qmax: float = KV_INT8_QMAX,
    eps: float = KV_SCALE_EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`write_decode_token_to_cache` for the int8-with-scales cache:
    the same scale growth, page requantization and quantized row write, one
    row per sequence. Padded batch rows target the trash page 0 (its scale
    may grow and its content is garbage; page 0 is never read). Returns
    ``(cache_layer, new_scales)``."""
    blk, off = decode_slot_indices(block_tables, positions, cache_layer.shape[2])
    xf = token_kv.float()
    new_scales = _requantize_and_write(
        cache_layer, scales, xf, blk, off, xf.abs().amax(dim=(1, 2)), qmax, eps)
    return cache_layer, new_scales
