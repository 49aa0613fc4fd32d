"""Ragged paged attention for the fused mixed prefill+decode step.

Counterpart of ``dynamo_tpu/ops/ragged_paged_attention_pallas.py``: ONE
call computes B decode rows (one query token per sequence, each against
its own block table and length) and MP prefill segments (each against its
own sequence's history plus the causal prefix of the segment). Everything
is write-before-attend, so every row attends ``kv_pos <= q_pos`` through
its table. On CUDA tensors it launches ``csrc/paged_attention.cu`` over the
ragged tile list (bf16: the segment tiles on the tensor cores, the decode
tiles on CUDA cores with split horizons, in one launch); on CPU tensors it
takes the plain version below.

The JAX wrapper builds per-tile metadata (``tile_seq``, ``tile_q0``,
``tile_last``; ragged_paged_attention_pallas.py:299-318) and scalar-
prefetches it. The CUDA kernel derives the same three values per block
from ``d_seq_lens``/``p_hists``/``p_valids``: tiles 0..B-1 are the decode
rows (q0 = seq_len - 1), then segment-major Tq-token slices of every
segment (q0 = hist + j*Tq, last = q0 + real - 1, or -1 for a tile with no
real row, which attends nothing and writes zeros).

A sliding ``window`` holds for the decode rows and the segment rows alike
(``q_pos - kv_pos < window``, the kernel's walk starting at each tile's
floor), and per-head ``sinks`` fold into every row's normalizer in the
kernel, as the TPU kernel's emit does (ragged_paged_attention_pallas.py
:193-206).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .paged_attention import (
    _sinks_hg,
    gather_pages,
    launch_paged_attention,
    masked_attention,
)


def ragged_mixed_attention_plain(
    q_dec, q_chunks, k_cache_layer, v_cache_layer, d_tables, d_seq_lens,
    p_tables, p_hists, p_valids, scale, k_scales=None, v_scales=None,
    window: int = 0, sinks=None,
):
    """Gather pages per table (dequantized with per-page scales), masked
    softmax in f32, each row from its window floor ``q_pos - window + 1``.
    Rows of a segment past its ``p_valids`` (padding, dead segments) are
    zero, as in the kernel."""
    B, H, D = q_dec.shape
    MP, T = q_chunks.shape[:2]
    Hkv = k_cache_layer.shape[0]
    G = H // Hkv
    sk = _sinks_hg(sinks, Hkv)

    def floor(q_pos):
        return q_pos - window + 1 if window > 0 else None

    d_pos = d_seq_lens.long() - 1
    o_dec, _, _ = masked_attention(
        q_dec.reshape(B, Hkv, G, D).float() * scale,
        gather_pages(k_cache_layer, d_tables, k_scales),
        gather_pages(v_cache_layer, d_tables, v_scales), d_pos, floor(d_pos),
        sk,
    )
    t = torch.arange(T, device=q_dec.device)
    outs = []
    for m in range(MP):
        real = t < p_valids[m]
        q_pos = p_hists[m].long() + t
        o, _, _ = masked_attention(
            q_chunks[m].reshape(T, Hkv, G, D).float() * scale,
            gather_pages(k_cache_layer, p_tables[m], k_scales)[:, None],
            gather_pages(v_cache_layer, p_tables[m], v_scales)[:, None],
            torch.where(real, q_pos, -1), floor(q_pos), sk,
        )
        outs.append(o)
    o_chunks = (
        torch.stack(outs) if outs
        else q_chunks.new_zeros((0, T, Hkv, G, D), dtype=torch.float32)
    )
    return (
        o_dec.reshape(B, H, D).to(q_dec.dtype),
        o_chunks.reshape(MP, T, H, D).to(q_chunks.dtype),
    )


def ragged_mixed_attention(
    q_dec: torch.Tensor,  # [B, H, D] decode queries (token ALREADY written)
    q_chunks: torch.Tensor,  # [MP, T, H, D] segment queries (ALREADY written)
    k_cache_layer: torch.Tensor,  # [Hkv, N, bs, D]
    v_cache_layer: torch.Tensor,
    d_tables: torch.Tensor,  # [B, M] int32 decode block tables
    d_seq_lens: torch.Tensor,  # [B] int32, INCLUDING the new token
    p_tables: torch.Tensor,  # [MP, M] int32 the prefill sequences' tables
    p_hists: torch.Tensor,  # [MP] int32 tokens cached before each segment
    p_valids: torch.Tensor,  # [MP] int32 real tokens in each segment
    scale: float,
    q_tile: int = 0,  # 0 -> as many tokens as fill one kernel tile
    pages_per_step: int = 0,
    window: int = 0,
    sinks: Optional[torch.Tensor] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:  # (o_dec [B,H,D], o_chunks [MP,T,H,D])
    """Decode row b sits at q_pos = d_seq_lens[b]-1; segment m's row t at
    p_hists[m] + t. Inactive decode slots (seq_len 0), dead segments
    (p_valids[m] == 0) and padded segment rows emit zeros. ``k_scales`` /
    ``v_scales`` ([N] f32) come with int8 pages; ``window`` keeps every
    row to ``q_pos - kv_pos < window``; ``sinks`` ([H] f32) join every
    row's normalizer."""
    B, H, D = q_dec.shape
    MP, T = q_chunks.shape[0], q_chunks.shape[1]
    if q_dec.device.type == "cpu":
        return ragged_mixed_attention_plain(
            q_dec, q_chunks, k_cache_layer, v_cache_layer, d_tables,
            d_seq_lens, p_tables, p_hists, p_valids, scale, k_scales, v_scales,
            window, sinks,
        )
    o = ragged_mixed_attention_rows(
        torch.cat([q_dec.reshape(B, H, D), q_chunks.reshape(MP * T, H, D)]),
        k_cache_layer, v_cache_layer, d_tables, d_seq_lens, p_tables,
        p_hists, p_valids, scale, T, q_tile, k_scales, v_scales, window,
        sinks,
    )
    return o[:B], o[B:].reshape(MP, T, H, D)


def ragged_mixed_attention_rows(
    q: torch.Tensor,  # [B + MP*T, H, D] decode rows, then the segments' rows
    k_cache_layer: torch.Tensor,
    v_cache_layer: torch.Tensor,
    d_tables: torch.Tensor,
    d_seq_lens: torch.Tensor,
    p_tables: torch.Tensor,
    p_hists: torch.Tensor,
    p_valids: torch.Tensor,
    scale: float,
    T: int,  # padded tokens per segment
    q_tile: int = 0,
    k_scales: Optional[torch.Tensor] = None,  # [N] f32 with int8 pages
    v_scales: Optional[torch.Tensor] = None,
    window: int = 0,
    sinks: Optional[torch.Tensor] = None,  # [H] f32
) -> torch.Tensor:  # [B + MP*T, H, D]
    """:func:`ragged_mixed_attention` on the flat row axis the mixed step
    already holds, so the kernel reads ``q`` and writes ``o`` with no
    split or concatenation. Its launches count in
    ``ragged_mixed_attention.launches`` (and, with a window, in its
    ``window_launches``)."""
    B, MP = d_tables.shape[0], p_tables.shape[0]
    Ntok, H, D = q.shape
    if q.device.type == "cpu":
        o_dec, o_chunks = ragged_mixed_attention_plain(
            q[:B], q[B:].reshape(MP, T, H, D), k_cache_layer, v_cache_layer,
            d_tables, d_seq_lens, p_tables, p_hists, p_valids, scale,
            k_scales, v_scales, window, sinks,
        )
        return torch.cat([o_dec, o_chunks.reshape(MP * T, H, D)])
    Hkv = k_cache_layer.shape[0]
    G = H // Hkv
    o, _, _ = launch_paged_attention(
        q.reshape(Ntok, Hkv, G, D), k_cache_layer, v_cache_layer, scale,
        d_tables=d_tables, d_seq_lens=d_seq_lens, p_tables=p_tables,
        p_hists=p_hists, p_valids=p_valids, T=T,
        Tq=q_tile, k_scales=k_scales, v_scales=v_scales, window=window,
        sinks=sinks, name="ragged_mixed_attention",
    )
    ragged_mixed_attention.launches += 1
    if window > 0:
        ragged_mixed_attention.window_launches += 1
    return o.reshape(Ntok, H, D)


_cuda.counted(ragged_mixed_attention, "window_launches")
