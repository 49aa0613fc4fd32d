"""Paged LATENT attention for MLA decode and prefill: CUDA kernel + plain twin.

Counterpart of ``dynamo_tpu/ops/mla_attention_pallas.py``. The cache holds
one latent stream per token, shared by all H query heads (MQA-shaped):
``c [1, N, bs, C]`` (the kv_lora_rank latents, which are also the VALUES)
and ``pe [1, N, bs, R]`` (the rotated rope keys). A query row scores
position s as ``q_eff . c[s] + q_pe . pe[s]`` (scaled), fp32 softmax.

  * :func:`mla_paged_decode_attention` — one token per sequence over its
    ``seq_lens[b]`` cached positions, optionally with the softmax
    statistics (m, l);
  * :func:`mla_decode_attention_merged` — the merged one-write decode: the
    kernel's statistics over the history plus the flash merge of the
    current token, which is NOT in the cache;
  * :func:`mla_paged_prefill_attention` — a chunk of T tokens over history
    plus the chunk itself (already written), causal at absolute positions;
  * :func:`mla_verify_attention` — the speculative verify's T in-flight
    tokens, NOT in the cache: the kernel's statistics over the history
    (the T*H query rows packed into its head dimension) plus the dense
    causal window, merged with the flash rule; :func:`mla_verify_attention_xla`
    is its plain twin (the reference's XLA branch).

On CUDA tensors the entry points launch ``csrc/mla_attention.cu`` (a
tensor-core body for bf16 latents up to :func:`tc_takes`' widths, a
CUDA-core body for f32 and for wider bf16 latents, both functions in one
launch each); on CPU tensors they take their plain twins below. Both bodies
also read ``float8_e4m3fn`` latent pages (the scale-free fp8 cache) under
bf16 queries, widening the codes exactly; the twins widen them with
``.float()``, as the reference's XLA path does with ``astype(float32)``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _cuda

NEG_INF = -1e30
FP8 = torch.float8_e4m3fn
#: the kernel's dtype code for bf16 queries over float8_e4m3fn latent pages
FP8_PAGES = 2
#: the tensor-core body's two tile shapes: warps per 16-row group ->
#: kv positions per step (2: 64-row tiles, the prefill chunks and decode
#: launches of more than 16 rows per sequence; 8: 16-row decode tiles)
TC_KVT = {2: 32, 8: 64}
#: most output columns per block; a wider kv_lora_rank takes column slabs
TC_SLAB = 512
#: widest padded latent row (C + R rounded up to 64) the tiles hold
TC_DP_MAX = 768
#: most horizon splits per decode unit, and the fewest positions a split
#: takes of a horizon that has them
MAX_SPLITS = 16
MIN_SPLIT_POSITIONS = 128
_SMEM_MAX = 231424  # dynamic shared memory a block takes (csrc SMEM_MAX)
_SRC = "mla_attention.cu"


class TilePlan(NamedTuple):
    """How a bf16 launch cuts its work into blocks (``csrc/mla_attention.cu``
    mla_tc_kernel): tiles of ``rows`` query rows (``n_rt`` of them per
    sequence, or of the prefill chunk), ``n_slabs`` slabs of ``slab``
    output columns each, and for decode ``n_split`` horizon splits of at
    least ``min_steps`` steps of ``kvt`` positions."""

    wpg: int  # warps per 16-row group
    kvt: int
    rows: int
    n_rt: int
    slab: int
    n_slabs: int
    stages: int
    n_split: int
    min_steps: int


def padded_row(C: int, R: int) -> int:
    """A latent row in the tensor-core body's shared memory: C + R rounded
    up to 64 values (whole swizzle rows)."""
    return C + -(-R // 64) * 64


def _tc_smem(wpg: int, dp: int, stages: int, kd: int = 0) -> int:
    """The tensor-core block's shared memory (``csrc`` tc_smem): the Q
    tile, the bf16 ring, the S exchange and, over fp8 pages (``kd``, the
    score depth C + R rounded up to 16, else 0), the codes of the steps in
    flight."""
    rows, kvt = 128 // wpg, TC_KVT[wpg]
    return (rows * dp * 2 + stages * kvt * dp * 2 + rows * (kvt + 8) * 4
            + (stages - 1) * kvt * kd)


def takes_widths(C: int, R: int) -> bool:
    """The latent widths both kernels take on the card: kv_lora_rank
    ``C % 128 == 0`` and any rope width ``R >= 1`` (the reference engine's
    gate), as far as the CUDA-core body holds a row's f32 query and one
    warp's accumulators in a block's shared memory (C up to ~28900)."""
    return (C > 0 and C % 128 == 0 and R >= 1
            and 4 * (-(-(C + R) // 4) * 4 + C) + 8 <= _SMEM_MAX)


def tc_takes(C: int, R: int) -> bool:
    """The widths a bf16 launch runs on the tensor-core body: a padded row
    of at most :data:`TC_DP_MAX` values and ``R <= 128`` (C <= 640 at any
    such R: a 64-row query tile plus a 2-stage ring of such rows fills the
    227 KB a block can use). Wider latents run the CUDA-core body (the
    kernel's width dispatch)."""
    return R <= 128 and padded_row(C, R) <= TC_DP_MAX


def tile_plan(C: int, R: int, rows: int, B: int = 0, sms: int = 132,
              fp8: bool = False) -> TilePlan:
    """The block plan of a bf16-query launch: ``rows`` query rows per
    sequence (decode, ``B`` sequences) or of the prefill chunk (``B ==
    0``); ``fp8``: over ``float8_e4m3fn`` pages, whose staged codes take
    shared memory beside the ring (a 16-row tile that cannot hold them at
    two stages takes 64-row tiles). Decode splits every (sequence, row
    tile, slab) unit's horizon until the grid holds about one block per SM
    (the body's occupancy); the device then takes only as many splits as
    :func:`split_ranges` says a sequence's length needs, with no host read
    of the lengths."""
    dp = padded_row(C, R)
    kd = C + -(-R // 16) * 16 if fp8 else 0
    wpg = 8 if B and rows <= 16 and _tc_smem(8, dp, 2, kd) <= _SMEM_MAX else 2
    kvt, rt = TC_KVT[wpg], 128 // wpg
    stages = 3 if _tc_smem(wpg, dp, 3, kd) <= _SMEM_MAX else 2
    n_slabs = -(-C // TC_SLAB)
    slab = 128 * -(-(C // 128) // n_slabs)
    n_rt = -(-rows // rt)
    n_split = 1
    if B:
        n_split = min(MAX_SPLITS, max(1, -(-sms // (B * n_rt * n_slabs))))
    return TilePlan(wpg, kvt, rt, n_rt, slab, n_slabs, stages, n_split,
                    max(1, MIN_SPLIT_POSITIONS // kvt))


def split_ranges(n: int, plan: TilePlan) -> list:
    """The kv positions ``[begin, end)`` of each live split of a decode
    horizon of ``n`` positions, as the kernel cuts it on the device (one
    empty range when ``n == 0``: the block that writes the empty row)."""
    steps = -(-n // plan.kvt)
    per = max(-(-steps // plan.n_split), plan.min_steps)
    live = max(1, -(-steps // per))
    return [(z * per * plan.kvt, min(n, (z + 1) * per * plan.kvt))
            for z in range(live)]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def launch_mla_attention(
    q_eff: torch.Tensor,  # [Ntok, H, C]
    q_pe: torch.Tensor,  # [Ntok, H, R]
    c_cache_layer: torch.Tensor,  # [1, N, bs, C]
    pe_cache_layer: torch.Tensor,  # [1, N, bs, R]
    tables: torch.Tensor,  # decode [B, M]; prefill [M]
    scale: float,
    *,
    seq_lens: Optional[torch.Tensor] = None,  # decode [B] int32
    hist: Optional[torch.Tensor] = None,  # prefill [1] int32
    valid: Optional[torch.Tensor] = None,  # prefill [1] int32 or None (= T)
    stats: bool = False,
    out_f32: bool = False,
    name: str = "mla_attention",
):
    """Launch ``csrc/mla_attention.cu``: decode when ``seq_lens`` is given
    (one table row per sequence, its H query rows), else prefill of one
    T-token chunk. Returns ``o [Ntok, H, C]`` (q's dtype, or f32 with
    ``out_f32``) and, with ``stats``, ``m``/``l`` f32 ``[Ntok, H]``. bf16
    queries run the tensor-core body where :func:`tc_takes` the widths,
    over bf16 or ``float8_e4m3fn`` pages (kernel dtype codes 1 and 2); f32
    (f32 pages only) and wider latents the CUDA-core body. Validates every
    input and raises on what the kernel does not take."""
    Ntok, H, C = q_eff.shape
    _, N, bs, Cc = c_cache_layer.shape
    R = pe_cache_layer.shape[-1]
    decode = seq_lens is not None
    idx = [t for t in (tables, seq_lens, hist, valid) if t is not None]
    _cuda.require_cuda(name, q_eff, q_pe, c_cache_layer, pe_cache_layer, *idx)
    _cuda.require_int32(name, *idx)
    dt = q_eff.dtype
    fp8 = c_cache_layer.dtype == FP8
    if fp8:
        if dt != torch.bfloat16 or q_pe.dtype != dt or pe_cache_layer.dtype != FP8:
            raise ValueError(f"{name}: float8_e4m3fn latent pages take bf16 "
                             f"queries and fp8 rope keys, got {dt} / "
                             f"{q_pe.dtype} / {pe_cache_layer.dtype}")
        code = FP8_PAGES
    elif dt not in _cuda.DTYPE_CODES or {q_pe.dtype, c_cache_layer.dtype,
                                         pe_cache_layer.dtype} != {dt}:
        raise ValueError(f"{name}: queries and caches must share one of "
                         f"{list(_cuda.DTYPE_CODES)}, or bf16 queries over "
                         "float8_e4m3fn pages")
    else:
        code = _cuda.DTYPE_CODES[dt]
    if (not takes_widths(C, R) or Cc != C
            or q_pe.shape != (Ntok, H, R) or c_cache_layer.shape[0] != 1
            or pe_cache_layer.shape != (1, N, bs, R)):
        raise ValueError(
            f"{name}: latent widths C={C} (cache {Cc}), R={R} do not fit the "
            f"kernel (C % 128 == 0, R >= 1) or the shapes disagree")
    if decode and (tables.dim() != 2 or tables.shape[0] != Ntok
                   or seq_lens.shape != (Ntok,)):
        raise ValueError(f"{name}: decode tables {tuple(tables.shape)} / "
                         f"seq_lens do not fit {Ntok} tokens")
    if not decode and (tables.dim() != 1 or hist is None
                       or hist.numel() != 1):
        raise ValueError(f"{name}: prefill takes one [M] table and [1] hist")
    for t in (q_eff, q_pe, c_cache_layer, pe_cache_layer):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    dev = q_eff.device
    o = torch.empty((Ntok, H, C), dtype=torch.float32 if out_f32 else dt,
                    device=dev)
    m = l = None
    if stats:
        m = torch.empty((Ntok, H), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
    plan = tile_plan(C, R, H if decode else Ntok * H, Ntok if decode else 0,
                     _cuda.sm_count(dev), fp8=fp8)
    scratch = tickets = None
    if dt == torch.bfloat16 and tc_takes(C, R) and plan.n_split > 1:
        rows = Ntok * H
        scratch = _cuda.device_buffer(
            "mla partials", dev,
            plan.n_split * rows * (2 * plan.n_slabs + C // 2) + 4,
            torch.float32)
        tickets = _cuda.device_buffer("tickets", dev,
                                      Ntok * plan.n_rt * plan.n_slabs, torch.int32)
    err = _cuda.lib(_SRC).mla_attention_launch(
        _ptr(q_eff), _ptr(q_pe), _ptr(o), _ptr(m), _ptr(l),
        _ptr(c_cache_layer), _ptr(pe_cache_layer), _ptr(tables),
        _ptr(seq_lens), _ptr(hist), _ptr(valid),
        Ntok if decode else 0, 0 if decode else Ntok, H, N, bs,
        tables.shape[-1], C, R, float(scale), int(out_f32), plan.wpg,
        plan.stages, plan.slab, plan.n_split, plan.min_steps, _ptr(scratch),
        _ptr(tickets), code,
        ctypes.c_void_p(_cuda.stream_ptr(q_eff)),
    )
    _cuda.check(err, name)
    return o, m, l


# ---------------- plain PyTorch twins (CPU path + kernel oracle) ----------------


def gather_latents(cache_layer: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``[1, N, bs, D]`` pages of ``table [..., M]`` -> ``[..., M*bs, D]``
    (logical positions in order; fp8 pages gathered as their bytes and
    returned as they are: the caller widens them)."""
    if cache_layer.dtype == FP8:
        g = cache_layer[0].view(torch.uint8)[table.long()].view(FP8)
    else:
        g = cache_layer[0][table.long()]
    return g.reshape(*table.shape[:-1], -1, cache_layer.shape[-1])


def latent_attention(q_eff, q_pe, c, pe, limit, scale):
    """Row r of ``q [R_, H, *]`` attends positions ``0..limit[r]`` of ``c
    [R_ or 1, S, C]`` / ``pe``: f32 softmax with the TPU kernels'
    statistics (``m`` NEG_INF and ``l`` 0 where nothing is attended, ``o``
    normalized, 0 then). Returns ``o [R_, H, C]`` f32, ``m``/``l`` ``[R_,
    H]``."""
    c, pe = c.float(), pe.float()
    s = (torch.einsum("rhc,rsc->rhs", q_eff.float() * scale, c.expand(q_eff.shape[0], -1, -1))
         + torch.einsum("rhd,rsd->rhs", q_pe.float() * scale, pe.expand(q_pe.shape[0], -1, -1)))
    pos = torch.arange(s.shape[-1], device=s.device)
    valid = (pos[None, :] <= limit[:, None].long())[:, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]) * valid
    l = p.sum(-1)
    o = torch.einsum("rhs,rsc->rhc", p, c.expand(q_eff.shape[0], -1, -1))
    return o / l.clamp_min(1e-20)[..., None], m, l


def mla_paged_decode_attention_plain(
    q_eff, q_pe, c_cache_layer, pe_cache_layer, block_tables, seq_lens, scale,
    return_stats: bool = False,
):
    """Gather the latent pages through the tables, masked f32 softmax."""
    o, m, l = latent_attention(
        q_eff, q_pe, gather_latents(c_cache_layer, block_tables),
        gather_latents(pe_cache_layer, block_tables), seq_lens.long() - 1,
        scale,
    )
    o = o.to(q_eff.dtype)
    return (o, m, l) if return_stats else o


def mla_paged_prefill_attention_plain(
    q_eff, q_pe, c_cache_layer, pe_cache_layer, block_table, history_len,
    scale, valid_len=None,
):
    T = q_eff.shape[0]
    dev = q_eff.device
    hist = torch.as_tensor(history_len, device=dev).reshape(())
    t = torch.arange(T, device=dev)
    limit = hist + t
    if valid_len is not None:
        valid = torch.as_tensor(valid_len, device=dev).reshape(())
        limit = torch.where(t < valid, limit, -1)
    o, _, _ = latent_attention(
        q_eff, q_pe, gather_latents(c_cache_layer, block_table)[None],
        gather_latents(pe_cache_layer, block_table)[None], limit, scale,
    )
    return o


# ---------------- entry points ----------------


def mla_paged_decode_attention(
    q_eff: torch.Tensor,  # [B, H, C] absorbed queries
    q_pe: torch.Tensor,  # [B, H, R]
    c_cache_layer: torch.Tensor,  # [1, N, bs, C]
    pe_cache_layer: torch.Tensor,  # [1, N, bs, R]
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,  # [B] int32
    scale: float,
    pages_per_step: int = 0,
    return_stats: bool = False,
    tokens: int = 1,
):  # [B, H, C] in q's dtype, or (out, m [B, H], l [B, H]) with return_stats
    """MLA latent decode over ``seq_lens[b]`` cached positions.
    ``pages_per_step`` is the TPU kernel's DMA grouping and is ignored.
    ``tokens`` > 1 says the H rows pack that many in-flight tokens' heads
    (the verify): such a launch also counts in ``verify_launches``. Rows
    with ``seq_len == 0`` return o = 0, m = -1e30, l = 0."""
    if q_eff.device.type == "cpu":
        return mla_paged_decode_attention_plain(
            q_eff, q_pe, c_cache_layer, pe_cache_layer, block_tables,
            seq_lens, scale, return_stats,
        )
    o, m, l = launch_mla_attention(
        q_eff.contiguous(), q_pe.contiguous(), c_cache_layer, pe_cache_layer,
        block_tables, scale, seq_lens=seq_lens, stats=return_stats,
        name="mla_paged_decode_attention",
    )
    mla_paged_decode_attention.launches += 1
    if tokens > 1:
        mla_paged_decode_attention.verify_launches += 1
    return (o, m, l) if return_stats else o


_cuda.counted(mla_paged_decode_attention, "verify_launches")


def mla_decode_attention_merged(
    q_eff: torch.Tensor,  # [B, H, C]
    q_pe: torch.Tensor,  # [B, H, R]
    c_new: torch.Tensor,  # [B, C] current token's latent (NOT in cache)
    pe_new: torch.Tensor,  # [B, R] current token's rotated k_pe
    c_cache_layer: torch.Tensor,  # [1, N, bs, C] history only
    pe_cache_layer: torch.Tensor,  # [1, N, bs, R]
    block_tables: torch.Tensor,  # [B, M]
    hist_lens: torch.Tensor,  # [B] tokens in cache (EXCLUDES current)
    scale: float,
) -> torch.Tensor:  # [B, H, C] f32 latent output
    """MLA decode with the current token handled OUT of the cache: history
    through the stats-emitting latent kernel, the current token's score
    ``q_eff . c_new + q_pe . pe_new`` (value ``c_new``, shared by the heads)
    folded in with the flash merge, so all layers' latent writes batch into
    one in-place append. ``hist_lens == 0`` rows give ``c_new``."""
    o_h, m_h, l_h = mla_paged_decode_attention(
        q_eff, q_pe, c_cache_layer, pe_cache_layer, block_tables, hist_lens,
        scale, return_stats=True,
    )
    s_new = (torch.einsum("bhc,bc->bh", q_eff.float(), c_new.float())
             + torch.einsum("bhr,br->bh", q_pe.float(), pe_new.float())) * scale
    m_f = torch.maximum(m_h, s_new)
    kept = l_h * torch.exp(m_h - m_f)  # history's share of the normalizer
    p_new = torch.exp(s_new - m_f)
    num = kept[..., None] * o_h.float() + p_new[..., None] * c_new[:, None, :].float()
    return num / (kept + p_new)[..., None]  # >= p_new > 0: the token is live


def _merge_window(q_eff, q_pe, c_win, pe_win, o_h, m_h, l_h, scale):
    """Fold the in-flight window's causal part into the history's (o, m, l)
    ``[B, T, H(, C)]`` with the flash rule. Returns ``[B, T, H, C]`` f32."""
    T = q_eff.shape[1]
    s_w = (torch.einsum("bthc,buc->bthu", q_eff.float(), c_win.float())
           + torch.einsum("bthr,bur->bthu", q_pe.float(), pe_win.float())) * scale
    causal = torch.ones(T, T, dtype=torch.bool, device=q_eff.device).tril()
    s_w = s_w.masked_fill(~causal[:, None, :], NEG_INF)
    m_f = torch.maximum(m_h, s_w.amax(-1))
    alpha = torch.exp(m_h - m_f)  # the history's share of the normalizer
    p_w = torch.exp(s_w - m_f[..., None])
    o_w = torch.einsum("bthu,buc->bthc", p_w, c_win.float())
    num = (l_h * alpha)[..., None] * o_h + o_w
    den = l_h * alpha + p_w.sum(-1)  # >= the diagonal term (u == t) > 0
    return num / den[..., None]


def mla_verify_attention(
    q_eff: torch.Tensor,  # [B, T, H, C] T in-flight tokens' absorbed queries
    q_pe: torch.Tensor,  # [B, T, H, R]
    c_win: torch.Tensor,  # [B, T, C] their latents (NOT in cache)
    pe_win: torch.Tensor,  # [B, T, R]
    c_cache_layer: torch.Tensor,  # [1, N, bs, C] history only
    pe_cache_layer: torch.Tensor,  # [1, N, bs, R]
    block_tables: torch.Tensor,  # [B, M] int32
    hist_lens: torch.Tensor,  # [B] int32 tokens in cache (before the window)
    scale: float,
) -> torch.Tensor:  # [B, T, H, C] f32 latent outputs
    """Multi-token latent attention for the speculative verify, with the
    whole in-flight window OUT of the cache: every history row precedes
    every window position, so the T*H query rows simply pack the
    stats-emitting decode kernel's head dimension (token-major); the tiny
    [T, T'] causal window part is dense and folds in with the flash merge.
    Keeping the window out of the cache lets the caller batch all layers'
    latent writes into ONE ``kv_cache_append_tokens``."""
    B, T, H, C = q_eff.shape
    R = q_pe.shape[-1]
    o_h, m_h, l_h = mla_paged_decode_attention(
        q_eff.reshape(B, T * H, C), q_pe.reshape(B, T * H, R), c_cache_layer,
        pe_cache_layer, block_tables, hist_lens, scale, return_stats=True,
        tokens=T,
    )
    return _merge_window(q_eff, q_pe, c_win, pe_win,
                         o_h.reshape(B, T, H, C).float(), m_h.reshape(B, T, H),
                         l_h.reshape(B, T, H), scale)


def mla_verify_attention_xla(q_eff, q_pe, c_win, pe_win, c_cache_layer,
                             pe_cache_layer, block_tables, hist_lens, scale):
    """:func:`mla_verify_attention` with the history through a dense gather
    and a masked f32 softmax (the reference's XLA branch): the plain twin
    the tests hold the kernel path to."""
    ck = gather_latents(c_cache_layer, block_tables).float()  # [B, S, C]
    kp = gather_latents(pe_cache_layer, block_tables).float()
    s = (torch.einsum("bthc,bsc->bths", q_eff.float() * scale, ck)
         + torch.einsum("bthr,bsr->bths", q_pe.float() * scale, kp))
    valid = (torch.arange(ck.shape[1], device=ck.device)[None, :]
             < hist_lens[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m_h = s.amax(-1)  # [B, T, H]
    p = torch.exp(s - m_h[..., None]) * valid
    l_h = p.sum(-1)
    o_h = torch.einsum("bths,bsc->bthc", p, ck) / l_h.clamp_min(1e-20)[..., None]
    return _merge_window(q_eff, q_pe, c_win, pe_win, o_h, m_h, l_h, scale)


def mla_paged_prefill_attention(
    q_eff: torch.Tensor,  # [T, H, C] chunk's absorbed queries
    q_pe: torch.Tensor,  # [T, H, R]
    c_cache_layer: torch.Tensor,  # [1, N, bs, C] — chunk ALREADY written
    pe_cache_layer: torch.Tensor,  # [1, N, bs, R]
    block_table: torch.Tensor,  # [M] int32, covers history + padded chunk
    history_len,  # int, or int32 tensor of one element on q's device
    scale: float,
    pages_per_step: int = 0,
    valid_len=None,  # int or one-element int32 tensor; None = all T rows
) -> torch.Tensor:  # [T, H, C] f32 latent outputs
    """Chunked-prefill latent attention over the paged MLA cache
    (write-before-attend: the caller scattered this chunk's latents first).
    Row t attends positions ``<= history_len + t``. Padded tail rows are
    discarded by every caller: as in the JAX kernel they compute values
    anyway, unless ``valid_len`` (the port's addition) says where the
    padding starts — then they come out zero and cost nothing."""
    if q_eff.device.type == "cpu":
        return mla_paged_prefill_attention_plain(
            q_eff, q_pe, c_cache_layer, pe_cache_layer, block_table,
            history_len, scale, valid_len,
        )

    def dev_i32(x):
        if torch.is_tensor(x):
            return x.reshape(1)
        return torch.tensor([x], dtype=torch.int32, device=q_eff.device)

    o, _, _ = launch_mla_attention(
        q_eff.contiguous(), q_pe.contiguous(), c_cache_layer, pe_cache_layer,
        block_table, scale, hist=dev_i32(history_len),
        valid=None if valid_len is None else dev_i32(valid_len),
        out_f32=True, name="mla_paged_prefill_attention",
    )
    mla_paged_prefill_attention.launches += 1
    return o


_cuda.counted(mla_paged_prefill_attention)
