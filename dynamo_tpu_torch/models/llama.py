"""Llama-family dense GQA decoder over a paged KV cache (PyTorch).

Counterpart of ``dynamo_tpu/models/llama.py`` for the main serving path:
chunked prefill into the paged cache (:func:`prefill`), merged decode
windows (:func:`decode_window`), and the fused mixed prefill+decode step
(:func:`mixed_step`). Public functions keep the JAX signatures, with the
JAX-only knobs (``use_pallas``, ``mesh``, ``interpret``...) dropped: each
op dispatches on its tensors' device (CUDA kernel on the card, plain
PyTorch on the CPU).

Parameters are a plain dictionary of tensors with the JAX package's tree
and layout: layers stacked on a leading axis, projection weights
``[in, out]`` (``x @ w``). The caches ``[L, Hkv, N, bs, D]`` are updated IN
PLACE (the JAX functions donate them and return new arrays; these
functions return the same tensors so call sites read alike). PyTorch runs
eagerly, so the layer loops are plain Python loops.

Covered: the Llama / Llama-3 / Mistral-without-window shape — RMS norms,
half-split rope (default or ``llama3`` scaling), SwiGLU, optional tied
embeddings. Everything else raises in :func:`check_supported`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops import attention as att
from ..ops.kv_cache_update import kv_cache_append
from ..ops.ragged_paged_attention import ragged_mixed_attention_rows
from ..ops.sampling import (
    apply_penalties,
    bump_counts,
    make_keys,
    sample_tokens,
    token_logprobs,
)
from .config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[str(cfg.dtype)]


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense GQA decoders only; other families raise."""
    unsupported = {
        "MLA": cfg.is_mla, "MoE": cfg.is_moe,
        "attention bias": cfg.attention_bias, "qk norm": cfg.qk_norm,
        "sliding window": cfg.sliding_window or cfg.layer_windows,
        "attention sinks": cfg.attn_sinks, "o_proj bias": cfg.o_bias,
        "softcap": cfg.attn_softcap or cfg.final_softcap,
        "post norms": cfg.post_norms or cfg.norm_after,
        "gemma norms/embeddings": cfg.rms_add_unit or cfg.scale_embed,
        "activation " + cfg.hidden_act: cfg.hidden_act != "silu",
        "partial rotary": bool(cfg.rope_partial_dim),
        "local rope": bool(cfg.rope_local_theta),
        "query scale base": bool(cfg.attn_scale_base),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"dynamo_tpu_torch serves dense GQA decoders; not ported yet: "
            f"{', '.join(bad)}"
        )
    _rope_kind(cfg)


# ---------------- parameters / cache ----------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cpu") -> dict:
    """Random params drawn on ``device`` (normal x 0.02, norms at 1) in the
    JAX package's tree (tests/benches; real weights come from
    models/weights.py)."""
    check_supported(cfg)
    dt = _dtype(cfg)
    E, H, Hkv, D = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    F_, V, L = cfg.intermediate_size, cfg.vocab_size, cfg.num_layers

    def normal(*shape):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, 0.02, generator=generator
        )

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    params = {
        "embed": normal(V, E),
        "final_norm": ones(E),
        "layers": {
            "attn_norm": ones(L, E), "mlp_norm": ones(L, E),
            "wq": normal(L, E, H * D), "wk": normal(L, E, Hkv * D),
            "wv": normal(L, E, Hkv * D), "wo": normal(L, H * D, E),
            "w_gate": normal(L, E, F_), "w_up": normal(L, E, F_),
            "w_down": normal(L, F_, E),
        },
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal(E, V)
    return params


def kv_cache_shapes(cfg: ModelConfig, num_blocks: int,
                    block_size: int) -> tuple[tuple, tuple]:
    """(k_shape, v_shape), both ``[L, Hkv, num_blocks, block_size, D]``."""
    s = (cfg.num_layers, cfg.num_kv_heads, num_blocks, block_size, cfg.head_dim)
    return s, s


def init_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                  device="cpu", dtype: Optional[torch.dtype] = None):
    ks, vs = kv_cache_shapes(cfg, num_blocks, block_size)
    dt = dtype or _dtype(cfg)
    return (torch.zeros(ks, dtype=dt, device=device),
            torch.zeros(vs, dtype=dt, device=device))


# ---------------- building blocks ----------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalize in f32, cast to the input dtype, THEN scale by the weight
    (the JAX package's order). The f32 normalization is one fused op."""
    xf = F.rms_norm(x.float(), (x.shape[-1],), eps=eps)
    return xf.to(x.dtype) * w


def attn_query_scale(cfg: ModelConfig) -> float:
    return (cfg.attn_scale_base or cfg.head_dim) ** -0.5


def _rope_kind(cfg: ModelConfig) -> Optional[str]:
    scaling = cfg.rope_scaling or {}
    kind = scaling.get("rope_type") or scaling.get("type")
    if kind not in (None, "default", "llama3"):
        raise NotImplementedError(
            f"rope scaling {kind!r} is not ported yet (default and llama3 are)"
        )
    return kind


def _rope_freqs(cfg: ModelConfig, device="cpu") -> torch.Tensor:
    """[D/2] f32 inverse frequencies: the default set, or Llama-3.1's
    NTK-by-parts remap. Computed on ``device`` (an upload from the host
    would wait for the card's queue)."""
    D = cfg.head_dim
    inv = 1.0 / (
        cfg.rope_theta
        ** (torch.arange(0, D, 2, dtype=torch.float32, device=device) / D)
    )
    if _rope_kind(cfg) == "llama3":
        scaling = cfg.rope_scaling
        factor = scaling.get("factor", 8.0)
        lo = scaling.get("low_freq_factor", 1.0)
        hi = scaling.get("high_freq_factor", 4.0)
        old_ctx = scaling.get("original_max_position_embeddings", 8192)
        wavelen = 2 * math.pi / inv
        ratio = old_ctx / wavelen
        smooth = ((ratio - lo) / (hi - lo)).clamp(0.0, 1.0)
        inv = torch.where(
            ratio < lo, inv / factor,
            torch.where(ratio > hi, inv,
                        (1 - smooth) * inv / factor + smooth * inv),
        )
    return inv


def rope_tables(positions: torch.Tensor, inv_freq: torch.Tensor,
                mscale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, signed sin) ``[..., T, 1, D]`` f32 for :func:`rotate`: computed
    once per forward, shared by every layer's q and k."""
    angles = positions[..., None].float() * inv_freq  # [..., T, D/2]
    cos = torch.cos(angles) * mscale
    sin = torch.sin(angles) * mscale
    return (torch.cat([cos, cos], -1)[..., None, :],
            torch.cat([-sin, sin], -1)[..., None, :])


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Half-split rope with precomputed tables: [x1, x2] -> [x1 cos - x2
    sin, x2 cos + x1 sin], bit-identical to :func:`apply_rope`."""
    cos, sin = tables
    xf = x.float()
    half = xf.shape[-1] // 2
    swapped = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + swapped * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, mscale: float = 1.0) -> torch.Tensor:
    """x: [..., T, Hx, D] rotated (half-split form) at absolute positions
    [..., T]."""
    return rotate(x, rope_tables(positions, inv_freq, mscale))


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _layer(params: dict, l: int) -> dict:
    """Layer l's leaves (views into the stacked tensors)."""
    return {k: v[l] for k, v in params["layers"].items()}


def _qkv(lp: dict, cfg: ModelConfig, x: torch.Tensor):
    D = cfg.head_dim
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    lead = x.shape[:-1]
    return (q.reshape(*lead, -1, D), k.reshape(*lead, -1, D),
            v.reshape(*lead, -1, D))


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _layer_tail(x, lp, o_flat, cfg: ModelConfig):
    x = x + o_flat @ lp["wo"]
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return (x @ head).float()


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


# ---------------- prefill (one sequence, chunked) ----------------


@torch.no_grad()
def prefill(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [T] padded chunk
    block_table: torch.Tensor,  # [M] int32, covers history + padded chunk
    history_len: int,  # tokens already cached
    valid_len: int,  # real tokens in this chunk
    k_cache: torch.Tensor,  # [L, Hkv, N, bs, D], written IN PLACE
    v_cache: torch.Tensor,
):
    """Process one (chunk of a) prompt; returns (last-real-token logits
    [V] f32, k_cache, v_cache). ``history_len`` cached tokens are attended
    but not recomputed (chunked prefill and prefix-cache hits)."""
    dev = tokens.device
    T = tokens.shape[0]
    history_len, valid_len = int(history_len), int(valid_len)
    x = _embed(params, cfg, tokens)  # [T, E]
    positions = torch.arange(T, device=dev) + history_len
    inv_freq = _rope_freqs(cfg, dev)
    scale = attn_query_scale(cfg)
    rope = rope_tables(positions, inv_freq)
    blk, off = att.chunk_slot_indices(block_table, history_len, T,
                                      k_cache.shape[3])
    hist, valid = _i32([history_len], dev), _i32([valid_len], dev)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h)
        q, k = rotate(q, rope), rotate(k, rope)
        att.write_slots(k_cache[l], k, blk, off)
        att.write_slots(v_cache[l], v, blk, off)
        o = att.chunk_attention_with_cache(
            q, k, v, k_cache[l], v_cache[l], block_table, hist, valid, scale,
        )
        x = _layer_tail(x, lp, o.reshape(T, -1), cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = min(max(valid_len - 1, 0), T - 1)
    return _logits(params, cfg, x[last]), k_cache, v_cache


# ---------------- merged decode ----------------


def _decode_body(params, cfg, tokens, positions, block_tables, seq_lens,
                 k_cache, v_cache):
    """One decode step for all sequences, the MERGED one-write path:
    attention handles the current token out of the cache (flash merge over
    the stats-emitting paged kernel), then ONE in-place append writes every
    layer's new K/V. Returns (logits [B, V] f32, k_cache, v_cache)."""
    x = _embed(params, cfg, tokens)  # [B, E]
    B = x.shape[0]
    inv_freq = _rope_freqs(cfg, x.device)
    scale = attn_query_scale(cfg)
    blk, off = att.decode_slot_indices(block_tables, positions, k_cache.shape[3])
    hist_lens = seq_lens - 1  # cache contents EXCLUDE the new token
    rope = rope_tables(positions, inv_freq)
    k_news, v_news = [], []
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h)  # [B, H, D], [B, Hkv, D]
        q, k = rotate(q, rope), rotate(k, rope)
        k_news.append(k)
        v_news.append(v)
        o = att.decode_attention_merged(
            q, k, v, k_cache[l], v_cache[l], block_tables, hist_lens, scale,
        )
        x = _layer_tail(x, lp, o.reshape(B, -1), cfg)
    kv_cache_append(
        torch.stack(k_news), torch.stack(v_news), k_cache, v_cache,
        blk.to(torch.int32), off.to(torch.int32),
    )
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, cfg, x), k_cache, v_cache


def _sample_step(logits, seeds, steps, temps, temps_host, top_ks, top_ps,
                 penalties, with_logprobs):
    """Penalties on the sampled distribution, raw logits for logprobs (the
    JAX decode_window body). ``penalties`` = (freq, pres, rep, counts,
    prompt_mask) or None; counts are bumped in place. ``temps_host`` is
    ``temps`` read once per dispatch, so an all-greedy step never waits
    for the card."""
    raw = logits
    if penalties is not None:
        freq, pres, rep, counts, mask = penalties
        logits = apply_penalties(logits, counts, mask, freq, pres, rep)
    keys = make_keys(seeds, steps, temps_host, logits.device)
    nxt = sample_tokens(logits, keys, temps, top_ks, top_ps)
    if penalties is not None:
        bump_counts(penalties[3], nxt)
    lps = token_logprobs(raw, nxt) if with_logprobs else None
    return nxt, lps


@torch.no_grad()
def decode_window(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B] last sampled token per sequence
    positions: torch.Tensor,  # [B]
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,  # [B] int32
    seeds,  # [B] int sampling seeds (host sequence or tensor)
    steps,  # [B] int per-request generation counters
    temps: torch.Tensor,  # [B] float32
    top_ks: torch.Tensor,  # [B] int32
    top_ps: torch.Tensor,  # [B] float32
    k_cache: torch.Tensor,  # updated IN PLACE
    v_cache: torch.Tensor,
    n_steps: int = 1,
    freq_pens: Optional[torch.Tensor] = None,
    pres_pens: Optional[torch.Tensor] = None,
    rep_pens: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None,  # [B, V] int32, bumped IN PLACE
    prompt_mask: Optional[torch.Tensor] = None,  # [B, V] bool
    with_logprobs: bool = False,
):
    """``n_steps`` decode+sample steps; the sampled token of step i feeds
    step i+1 on the device. Returns (tokens [n_steps, B] int32, k_cache,
    v_cache[, counts][, (chosen_lp, top_ids, top_lps) each [n_steps, ...]])
    — counts only with penalties. Callers pre-allocate KV blocks for
    ``n_steps`` new tokens per sequence."""
    penalties = (
        None if counts is None
        else (freq_pens, pres_pens, rep_pens, counts, prompt_mask)
    )
    seeds = [int(s) for s in seeds]
    steps = [int(s) for s in steps]
    temps_host = temps.tolist()
    toks, lps = [], []
    for i in range(n_steps):
        logits, k_cache, v_cache = _decode_body(
            params, cfg, tokens, positions, block_tables, seq_lens,
            k_cache, v_cache,
        )
        nxt, lp = _sample_step(
            logits, seeds, [s + i for s in steps], temps, temps_host, top_ks,
            top_ps, penalties, with_logprobs,
        )
        toks.append(nxt)
        lps.append(lp)
        tokens, positions, seq_lens = nxt, positions + 1, seq_lens + 1
    out = (torch.stack(toks), k_cache, v_cache)
    if penalties is not None:
        out += (counts,)
    if with_logprobs:
        out += (tuple(torch.stack(parts) for parts in zip(*lps)),)
    return out


# ---------------- fused mixed prefill+decode step ----------------


def _mixed_fused_forward(
    params, cfg, d_tokens, d_positions, d_tables, d_seq_lens,
    p_tokens, p_tables, p_hists, p_valids, k_cache, v_cache,
):
    """Embeddings and every projection/FFN/logits GEMM run over the combined
    [B + MP*T] row axis; attention is ONE ragged paged-attention call per
    layer covering the decode rows and every segment. Write-before-attend:
    each layer scatters the decode tokens' and the segments' K/V first
    (padded/dead segment rows land in trash page 0 through their zero
    table entries). Returns (decode_logits [B, V] f32, p_logits [MP, V]
    f32, k_cache, v_cache)."""
    B = d_tokens.shape[0]
    MP, T = p_tokens.shape
    bs = k_cache.shape[3]
    dev = d_tokens.device
    x = _embed(params, cfg, torch.cat([d_tokens, p_tokens.reshape(-1)]))
    p_positions = (p_hists.long()[:, None] + torch.arange(T, device=dev)).reshape(-1)
    positions_all = torch.cat([d_positions.long(), p_positions])
    inv_freq = _rope_freqs(cfg, dev)
    scale = attn_query_scale(cfg)
    d_blk, d_off = att.decode_slot_indices(d_tables, d_positions, bs)
    p_blk, p_off = att.chunk_slot_indices(p_tables, p_hists, T, bs)
    blk = torch.cat([d_blk.long(), p_blk.reshape(-1)])
    off = torch.cat([d_off.long(), p_off.reshape(-1)])
    rope = rope_tables(positions_all, inv_freq)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h)  # [B+MP*T, H/Hkv, D]
        q, k = rotate(q, rope), rotate(k, rope)
        att.write_slots(k_cache[l], k, blk, off)
        att.write_slots(v_cache[l], v, blk, off)
        o = ragged_mixed_attention_rows(
            q, k_cache[l], v_cache[l], d_tables, d_seq_lens, p_tables,
            p_hists, p_valids, scale, T,
        )
        x = _layer_tail(x, lp, o.reshape(o.shape[0], -1), cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits_d = _logits(params, cfg, x[:B])
    # each segment's last REAL row only
    last = B + torch.arange(MP, device=dev) * T + (p_valids.long() - 1).clamp(0, T - 1)
    p_logits = _logits(params, cfg, x[last])
    return logits_d, p_logits, k_cache, v_cache


@torch.no_grad()
def mixed_step(
    params: dict,
    cfg: ModelConfig,
    # decode side (same conventions as decode_window at n_steps=1)
    d_tokens: torch.Tensor,  # [B]
    d_positions: torch.Tensor,  # [B]
    d_tables: torch.Tensor,  # [B, M] int32
    d_seq_lens: torch.Tensor,  # [B] int32, including the new token
    seeds,
    steps,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
    # prefill side (stacked over MP in-flight prompts; dead pad segments
    # have valid 0 + zero tables, their logits row is never read)
    p_tokens: torch.Tensor,  # [MP, T]
    p_tables: torch.Tensor,  # [MP, M] int32
    p_hists: torch.Tensor,  # [MP] int32
    p_valids: torch.Tensor,  # [MP] int32
    k_cache: torch.Tensor,  # updated IN PLACE
    v_cache: torch.Tensor,
    freq_pens: Optional[torch.Tensor] = None,
    pres_pens: Optional[torch.Tensor] = None,
    rep_pens: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None,
    prompt_mask: Optional[torch.Tensor] = None,
    with_logprobs: bool = False,
):
    """ONE fused step: MP prefill chunks plus a decode token for every
    active sequence. Returns (next_tokens [B], p_logits [MP, V] f32,
    k_cache, v_cache[, counts][, (chosen_lp, top_ids, top_lps)])."""
    logits_d, p_logits, k_cache, v_cache = _mixed_fused_forward(
        params, cfg, d_tokens, d_positions, d_tables, d_seq_lens,
        p_tokens, p_tables, p_hists, p_valids, k_cache, v_cache,
    )
    penalties = (
        None if counts is None
        else (freq_pens, pres_pens, rep_pens, counts, prompt_mask)
    )
    nxt, lps = _sample_step(
        logits_d, [int(s) for s in seeds], [int(s) for s in steps], temps,
        temps.tolist(), top_ks, top_ps, penalties, with_logprobs,
    )
    out = (nxt, p_logits, k_cache, v_cache)
    if penalties is not None:
        out += (counts,)
    if with_logprobs:
        out += (lps,)
    return out
