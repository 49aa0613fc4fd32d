"""Multi-Latent Attention (DeepSeek-V2/V3) over the paged latent cache.

Counterpart of ``dynamo_tpu/models/mla.py``. Per token the cache stores the
``kv_lora_rank`` latent ``c_kv`` (k-cache slot) and the head-shared rotated
``k_pe`` (v-cache slot): two single-"head" paged arrays ``[L, 1, N, bs, C]``
and ``[L, 1, N, bs, R]`` that ride the block tables and allocator
unchanged. Attention runs ABSORBED: ``q_nope`` folds through the kv_b
up-projection (``q_eff = q_nope @ w_kc``), scores are
``q_eff . c_kv + q_pe . k_pe`` against the raw latents, the values ARE the
latents, and the output latent folds back through ``w_vc``.

The attention itself is ``ops/mla_attention.py`` (CUDA kernels on the card,
plain PyTorch on the CPU); the dense ``*_xla`` functions here keep the JAX
names of the gather paths they mirror and are the oracles of the tests.
RoPE is DeepSeek's YaRN over the rope dims, with the mscale cos/sin
correction; the softmax scale's mscale_all_dim correction is
``ModelConfig.mla_softmax_scale``.
"""

from __future__ import annotations

import math

import torch

from ..ops.mla_attention import gather_latents
from .config import ModelConfig, is_yarn, yarn_mscale

NEG_INF = -1e30
MLA_INT8_NATIVE = (
    "MLA with quantization='int8_native' is not supported: the absorbed "
    "fold dequantizes wkv_b, which int8_native stores in its 'qn' form "
    "(the JAX package fails on this pair too); use 'int8' or 'fp8_e4m3'"
)


def mla_rope_freqs(cfg: ModelConfig, device="cpu") -> tuple[torch.Tensor, float]:
    """(inv_freq [R/2] f32, cos/sin mscale ratio). YaRN per DeepSeek-V2:
    low-frequency dims interpolate by ``factor``, high-frequency dims
    extrapolate, with a linear ramp across the correction range derived
    from beta_fast / beta_slow. Computed on ``device``."""
    D = cfg.qk_rope_head_dim
    base = cfg.rope_theta
    inv = 1.0 / (
        base ** (torch.arange(0, D, 2, dtype=torch.float32, device=device) / D)
    )
    rs = cfg.rope_scaling or {}
    if not is_yarn(rs):
        return inv, 1.0
    factor = rs.get("factor", 1.0)
    beta_fast = rs.get("beta_fast", 32)
    beta_slow = rs.get("beta_slow", 1)
    orig = rs.get("original_max_position_embeddings", 4096)

    def corr_dim(n_rot):
        return (D * math.log(orig / (n_rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), D - 1)
    ramp = ((torch.arange(D // 2, dtype=torch.float32, device=device) - low)
            / max(high - low, 0.001)).clamp(0.0, 1.0)
    extrap_mask = 1.0 - ramp
    inv = (inv / factor) * (1 - extrap_mask) + inv * extrap_mask
    msc = yarn_mscale(factor, rs.get("mscale", 1.0)) / yarn_mscale(
        factor, rs.get("mscale_all_dim", 0.0) or 0.0
    )
    return inv, msc


def rope_rotate(x: torch.Tensor, positions: torch.Tensor,
                inv_freq: torch.Tensor, mscale: float = 1.0) -> torch.Tensor:
    """Half-split rotation over the trailing rope dims; x ``[..., T, Hx,
    Dr]``, positions ``[..., T]`` (same rule as llama.apply_rope)."""
    from .llama import rope_tables, rotate

    return rotate(x, rope_tables(positions, inv_freq, mscale))


def _wkv_b_parts(lp: dict, cfg: ModelConfig):
    """Split the kv_b up-projection ``[C, H*(nope+v)]`` into
    ``w_kc [C, H, nope]`` and ``w_vc [C, H, v]``. A quantized ``wkv_b``
    dequantizes for the absorbed fold in bf16 whatever the model dtype, as
    in the JAX package; its ``int8_native`` form is refused (the JAX
    package reads ``w["q"]`` there and fails)."""
    H, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    w = lp["wkv_b"]
    if isinstance(w, dict):
        if "qn" in w:
            raise ValueError(MLA_INT8_NATIVE)
        w = w["q"].to(torch.bfloat16) * w["s"].to(torch.bfloat16)
    w = w.reshape(w.shape[0], H, dn + dv)
    return w[:, :, :dn], w[:, :, dn:]


def mla_q_and_latent(lp: dict, cfg: ModelConfig, x: torch.Tensor, rope):
    """The projection head shared by prefill and decode. ``x [..., E]``;
    ``rope`` the (cos, sin) tables of ``llama.rope_tables`` at the rows'
    positions with the YaRN mscale (``[..., 1, R]``: broadcast over heads).

    Returns (q_eff ``[..., H, C]``, q_pe ``[..., H, R]``, c_kv ``[..., C]``,
    k_pe ``[..., R]``); q_eff is the ABSORBED query (q_nope @ w_kc, f32
    product) scoring directly against cache latents."""
    from .llama import _mm, rms_norm, rotate

    H = cfg.num_heads
    dn = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        q = _mm(rms_norm(_mm(x, lp["wq_a"]), lp["q_norm"], cfg.rms_norm_eps),
                lp["wq_b"])
    else:
        q = _mm(x, lp["wq"])
    q = q.reshape(*x.shape[:-1], H, -1)
    q_nope, q_pe = q[..., :dn], rotate(q[..., dn:], rope)
    kv = _mm(x, lp["wkv_a"])  # [..., C + R]
    C = cfg.kv_lora_rank
    c_kv = rms_norm(kv[..., :C], lp["kv_norm"], cfg.rms_norm_eps)
    k_pe = rotate(kv[..., None, C:], rope)[..., 0, :]
    w_kc, _ = _wkv_b_parts(lp, cfg)
    q_eff = torch.einsum("...hd,chd->...hc", q_nope.float(), w_kc.float())
    return q_eff.to(x.dtype), q_pe, c_kv, k_pe


def _o_proj(lp: dict, cfg: ModelConfig, out_lat: torch.Tensor) -> torch.Tensor:
    """Fold the attention's latent output back through w_vc and flatten
    heads: ``[.., H, C]`` f32 -> ``[.., H*v_head_dim]`` f32."""
    _, w_vc = _wkv_b_parts(lp, cfg)
    o = torch.einsum("...hc,chd->...hd", out_lat.float(), w_vc.float())
    return o.reshape(*o.shape[:-2], -1)


def mla_prefill_attention_xla(
    q_eff: torch.Tensor,  # [T, H, C]
    q_pe: torch.Tensor,  # [T, H, R]
    c_cache_layer: torch.Tensor,  # [1, N, bs, C] — chunk ALREADY written
    pe_cache_layer: torch.Tensor,  # [1, N, bs, R]
    block_table: torch.Tensor,  # [M]
    history_len,
    valid_len,
    scale: float,
) -> torch.Tensor:  # [T, H, C] f32 latent output
    """Write-before-attend chunked prefill over latents: every query row
    attends cached history plus the causal prefix of its chunk, all read
    back through the block table (dense gather, f32 softmax)."""
    T = q_eff.shape[0]
    dev = q_eff.device
    ck = gather_latents(c_cache_layer, block_table).float()  # [S, C]
    kp = gather_latents(pe_cache_layer, block_table).float()
    s = (torch.einsum("thc,sc->ths", q_eff.float() * scale, ck)
         + torch.einsum("thr,sr->ths", q_pe.float() * scale, kp))
    hist = torch.as_tensor(history_len, device=dev).reshape(())
    valid = torch.as_tensor(valid_len, device=dev).reshape(())
    q_pos = hist + torch.arange(T, device=dev)
    s_pos = torch.arange(ck.shape[0], device=dev)
    ok = (s_pos[None, :] <= q_pos[:, None]) & (s_pos[None, :] < hist + valid)
    s = s.masked_fill(~ok[:, None, :], NEG_INF)
    return torch.einsum("ths,sc->thc", torch.softmax(s, dim=-1), ck)


def mla_decode_attention_xla(
    q_eff: torch.Tensor,  # [B, H, C]
    q_pe: torch.Tensor,  # [B, H, R]
    c_cache_layer: torch.Tensor,  # [1, N, bs, C] — current token written
    pe_cache_layer: torch.Tensor,  # [1, N, bs, R]
    block_tables: torch.Tensor,  # [B, M]
    seq_lens: torch.Tensor,  # [B] incl. the current token
    scale: float,
) -> torch.Tensor:  # [B, H, C] f32 latent output
    ck = gather_latents(c_cache_layer, block_tables).float()  # [B, S, C]
    kp = gather_latents(pe_cache_layer, block_tables).float()
    s = (torch.einsum("bhc,bsc->bhs", q_eff.float() * scale, ck)
         + torch.einsum("bhr,bsr->bhs", q_pe.float() * scale, kp))
    mask = torch.arange(ck.shape[1], device=q_eff.device)[None, :] < seq_lens[:, None]
    s = s.masked_fill(~mask[:, None, :], NEG_INF)
    return torch.einsum("bhs,bsc->bhc", torch.softmax(s, dim=-1), ck)
