"""Llama-family decoder over a paged KV cache (PyTorch), dense GQA or
DeepSeek MLA, with dense or MoE FFNs.

Counterpart of ``dynamo_tpu/models/llama.py`` for the main serving path:
chunked prefill into the paged cache (:func:`prefill`), merged decode
windows (:func:`decode_window`), the fused mixed prefill+decode step
(:func:`mixed_step`), and the speculative verify (:func:`verify_window`). Public functions keep the JAX signatures, with the
JAX-only knobs (``use_pallas``, ``mesh``, ``interpret``...) dropped: each
op dispatches on its tensors' device (CUDA kernel on the card, plain
PyTorch on the CPU).

Parameters are a plain dictionary of tensors with the JAX package's tree
and layout: layers stacked on a leading axis, projection weights
``[in, out]`` (``x @ w``); DeepSeek's ``first_k_dense_replace`` makes two
layer groups (``dense_layers`` then ``layers``, :func:`layer_groups`). The
caches are updated IN PLACE (the JAX functions donate them and return new
arrays; these functions return the same tensors so call sites read alike):
``[L, Hkv, N, bs, D]`` each for GQA, and for MLA the latent ``c_kv`` ``[L,
1, N, bs, C]`` in the k slot and the rotated ``k_pe`` ``[L, 1, N, bs, R]``
in the v slot (models/mla.py). PyTorch runs eagerly, so the layer loops
are plain Python loops.

Covered: the Llama / Llama-3 / Mistral shape (RMS norms, half-split rope
with default, ``linear``, ``llama3`` or ``yarn`` scaling, SwiGLU, optional
tied embeddings), Qwen2's q/k/v biases and Qwen3's per-head q/k RMS norms,
sliding windows (global, or per layer as gpt-oss and Gemma-3 alternate
them), Gemma-3 (sandwich norms around both sublayers, GeGLU, embeddings
scaled by sqrt(E), a query scale from ``query_pre_attn_scalar``, and a
second, local rope on the windowed layers; its ``(1 + w)`` norms are
folded into the weights at load, models/weights.py), gpt-oss
(attention sinks, the o_proj bias, the router's logit bias and the biased
clamped-SwiGLU experts), DeepSeek-V2/V3 Multi-Latent Attention (absorbed,
with or without q-lora, YaRN rope) and Mixtral/Qwen-MoE/DeepSeek MoE FFNs
(softmax or sigmoid scoring, gate bias, group-limited routing, shared
experts, Qwen2-MoE's gated shared expert). Everything else raises in
:func:`check_supported`.
:func:`dense_forward` is the cache-free full-attention forward, the
checkpoint tests' and the card's oracle.

Quantized serving (models/quant.py): projection weights may be ``{"q",
"s"}`` / ``{"qn", "s"}`` nodes (:func:`_mm`) and expert stacks ``{"q",
"s"}`` nodes (:func:`_ragged_mm`, the ``ragged_int8_gmm`` kernel). With the
int8-with-scales KV cache (GQA only), :func:`prefill`,
:func:`decode_window` and :func:`mixed_step` take the ``[L, N]`` f32 scale
planes ``k_scales`` / ``v_scales``, update them IN PLACE like the caches,
and return them (and the device int32 count of scale entries that grew,
``n_requants``) right after the caches, as the JAX functions do. Over the
scale-free fp8 cache (``float8_e4m3fn`` caches, GQA and MLA) every function
takes no planes: the writes cast with ``models/quant.to_e4m3`` (plain
PyTorch for a prefill chunk or a fused step's rows, the row-store kernel for
the merged decode's and the verify's appends) and the kernels widen the
pages as they read them; nothing else widens them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops import attention as att
from ..ops.kv_cache_update import (
    append_quantized_rows,
    kv_cache_append,
    kv_cache_append_tokens,
)
from ..ops.mla_attention import (
    mla_decode_attention_merged,
    mla_paged_prefill_attention,
    mla_verify_attention,
)
from ..ops.moe_gmm import ragged_int8_gmm
from ..ops.ragged_paged_attention import ragged_mixed_attention_rows
from ..ops.sampling import (
    apply_penalties,
    bump_counts,
    make_keys,
    sample_tokens,
    speculative_accept,
    token_logprobs,
)
from . import mla
from .config import ModelConfig, yarn_mscale

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[str(cfg.dtype)]


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense GQA decoders (q/k/v biases, per-head q/k
    norms, sliding windows global or per layer, gpt-oss's sinks, o_proj
    bias and biased clamped-SwiGLU experts, Gemma-3's sandwich norms,
    GeGLU, scaled embeddings, query scale and local rope) and the DeepSeek
    MLA + MoE family; other families raise (Gemma-2's softcap, OLMo-2's
    full-width q/k norm and norms after the sublayers only, partial
    rotary, ``longrope``)."""
    unsupported = {
        "full-width qk norm": cfg.qk_norm_full,
        "sliding window or sinks on MLA": cfg.is_mla and bool(
            cfg.layer_windows or cfg.sliding_window or cfg.attn_sinks),
        "softcap": cfg.attn_softcap or cfg.final_softcap,
        "norms after the sublayers only": cfg.norm_after,
        "local rope on MLA": cfg.is_mla and bool(cfg.rope_local_theta),
        "activation " + cfg.hidden_act: (
            cfg.hidden_act not in ("silu", "gelu_tanh")),
        "partial rotary": bool(cfg.rope_partial_dim),
        "expert activation " + cfg.moe_act: (
            cfg.moe_act not in ("swiglu", "gptoss_clamp")),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"dynamo_tpu_torch serves dense GQA and DeepSeek MLA/MoE "
            f"decoders; not ported yet: {', '.join(bad)}"
        )
    if not cfg.is_mla:  # MLA ropes with its own YaRN (models/mla.py)
        _rope_kind(cfg)


# ---------------- parameters / cache ----------------


def _init_layer_group(cfg: ModelConfig, L: int, moe: bool, normal, ones) -> dict:
    """Stacked ``[L, ...]`` leaves of one homogeneous layer group (attention
    plus one FFN kind), the JAX package's tree."""
    E, H, Hkv, D, F_ = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.intermediate_size)
    layers = {"attn_norm": ones(L, E), "mlp_norm": ones(L, E)}
    if cfg.post_norms:  # gemma: the sublayers' outputs normed too
        layers.update(attn_post_norm=ones(L, E), mlp_post_norm=ones(L, E))
    if cfg.is_mla:
        Cq, C = cfg.q_lora_rank, cfg.kv_lora_rank
        dqk, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        if Cq:
            layers["wq_a"] = normal(L, E, Cq)
            layers["q_norm"] = ones(L, Cq)
            layers["wq_b"] = normal(L, Cq, H * (dqk + dr))
        else:
            layers["wq"] = normal(L, E, H * (dqk + dr))
        layers["wkv_a"] = normal(L, E, C + dr)
        layers["kv_norm"] = ones(L, C)
        layers["wkv_b"] = normal(L, C, H * (dqk + dv))
        layers["wo"] = normal(L, H * dv, E)
    else:
        layers.update(wq=normal(L, E, H * D), wk=normal(L, E, Hkv * D),
                      wv=normal(L, E, Hkv * D), wo=normal(L, H * D, E))
        if cfg.attention_bias:  # qwen2: zeros, as in JAX
            layers.update(bq=ones(L, H * D).zero_(), bk=ones(L, Hkv * D).zero_(),
                          bv=ones(L, Hkv * D).zero_())
        if cfg.qk_norm:  # qwen3: per-head weight [D]
            layers.update(q_norm=ones(L, D), k_norm=ones(L, D))
        if cfg.attn_sinks:  # gpt-oss: per-head sink logits, f32
            layers["sinks"] = normal(L, H, std=0.5).float()
        if cfg.o_bias:
            layers["bo"] = ones(L, E).zero_()
    if moe:
        X = cfg.num_experts
        Fm = cfg.moe_intermediate_size or F_
        layers["moe_gate"] = normal(L, E, X)
        if cfg.moe_gate_bias:
            layers["moe_gate_bias"] = ones(L, X).float().zero_()  # f32, as in JAX
        layers.update(we_gate=normal(L, X, E, Fm), we_up=normal(L, X, E, Fm),
                      we_down=normal(L, X, Fm, E))
        if cfg.moe_act == "gptoss_clamp":  # the router's logit bias (f32)
            # and per-expert projection biases, as in JAX
            layers["moe_router_bias"] = ones(L, X).float().zero_()
            layers.update(be_gate=normal(L, X, Fm, std=0.05),
                          be_up=normal(L, X, Fm, std=0.05),
                          be_down=normal(L, X, E, std=0.05))
        if cfg.num_shared_experts:
            Fs = cfg.shared_expert_size or Fm * cfg.num_shared_experts
            layers.update(shared_gate=normal(L, E, Fs),
                          shared_up=normal(L, E, Fs),
                          shared_down=normal(L, Fs, E))
            if cfg.shared_expert_gate:  # qwen2moe sigmoid gate [E, 1]
                layers["shared_egate"] = normal(L, E, 1)
    else:
        layers.update(w_gate=normal(L, E, F_), w_up=normal(L, E, F_),
                      w_down=normal(L, F_, E))
    return layers


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cpu") -> dict:
    """Random params drawn on ``device`` (normal x 0.02, norms at 1) in the
    JAX package's tree (tests/benches; real weights come from
    models/weights.py)."""
    check_supported(cfg)
    dt = _dtype(cfg)
    E, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers

    def normal(*shape, std=0.02):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, std, generator=generator
        )

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    kd = cfg.first_dense_layers if cfg.is_moe else 0
    params = {
        "embed": normal(V, E),
        "final_norm": ones(E),
        "layers": _init_layer_group(cfg, L - kd, cfg.is_moe, normal, ones),
    }
    if kd:
        params["dense_layers"] = _init_layer_group(cfg, kd, False, normal, ones)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal(E, V)
    return params


def layer_groups(params: dict, cfg: ModelConfig):
    """[(stacked layer params, n_layers, layer offset)] in forward order:
    one group for homogeneous models, (dense, moe) for DeepSeek-style
    first_k_dense_replace models."""
    k = cfg.first_dense_layers if "dense_layers" in params else 0
    out = []
    if k:
        out.append((params["dense_layers"], k, 0))
    out.append((params["layers"], cfg.num_layers - k, k))
    return out


def _layer_slice(v, i: int):
    """Layer ``i`` of a stacked leaf, or of each tensor of a quantized
    ``{"q"/"qn", "s"}`` node."""
    if isinstance(v, dict):
        return {k: t[i] for k, t in v.items()}
    return v[i]


def _layers(params: dict, cfg: ModelConfig):
    """(layer index, layer leaves as views into the stacked tensors) for
    every layer in forward order."""
    for group, n, goff in layer_groups(params, cfg):
        for i in range(n):
            yield goff + i, {k: _layer_slice(v, i) for k, v in group.items()}


def kv_cache_shapes(cfg: ModelConfig, num_blocks: int,
                    block_size: int) -> tuple[tuple, tuple]:
    """(k_shape, v_shape): ``[L, Hkv, num_blocks, block_size, D]`` each, or
    for MLA the latent ``[L, 1, N, bs, kv_lora_rank]`` and the rope key
    ``[L, 1, N, bs, qk_rope_head_dim]``."""
    L = cfg.num_layers
    if cfg.is_mla:
        return ((L, 1, num_blocks, block_size, cfg.kv_lora_rank),
                (L, 1, num_blocks, block_size, cfg.qk_rope_head_dim))
    s = (L, cfg.num_kv_heads, num_blocks, block_size, cfg.head_dim)
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


def window_for_layer(cfg: ModelConfig, l: int) -> int:
    """Layer l's sliding-window width (0 = full): gpt-oss alternates
    sliding and full layers (``cfg.layer_windows``); every other family is
    homogeneous (``cfg.sliding_window``)."""
    return cfg.layer_windows[l] if cfg.layer_windows else cfg.sliding_window


def _rope_kind(cfg: ModelConfig) -> Optional[str]:
    scaling = cfg.rope_scaling or {}
    kind = scaling.get("rope_type") or scaling.get("type")
    if kind not in (None, "default", "linear", "llama3", "yarn"):
        raise NotImplementedError(
            f"rope scaling {kind!r} is not ported yet (default, linear, "
            "llama3 and yarn are)"
        )
    return kind


def rope_attention_scaling(cfg: ModelConfig) -> float:
    """YaRN's cos/sin attention factor (transformers'
    ``_compute_yarn_parameters``): ``attention_factor`` where given, the
    ratio of DeepSeek's mscales where both are, else 0.1 ln(factor) + 1;
    1.0 for every other rope."""
    scaling = cfg.rope_scaling or {}
    if _rope_kind(cfg) != "yarn":
        return 1.0
    factor = scaling.get("factor", 1.0)
    af = scaling.get("attention_factor")
    if af is not None:
        return float(af)
    msc, mad = scaling.get("mscale"), scaling.get("mscale_all_dim")
    if msc and mad:
        return float(yarn_mscale(factor, msc) / yarn_mscale(factor, mad))
    if factor <= 1.0:
        return 1.0
    return 0.1 * math.log(factor) + 1.0


def _rope_freqs(cfg: ModelConfig, device="cpu") -> torch.Tensor:
    """[D/2] f32 inverse frequencies: the default set, divided by
    ``factor`` (``linear``: position interpolation, Gemma-3's full layers),
    Llama-3.1's NTK-by-parts remap, or YaRN's (the low-frequency dims
    interpolated by ``factor``, the high ones extrapolated, a linear ramp
    across the correction range, kept fractional where ``truncate`` is
    False, as gpt-oss ships it). Computed on ``device`` (an upload from the host
    would wait for the card's queue)."""
    D = cfg.head_dim
    inv = 1.0 / (
        cfg.rope_theta
        ** (torch.arange(0, D, 2, dtype=torch.float32, device=device) / D)
    )
    kind = _rope_kind(cfg)
    if kind == "yarn":
        scaling = cfg.rope_scaling
        factor = scaling.get("factor", 1.0)
        beta_fast = scaling.get("beta_fast") or 32
        beta_slow = scaling.get("beta_slow") or 1
        orig = (scaling.get("original_max_position_embeddings")
                or cfg.max_position_embeddings)

        def corr_dim(n_rot):
            return (D * math.log(orig / (n_rot * 2 * math.pi))) / (
                2 * math.log(cfg.rope_theta))

        low, high = corr_dim(beta_fast), corr_dim(beta_slow)
        if scaling.get("truncate", True):
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, D - 1)
        ramp = ((torch.arange(D // 2, dtype=torch.float32, device=device) - low)
                / max(high - low, 0.001)).clamp(0.0, 1.0)
        extrap = 1.0 - ramp
        return (inv / factor) * (1 - extrap) + inv * extrap
    if kind == "linear":
        return inv / cfg.rope_scaling.get("factor", 1.0)
    if kind == "llama3":
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


def _rope_freqs_local(cfg: ModelConfig, device="cpu") -> Optional[torch.Tensor]:
    """Gemma-3's local rope: the windowed layers rotate at
    ``rope_local_base_freq`` with no scaling; None for a model with one
    rope."""
    if not cfg.rope_local_theta:
        return None
    D = cfg.head_dim
    return 1.0 / (cfg.rope_local_theta ** (
        torch.arange(0, D, 2, dtype=torch.float32, device=device) / D))


def rope_freqs_for_layer(cfg: ModelConfig, l: int, inv_global, inv_local):
    """Layer l's rope (frequencies, or their tables): the local one on a
    windowed layer of a model that has one (Gemma-3), the global one
    elsewhere."""
    if inv_local is None:
        return inv_global
    return inv_local if window_for_layer(cfg, l) > 0 else inv_global


def _rope_pair(cfg: ModelConfig, positions: torch.Tensor, inv_freq,
               msc: float):
    """(global, local or None) rope tables of a forward's positions, each
    computed once and shared by the layers that use it."""
    inv_local = _rope_freqs_local(cfg, positions.device)
    return (rope_tables(positions, inv_freq, msc),
            None if inv_local is None else rope_tables(positions, inv_local, msc))


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


def _rope_and_scale(cfg: ModelConfig, device):
    """(inverse frequencies, cos/sin attention factor, softmax scale) of a
    forward: MLA's own YaRN, or the GQA rope."""
    if cfg.is_mla:
        inv_freq, msc = mla.mla_rope_freqs(cfg, device)
        return inv_freq, msc, cfg.mla_softmax_scale()
    return (_rope_freqs(cfg, device), rope_attention_scaling(cfg),
            attn_query_scale(cfg))


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows; gemma scales them by sqrt(E) in f32, then casts
    (the table stays unscaled: it is tied to the head)."""
    x = params["embed"][tokens.long()]
    if cfg.scale_embed:
        x = (x.float() * (cfg.hidden_size ** 0.5)).to(x.dtype)
    return x


def _int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product of ``[..., K]`` by ``[K, N]``. On
    the card ``torch._int_mm`` (more than 16 rows, K and N multiples of 8:
    the rows pad and the result is sliced; the weight comes column-major,
    as ``quant.native_layout`` stores it); on the CPU an int32 product."""
    lead, K = xq.shape[:-1], xq.shape[-1]
    x2 = xq.reshape(-1, K)
    if x2.device.type == "cuda":
        R = x2.shape[0]
        if K % 8 or wq.shape[1] % 8:
            raise ValueError(f"int8_native: K={K} and N={wq.shape[1]} must be "
                             "multiples of 8 on the card")
        if R <= 16:
            x2 = torch.cat([x2, x2.new_zeros(17 - R, K)])
        assert wq.stride(0) == 1, "int8_native codes must be column-major"
        acc = torch._int_mm(x2, wq)[:R]
    else:
        acc = x2.to(torch.int32) @ wq.to(torch.int32)
    return acc.reshape(*lead, -1)


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul against a plain or quantized weight. ``{"q": int8|fp8, "s":
    f32}`` dequantizes the codes to ``x``'s dtype and scales the product's
    columns (``(x @ q) * s``, the reference's order; plain PyTorch, as it is
    XLA in the JAX package). ``{"qn": int8, "s"}`` (int8_native) quantizes
    the activations per row (absmax / 127, floor 1e-12, round, clip), takes
    an exact int8 x int8 -> int32 product and applies both scales in f32."""
    if isinstance(w, dict):
        if "qn" in w:
            xf = x.float()
            # times the f32 reciprocal of 127: the jitted reference's
            # arithmetic for its division by the constant, bit for bit
            s_x = torch.clamp_min(xf.abs().amax(-1, keepdim=True) * (1.0 / 127.0),
                                  1e-12)
            xq = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
            out = _int_mm(xq, w["qn"]).float() * s_x * w["s"]
            return out.to(x.dtype)
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def _qkv(lp: dict, cfg: ModelConfig, x: torch.Tensor):
    """q ``[..., H, D]``, k and v ``[..., Hkv, D]``: the three products,
    Qwen2's biases on the flat projections, then Qwen3's per-head RMS norm
    (before rope), in the JAX package's order and casts."""
    D = cfg.head_dim
    q = _mm(x, lp["wq"])
    k = _mm(x, lp["wk"])
    v = _mm(x, lp["wv"])
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    lead = x.shape[:-1]
    q, k, v = (q.reshape(*lead, -1, D), k.reshape(*lead, -1, D),
               v.reshape(*lead, -1, D))
    if cfg.qk_norm and not cfg.qk_norm_full:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    return q, k, v


def swiglu(x, w_gate, w_up, w_down, act: str = "silu"):
    """The gated FFN: SwiGLU, or gemma's GeGLU (``gelu_tanh``: the tanh
    approximation of GELU on the gate)."""
    gate = _mm(x, w_gate)
    gate = F.gelu(gate, approximate="tanh") if act == "gelu_tanh" else F.silu(gate)
    return _mm(gate * _mm(x, w_up), w_down)


# ---------------- mixture of experts ----------------


def _route_topk(lp: dict, cfg: ModelConfig, x: torch.Tensor):
    """(combine weights [T, k] f32, expert indices [T, k]): Mixtral/Qwen
    softmax routing and the DeepSeek variants — V2 softmax, V3 sigmoid
    scoring with the no-aux-loss gate bias (the bias picks the experts, the
    UNBIASED score is the combine weight), group-limited top-k (score the
    n_group blocks by their max, or V3's top-2 sum, and route only within
    the best topk_group blocks) — with routed_scaling_factor applied."""
    k, X = cfg.num_experts_per_tok, cfg.num_experts
    gate_logits = x.float() @ lp["moe_gate"].float()
    if lp.get("moe_router_bias") is not None:
        # gpt-oss: a LOGIT bias (before scoring: it moves the selection AND
        # the combine weights), unlike V3's moe_gate_bias below
        gate_logits = gate_logits + lp["moe_router_bias"].float()
    if cfg.moe_scoring == "sigmoid":
        scores = torch.sigmoid(gate_logits)
    else:
        scores = torch.softmax(gate_logits, dim=-1)  # [T, X]
    sel = scores
    if lp.get("moe_gate_bias") is not None:
        sel = scores + lp["moe_gate_bias"].float()
    if cfg.n_group > 1 and cfg.topk_group:
        T = sel.shape[0]
        g = sel.reshape(T, cfg.n_group, X // cfg.n_group)
        if cfg.moe_group_score == "top2":  # V3 noaux_tc
            g_score = torch.topk(g, 2, dim=-1).values.sum(-1)  # [T, n_group]
        else:  # V2 group_limited_greedy: the group's max score
            g_score = g.amax(-1)
        g_idx = torch.topk(g_score, cfg.topk_group, dim=-1).indices
        g_mask = torch.zeros(T, cfg.n_group, dtype=torch.bool, device=x.device)
        g_mask.scatter_(1, g_idx, True)
        # masked groups score 0.0, not -inf (the HF routers' rule)
        sel = torch.where(
            g_mask.repeat_interleave(X // cfg.n_group, dim=1), sel, 0.0
        )
    idx = torch.topk(sel, k, dim=-1).indices  # selection: (biased) score
    vals = torch.gather(scores, 1, idx)  # combine: raw score
    if cfg.norm_topk_prob:
        vals = vals / (vals.sum(-1, keepdim=True) + 1e-20)
    return vals * cfg.routed_scaling_factor, idx


def _moe_route(lp: dict, cfg: ModelConfig, x: torch.Tensor):
    """Top-k routing + expert-sorted dispatch order. Returns (t_sorted,
    w_sorted, e_sorted, group_sizes): token row per assignment in expert
    order (stable within an expert), its combine weight, its expert (for
    gpt-oss's expert biases), and per-expert assignment counts."""
    k = cfg.num_experts_per_tok
    vals, idx = _route_topk(lp, cfg, x)
    e_flat = idx.reshape(-1)  # assignment r -> token r // k
    order = torch.argsort(e_flat, stable=True)
    # a scatter, not bincount: on the card bincount reads its max on the host
    group_sizes = torch.zeros(cfg.num_experts, dtype=torch.int64,
                              device=x.device).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    return order // k, vals.reshape(-1)[order], e_flat[order], group_sizes


def _expert_act(cfg: ModelConfig, g: torch.Tensor, u: torch.Tensor):
    """Expert gating nonlinearity: SwiGLU, or gpt-oss's clamped GLU (the
    gate clamped at 7, the linear stream to [-7, 7], ``(u + 1) g
    sigmoid(1.702 g)``)."""
    if cfg.moe_act == "gptoss_clamp":
        g = g.clamp(max=7.0)
        u = u.clamp(-7.0, 7.0)
        return (u + 1.0) * (g * torch.sigmoid(1.702 * g))
    return F.silu(g) * u


#: the most bytes of expert matrices one batched product of
#: :func:`_ragged_mm`'s f32 path gathers
_F32_GATHER_BYTES = 1 << 28


def _ragged_mm(xs: torch.Tensor, w, group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped matmul over expert-sorted rows: rows of group e (``group_sizes
    [X]`` consecutive) times ``w[e]`` (``[X, in, out]``), the twin of
    ``lax.ragged_dot``; rows past the groups come out zero. On the card
    one ``torch._grouped_mm`` call for bf16 rows (offsets from a device
    cumsum, no host sync); f32 rows take each row's expert matrix in
    batched products, since ``_grouped_mm``'s f32 path reads the offsets
    on the host, which a captured decode step cannot: the rows go in
    chunks whose gathered matrices stay within ``_F32_GATHER_BYTES``, so
    the memory does not grow with the rows. On the CPU a loop over the
    groups. A quantized stack (``{"q", "s"}``) goes through
    ``ragged_int8_gmm`` (the CUDA kernel on the card, its plain twin on
    the CPU)."""
    if isinstance(w, dict):
        return ragged_int8_gmm(xs, w["q"], w["s"], group_sizes).to(xs.dtype)
    if xs.device.type == "cuda":
        offs = torch.cumsum(group_sizes, 0)
        if xs.dtype == torch.bfloat16:
            return torch._grouped_mm(xs, w, offs=offs.to(torch.int32))
        X, E = xs.shape[0], w.shape[0]
        e = torch.searchsorted(offs, torch.arange(X, device=xs.device),
                               right=True)  # E past the groups
        live = (e < E)[:, None]
        e = e.clamp(max=E - 1)
        step = max(1, _F32_GATHER_BYTES // (w[0].numel() * w.element_size()))
        out = xs.new_empty(X, w.shape[-1])
        for r in range(0, X, step):
            out[r:r + step] = torch.bmm(xs[r:r + step, None], w[e[r:r + step]])[:, 0]
        return out * live
    out = xs.new_zeros(xs.shape[0], w.shape[-1])
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            out[start:start + n] = xs[start:start + n] @ w[e]
        start += n
    return out


def _moe_combine(o, t_sorted, w_sorted, T: int, dtype):
    """Add the weighted expert outputs back to their token rows, each
    token's k rows in the order the reference's ``.at[t_sorted].add`` meets
    them (the expert-sorted order), one add at a time in ``dtype``. A
    stable sort of ``t_sorted`` lists every token's rows in that order; a
    gather and k - 1 adds follow. One path on the CPU and the card, no
    atomics: the same bits on every run (``index_add_`` on the card adds
    in no fixed order)."""
    k = t_sorted.numel() // max(T, 1)
    if k == 0:
        return torch.zeros(T, o.shape[-1], dtype=dtype, device=o.device)
    rows = torch.argsort(t_sorted, stable=True).reshape(T, k)
    weighted = (o * w_sorted[:, None].to(dtype))[rows]  # [T, k, D]
    out = weighted[:, 0]
    for j in range(1, k):
        out = out + weighted[:, j]
    return out


def moe_ffn(lp: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Sparse MoE FFN with RAGGED dispatch: tokens sorted by assigned
    expert, each expert contracts only its own row group (per-token FLOPs
    scale with top-k, not the expert count). Exact: no capacity factor, no
    token dropping. Shared experts add on top."""
    T = x.shape[0]
    t_sorted, w_sorted, e_sorted, group_sizes = _moe_route(lp, cfg, x)
    xs = x[t_sorted]
    g = _ragged_mm(xs, lp["we_gate"], group_sizes)
    u = _ragged_mm(xs, lp["we_up"], group_sizes)
    if "be_gate" in lp:  # gpt-oss per-expert projection biases
        g = g + lp["be_gate"][e_sorted]
        u = u + lp["be_up"][e_sorted]
    o = _ragged_mm(_expert_act(cfg, g, u), lp["we_down"], group_sizes)
    if "be_down" in lp:
        o = o + lp["be_down"][e_sorted]
    out = _moe_combine(o, t_sorted, w_sorted, T, x.dtype)
    if "shared_gate" in lp:
        out = out + _shared_expert(lp, x)
    return out


def _shared_expert(lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Shared-expert contribution: DeepSeek's is always on; Qwen2-MoE gates
    it per token with sigmoid(x @ shared_expert_gate)."""
    shared = swiglu(x, lp["shared_gate"], lp["shared_up"], lp["shared_down"])
    if "shared_egate" in lp:
        g = torch.sigmoid(x.float() @ lp["shared_egate"].float())
        shared = shared * g.to(shared.dtype)
    return shared


def _dense_expert_mm(x, w, spec: str):
    """Dense-dispatch einsum against a plain or quantized expert stack
    (scales ``[X, out]`` broadcast over the ``[T, X, out]`` product)."""
    if isinstance(w, dict):
        out = torch.einsum(spec, x, w["q"].to(x.dtype))
        return out * w["s"][None].to(out.dtype)
    return torch.einsum(spec, x, w)


def moe_ffn_dense(lp: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense-dispatch reference (every expert computes every token, the
    routing matrix selects), shared experts included: the tests' oracle."""
    vals, idx = _route_topk(lp, cfg, x)
    w = torch.zeros(x.shape[0], cfg.num_experts, device=x.device).scatter_add_(
        1, idx, vals
    )  # [T, X] routing weights
    g = _dense_expert_mm(x, lp["we_gate"], "te,xef->txf")
    u = _dense_expert_mm(x, lp["we_up"], "te,xef->txf")
    if "be_gate" in lp:  # gpt-oss per-expert projection biases
        g = g + lp["be_gate"][None]
        u = u + lp["be_up"][None]
    y = _dense_expert_mm(_expert_act(cfg, g, u), lp["we_down"], "txf,xfe->txe")
    if "be_down" in lp:
        y = y + lp["be_down"][None]
    out = torch.einsum("txe,tx->te", y, w.to(x.dtype))
    if "shared_gate" in lp:
        out = out + _shared_expert(lp, x)
    return out


def _ffn(lp: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    # branch on the GROUP's own leaves: DeepSeek's first_k_dense_replace
    # layers are dense inside an MoE model
    if "moe_gate" in lp:
        return moe_ffn(lp, cfg, h)
    return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.hidden_act)


def _post_norm(lp: dict, key: str, v: torch.Tensor, cfg: ModelConfig):
    """Gemma's sandwich norm of a sublayer's output before the residual add
    (``attn_post_norm`` / ``mlp_post_norm``); the identity for a model
    without those leaves."""
    w = lp.get(key)
    return v if w is None else rms_norm(v, w, cfg.rms_norm_eps)


def _layer_tail(x, lp, o_flat, cfg: ModelConfig):
    o = _mm(o_flat, lp["wo"])
    if "bo" in lp:  # gpt-oss: o_proj carries a bias
        o = o + lp["bo"]
    x = x + _post_norm(lp, "attn_post_norm", o, cfg)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + _post_norm(lp, "mlp_post_norm", _ffn(lp, cfg, h), cfg)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return (x @ head).float()


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def _check_planes(cfg: ModelConfig, k_cache, k_scales, v_scales) -> bool:
    """Whether the int8-with-scales cache is on: both planes or neither,
    and never for MLA (its latent path has no per-page scale stream). A
    scale-free fp8 cache (``float8_e4m3fn``) takes no planes, GQA or MLA
    (the latent pages widen exactly in both latent kernels)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if k_scales is not None and cfg.is_mla:
        raise ValueError("the int8-with-scales KV cache is not supported for "
                         "MLA models (the absorbed latent path has no "
                         "per-page scale stream)")
    if k_cache.dtype == torch.float8_e4m3fn and k_scales is not None:
        raise ValueError("an fp8 KV cache takes no scale planes")
    return k_scales is not None


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
    k_scales: Optional[torch.Tensor] = None,  # [L, N] f32 (int8 cache), IN PLACE
    v_scales: Optional[torch.Tensor] = None,
):
    """Process one (chunk of a) prompt; returns (last-real-token logits
    [V] f32, k_cache, v_cache[, k_scales, v_scales]). ``history_len``
    cached tokens are attended but not recomputed (chunked prefill and
    prefix-cache hits). MLA layers write the chunk's latents first, then
    run the latent prefill kernel. With the scale planes (int8 cache, GQA)
    the chunk lands quantized, growing its pages' scales, and attention
    reads every page through the updated planes."""
    quantized = _check_planes(cfg, k_cache, k_scales, v_scales)
    dev = tokens.device
    T = tokens.shape[0]
    history_len, valid_len = int(history_len), int(valid_len)
    x = _embed(params, cfg, tokens)  # [T, E]
    positions = torch.arange(T, device=dev) + history_len
    inv_freq, msc, scale = _rope_and_scale(cfg, dev)
    rope, rope_local = _rope_pair(cfg, positions, inv_freq, msc)
    blk, off = att.chunk_slot_indices(block_table, history_len, T,
                                      k_cache.shape[3])
    hist, valid = _i32([history_len], dev), _i32([valid_len], dev)
    for l, lp in _layers(params, cfg):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        if cfg.is_mla:
            q_eff, q_pe, c_kv, k_pe = mla.mla_q_and_latent(lp, cfg, h, rope)
            att.write_slots(k_cache[l], c_kv[:, None], blk, off)
            att.write_slots(v_cache[l], k_pe[:, None], blk, off)
            o_lat = mla_paged_prefill_attention(
                q_eff, q_pe, k_cache[l], v_cache[l], block_table, hist, scale,
                valid_len=valid,
            )
            o = mla._o_proj(lp, cfg, o_lat).to(x.dtype)
        else:
            q, k, v = _qkv(lp, cfg, h)
            rl = rope_freqs_for_layer(cfg, l, rope, rope_local)
            q, k = rotate(q, rl), rotate(k, rl)
            ks_l = vs_l = None
            if quantized:
                _, ks_l = att.write_chunk_to_cache_quantized(
                    k_cache[l], k_scales[l], k, block_table, history_len, valid)
                _, vs_l = att.write_chunk_to_cache_quantized(
                    v_cache[l], v_scales[l], v, block_table, history_len, valid)
                k_scales[l], v_scales[l] = ks_l, vs_l
            else:
                att.write_slots(k_cache[l], k, blk, off)
                att.write_slots(v_cache[l], v, blk, off)
            o = att.chunk_attention_with_cache(
                q, k, v, k_cache[l], v_cache[l], block_table, hist, valid, scale,
                window=window_for_layer(cfg, l), sinks=lp.get("sinks"),
                k_scales=ks_l, v_scales=vs_l,
            ).reshape(T, -1)
        x = _layer_tail(x, lp, o, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = min(max(valid_len - 1, 0), T - 1)
    out = (_logits(params, cfg, x[last]), k_cache, v_cache)
    return out + (k_scales, v_scales) if quantized else out


# ---------------- merged decode ----------------


def _decode_body(params, cfg, tokens, positions, block_tables, seq_lens,
                 k_cache, v_cache, k_scales=None, v_scales=None):
    """One decode step for all sequences, the MERGED one-write path:
    attention handles the current token out of the cache (flash merge over
    the stats-emitting paged kernel: GQA, or the latent kernel for MLA),
    then ONE in-place append writes every layer's new K/V (or c_kv/k_pe).
    With the scale planes, history pages read through the step-entry
    planes, the current token merges in at full precision, and ONE
    ``append_quantized_rows`` (the quantized append, one launch) writes
    all layers and grows the planes in place. Returns (logits [B, V] f32,
    k_cache, v_cache[, k_scales, v_scales, n_requants])."""
    quantized = _check_planes(cfg, k_cache, k_scales, v_scales)
    x = _embed(params, cfg, tokens)  # [B, E]
    B = x.shape[0]
    inv_freq, msc, scale = _rope_and_scale(cfg, x.device)
    blk, off = att.decode_slot_indices(block_tables, positions, k_cache.shape[3])
    hist_lens = seq_lens - 1  # cache contents EXCLUDE the new token
    rope, rope_local = _rope_pair(cfg, positions, inv_freq, msc)
    k_news, v_news = [], []
    for l, lp in _layers(params, cfg):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        if cfg.is_mla:
            q_eff, q_pe, c_kv, k_pe = mla.mla_q_and_latent(lp, cfg, h, rope)
            k_news.append(c_kv[:, None])  # [B, 1, C]
            v_news.append(k_pe[:, None])  # [B, 1, R]
            o_lat = mla_decode_attention_merged(
                q_eff, q_pe, c_kv, k_pe, k_cache[l], v_cache[l], block_tables,
                hist_lens, scale,
            )
            o = mla._o_proj(lp, cfg, o_lat).to(x.dtype)
        else:
            q, k, v = _qkv(lp, cfg, h)  # [B, H, D], [B, Hkv, D]
            rl = rope_freqs_for_layer(cfg, l, rope, rope_local)
            q, k = rotate(q, rl), rotate(k, rl)
            k_news.append(k)
            v_news.append(v)
            o = att.decode_attention_merged(
                q, k, v, k_cache[l], v_cache[l], block_tables, hist_lens, scale,
                window=window_for_layer(cfg, l), sinks=lp.get("sinks"),
                k_scales=k_scales[l] if quantized else None,
                v_scales=v_scales[l] if quantized else None,
            ).reshape(B, -1)
        x = _layer_tail(x, lp, o, cfg)
    blk, off = blk.to(torch.int32), off.to(torch.int32)
    k_new, v_new = torch.stack(k_news), torch.stack(v_news)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = _logits(params, cfg, x)
    if not quantized:
        kv_cache_append(k_new, v_new, k_cache, v_cache, blk, off)
        return logits, k_cache, v_cache
    n_req = append_quantized_rows(k_new, v_new, k_cache, v_cache, k_scales,
                                  v_scales, blk, off)
    return logits, k_cache, v_cache, k_scales, v_scales, n_req


def _i64(x, device) -> torch.Tensor:
    """Seeds or steps as an int64 tensor on ``device`` (a host sequence is
    uploaded; a tensor is used where it lies)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor([int(v) for v in x], dtype=torch.int64, device=device)


def _host_flags(temps, top_ks, top_ps, sampled, filtered):
    """The two host decisions of a sampling step: any row sampled (a
    temperature above 0: keys are drawn) and any row filtered (top-k or
    top-p: the sort runs). Callers that know them (the engine, from its
    host arrays) pass them; otherwise they are read from the card here,
    once per dispatch (the filter only for a batch that samples)."""
    if sampled is None:
        sampled = bool((temps > 0.0).any())
    if filtered is None:
        filtered = sampled and bool(((top_ks > 0) | (top_ps < 1.0)).any())
    return sampled, filtered


def _sample_step(logits, keys, temps, top_ks, top_ps, filtered, penalties,
                 with_logprobs):
    """Penalties on the sampled distribution, raw logits for logprobs (the
    JAX decode_window body). ``keys`` ``[B, 2]`` (None: an all-greedy
    batch); ``penalties`` = (freq, pres, rep, counts, prompt_mask) or None;
    counts are bumped in place."""
    raw = logits
    if penalties is not None:
        freq, pres, rep, counts, mask = penalties
        logits = apply_penalties(logits, counts, mask, freq, pres, rep)
    nxt = sample_tokens(logits, keys, temps, top_ks, top_ps, filtered)
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
    seeds,  # [B] int sampling seeds (host sequence or int64 tensor)
    steps,  # [B] int per-request generation counters (likewise)
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
    k_scales: Optional[torch.Tensor] = None,  # [L, N] f32 (int8 cache), IN PLACE
    v_scales: Optional[torch.Tensor] = None,
    sampled: Optional[bool] = None,  # any temperature > 0; None = read it
    filtered: Optional[bool] = None,  # any top-k / top-p row; None = read it
):
    """``n_steps`` decode+sample steps; the sampled token of step i feeds
    step i+1 on the device. Returns (tokens [n_steps, B] int32, k_cache,
    v_cache[, k_scales, v_scales, n_requants][, counts][, (chosen_lp,
    top_ids, top_lps) each [n_steps, ...]]) — the planes and the device
    int32 count of scale entries that grew in the window with the int8
    cache, counts only with penalties. Callers pre-allocate KV blocks for
    ``n_steps`` new tokens per sequence. With device ``seeds`` / ``steps``
    and both host flags given, the window reads nothing back from the card
    (the engine captures it in a CUDA graph); step i's keys are
    ``(seed, step + i)``, hashed on the device."""
    quantized = _check_planes(cfg, k_cache, k_scales, v_scales)
    dev = tokens.device
    n_req = (torch.zeros((), dtype=torch.int32, device=dev)
             if quantized else None)
    penalties = (
        None if counts is None
        else (freq_pens, pres_pens, rep_pens, counts, prompt_mask)
    )
    sampled, filtered = _host_flags(temps, top_ks, top_ps, sampled, filtered)
    keys = None
    if sampled:  # [B, n_steps, 2]: every step's keys in one hash
        keys = make_keys(_i64(seeds, dev)[:, None], _i64(steps, dev)[:, None]
                         + torch.arange(n_steps, device=dev))
    toks, lps = [], []
    for i in range(n_steps):
        out = _decode_body(
            params, cfg, tokens, positions, block_tables, seq_lens,
            k_cache, v_cache, k_scales, v_scales,
        )
        logits = out[0]
        if quantized:
            n_req = n_req + out[5]
        nxt, lp = _sample_step(
            logits, None if keys is None else keys[:, i], temps, top_ks,
            top_ps, filtered, penalties, with_logprobs,
        )
        toks.append(nxt)
        lps.append(lp)
        tokens, positions, seq_lens = nxt, positions + 1, seq_lens + 1
    out = (torch.stack(toks), k_cache, v_cache)
    if quantized:
        out += (k_scales, v_scales, n_req)
    if penalties is not None:
        out += (counts,)
    if with_logprobs:
        out += (tuple(torch.stack(parts) for parts in zip(*lps)),)
    return out


# ---------------- fused mixed prefill+decode step ----------------


def _mixed_fused_forward(
    params, cfg, d_tokens, d_positions, d_tables, d_seq_lens,
    p_tokens, p_tables, p_hists, p_valids, k_cache, v_cache,
    k_scales=None, v_scales=None,
):
    """Embeddings and every projection/FFN/logits GEMM run over the combined
    [B + MP*T] row axis; attention is ONE ragged paged-attention call per
    layer covering the decode rows and every segment. Write-before-attend:
    each layer scatters the decode tokens' and the segments' K/V first
    (padded/dead segment rows land in trash page 0 through their zero
    table entries). GQA only: MLA takes :func:`_mixed_per_part` (there is
    no latent ragged kernel). With the scale planes the writes are the
    quantized ones (the decode rows, then each segment), and the ragged
    kernel reads every page through the updated planes. Returns
    (decode_logits [B, V] f32, p_logits [MP, V] f32, k_cache, v_cache)."""
    quantized = _check_planes(cfg, k_cache, k_scales, v_scales)
    B = d_tokens.shape[0]
    MP, T = p_tokens.shape
    bs = k_cache.shape[3]
    dev = d_tokens.device
    x = _embed(params, cfg, torch.cat([d_tokens, p_tokens.reshape(-1)]))
    p_positions = (p_hists.long()[:, None] + torch.arange(T, device=dev)).reshape(-1)
    positions_all = torch.cat([d_positions.long(), p_positions])
    inv_freq, msc, scale = _rope_and_scale(cfg, dev)
    d_blk, d_off = att.decode_slot_indices(d_tables, d_positions, bs)
    p_blk, p_off = att.chunk_slot_indices(p_tables, p_hists, T, bs)
    blk = torch.cat([d_blk.long(), p_blk.reshape(-1)])
    off = torch.cat([d_off.long(), p_off.reshape(-1)])
    rope, rope_local = _rope_pair(cfg, positions_all, inv_freq, msc)
    for l, lp in _layers(params, cfg):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h)  # [B+MP*T, H/Hkv, D]
        rl = rope_freqs_for_layer(cfg, l, rope, rope_local)
        q, k = rotate(q, rl), rotate(k, rl)
        ks_l = vs_l = None
        if quantized:
            ks_l, vs_l = _write_mixed_quantized(
                k_cache[l], v_cache[l], k_scales[l], v_scales[l], k, v, B, T,
                d_tables, d_positions, p_tables, p_hists, p_valids)
            k_scales[l], v_scales[l] = ks_l, vs_l
        else:
            att.write_slots(k_cache[l], k, blk, off)
            att.write_slots(v_cache[l], v, blk, off)
        o = ragged_mixed_attention_rows(
            q, k_cache[l], v_cache[l], d_tables, d_seq_lens, p_tables,
            p_hists, p_valids, scale, T, k_scales=ks_l, v_scales=vs_l,
            window=window_for_layer(cfg, l), sinks=lp.get("sinks"),
        )
        x = _layer_tail(x, lp, o.reshape(o.shape[0], -1), cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits_d = _logits(params, cfg, x[:B])
    # each segment's last REAL row only
    last = B + torch.arange(MP, device=dev) * T + (p_valids.long() - 1).clamp(0, T - 1)
    p_logits = _logits(params, cfg, x[last])
    return logits_d, p_logits, k_cache, v_cache


def _write_mixed_quantized(kc_l, vc_l, ks_l, vs_l, k, v, B, T, d_tables,
                           d_positions, p_tables, p_hists, p_valids):
    """The fused step's quantized writes of one layer, in the reference's
    order: the decode rows, then each segment's chunk. Returns the grown
    scale slices."""
    _, ks_l = att.write_decode_token_to_cache_quantized(
        kc_l, ks_l, k[:B], d_tables, d_positions)
    _, vs_l = att.write_decode_token_to_cache_quantized(
        vc_l, vs_l, v[:B], d_tables, d_positions)
    for m in range(p_tables.shape[0]):
        rows = slice(B + m * T, B + (m + 1) * T)
        _, ks_l = att.write_chunk_to_cache_quantized(
            kc_l, ks_l, k[rows], p_tables[m], p_hists[m], p_valids[m])
        _, vs_l = att.write_chunk_to_cache_quantized(
            vc_l, vs_l, v[rows], p_tables[m], p_hists[m], p_valids[m])
    return ks_l, vs_l


def _mixed_per_part(
    params, cfg, d_tokens, d_positions, d_tables, d_seq_lens,
    p_tokens, p_tables, p_hists, p_valids, k_cache, v_cache,
):
    """The per-part flavor of the mixed step (the JAX package's MLA path):
    each live segment runs through :func:`prefill` in admission order, then
    the decode batch through the merged :func:`_decode_body`. The parts are
    independent (no prefill sequence decodes; segments own disjoint pages),
    so the order changes nothing. Dead pad segments (valid 0) are skipped:
    their logits row, never read, is zero. Same return as
    :func:`_mixed_fused_forward`."""
    hists, valids = p_hists.tolist(), p_valids.tolist()
    rows = []
    for m, (hist, valid) in enumerate(zip(hists, valids)):
        if valid <= 0:
            rows.append(None)
            continue
        lg, k_cache, v_cache = prefill(
            params, cfg, p_tokens[m], p_tables[m], hist, valid, k_cache, v_cache,
        )
        rows.append(lg)
    logits_d, k_cache, v_cache = _decode_body(
        params, cfg, d_tokens, d_positions, d_tables, d_seq_lens, k_cache,
        v_cache,
    )
    zero = logits_d.new_zeros(logits_d.shape[-1])
    p_logits = torch.stack([zero if r is None else r for r in rows])
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
    k_scales: Optional[torch.Tensor] = None,  # [L, N] f32 (int8 cache), IN PLACE
    v_scales: Optional[torch.Tensor] = None,
    sampled: Optional[bool] = None,  # as in decode_window
    filtered: Optional[bool] = None,
):
    """ONE fused step: MP prefill chunks plus a decode token for every
    active sequence (GQA: combined-row GEMMs and one ragged attention call
    per layer; MLA: the per-part flavor). Returns (next_tokens [B],
    p_logits [MP, V] f32, k_cache, v_cache[, k_scales, v_scales,
    n_requants][, counts][, (chosen_lp, top_ids, top_lps)])."""
    quantized = _check_planes(cfg, k_cache, k_scales, v_scales)
    if quantized:
        # scales only grow within a step: entries above their step-entry
        # value count the pages requantized by this dispatch
        k_scales0, v_scales0 = k_scales.clone(), v_scales.clone()
        logits_d, p_logits, k_cache, v_cache = _mixed_fused_forward(
            params, cfg, d_tokens, d_positions, d_tables, d_seq_lens,
            p_tokens, p_tables, p_hists, p_valids, k_cache, v_cache,
            k_scales, v_scales,
        )
    else:
        forward = _mixed_per_part if cfg.is_mla else _mixed_fused_forward
        logits_d, p_logits, k_cache, v_cache = forward(
            params, cfg, d_tokens, d_positions, d_tables, d_seq_lens,
            p_tokens, p_tables, p_hists, p_valids, k_cache, v_cache,
        )
    penalties = (
        None if counts is None
        else (freq_pens, pres_pens, rep_pens, counts, prompt_mask)
    )
    sampled, filtered = _host_flags(temps, top_ks, top_ps, sampled, filtered)
    dev = d_tokens.device
    keys = make_keys(_i64(seeds, dev), _i64(steps, dev)) if sampled else None
    nxt, lps = _sample_step(logits_d, keys, temps, top_ks, top_ps, filtered,
                            penalties, with_logprobs)
    out = (nxt, p_logits, k_cache, v_cache)
    if quantized:
        n_req = ((k_scales > k_scales0).sum()
                 + (v_scales > v_scales0).sum()).to(torch.int32)
        out += (k_scales, v_scales, n_req)
    if penalties is not None:
        out += (counts,)
    if with_logprobs:
        out += (lps,)
    return out


# ---------------- speculative verify (prompt-lookup decoding) ----------------


def _verify_forward(params, cfg, tokens, positions, block_tables, seq_lens,
                    k_cache, v_cache, n_spec: int):
    """The fused multi-token forward of the speculative verify: logits ``[B,
    T, V]`` f32 for T = n_spec + 1 in-flight tokens per sequence in one pass
    (the weight stream amortizes over T), attention reading the caches as
    history only (``seq_lens - 1`` rows) with the window out of the cache,
    then ONE ``kv_cache_append_tokens`` of every layer's T rows. Rows past
    the accepted run hold rejected proposals' K/V above the commit horizon,
    overwritten before any read (as a discarded decode-window tail)."""
    _check_planes(cfg, k_cache, None, None)
    T = n_spec + 1
    B = tokens.shape[0]
    dev = tokens.device
    pos_bt = positions.long()[:, None] + torch.arange(T, device=dev)[None, :]
    hist_lens = seq_lens - 1  # cache rows before the in-flight window
    x = _embed(params, cfg, tokens.reshape(-1))  # [B*T, E]
    blk, off = att.chunk_slot_indices(block_tables, positions, T,
                                      k_cache.shape[3])  # [B, T]
    inv_freq, msc, scale = _rope_and_scale(cfg, dev)
    rope, rope_local = _rope_pair(cfg, pos_bt.reshape(-1), inv_freq, msc)
    k_news, v_news = [], []
    for l, lp in _layers(params, cfg):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        if cfg.is_mla:
            q_eff, q_pe, c_kv, k_pe = mla.mla_q_and_latent(lp, cfg, h, rope)
            c_kv, k_pe = c_kv.reshape(B, T, -1), k_pe.reshape(B, T, -1)
            k_news.append(c_kv[:, :, None])  # [B, T, 1, C]
            v_news.append(k_pe[:, :, None])  # [B, T, 1, R]
            o_lat = mla_verify_attention(
                q_eff.reshape(B, T, *q_eff.shape[1:]),
                q_pe.reshape(B, T, *q_pe.shape[1:]), c_kv, k_pe, k_cache[l],
                v_cache[l], block_tables, hist_lens, scale,
            )
            o = mla._o_proj(lp, cfg, o_lat).to(x.dtype).reshape(B * T, -1)
        else:
            q, k, v = _qkv(lp, cfg, h)  # [B*T, H/Hkv, D]
            rl = rope_freqs_for_layer(cfg, l, rope, rope_local)
            q, k = rotate(q, rl), rotate(k, rl)
            k, v = k.reshape(B, T, *k.shape[1:]), v.reshape(B, T, *v.shape[1:])
            k_news.append(k)
            v_news.append(v)
            o = att.verify_attention(
                q.reshape(B, T, *q.shape[1:]), k, v, k_cache[l], v_cache[l],
                block_tables, hist_lens, scale,
                window=window_for_layer(cfg, l), sinks=lp.get("sinks"),
            ).reshape(B * T, -1)
        x = _layer_tail(x, lp, o, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = _logits(params, cfg, x).reshape(B, T, -1)
    kv_cache_append_tokens(torch.stack(k_news), torch.stack(v_news), k_cache,
                           v_cache, blk.to(torch.int32), off.to(torch.int32))
    return logits, k_cache, v_cache


@torch.no_grad()
def verify_window(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T]: t=0 last accepted token, t>=1 proposals
    proposals: torch.Tensor,  # [B, n_spec] int32, -1 = no proposal
    positions: torch.Tensor,  # [B] absolute position of tokens[:, 0]
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,  # [B] int32, length INCLUDING tokens[:, 0]
    seeds,  # [B] int sampling seeds (host sequence or int64 tensor)
    steps,  # [B] int per-request generation counters (likewise)
    temps: torch.Tensor,  # [B] float32; 0 = greedy row
    top_ks: torch.Tensor,  # [B] int32
    top_ps: torch.Tensor,  # [B] float32
    k_cache: torch.Tensor,  # updated IN PLACE; holds history only
    v_cache: torch.Tensor,
    n_spec: int,
    freq_pens: Optional[torch.Tensor] = None,
    pres_pens: Optional[torch.Tensor] = None,
    rep_pens: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None,  # [B, V] int32, bumped IN PLACE
    prompt_mask: Optional[torch.Tensor] = None,  # [B, V] bool
    with_logprobs: bool = False,
    sampled: Optional[bool] = None,  # any temperature > 0; None = read it
):
    """Speculative verify + acceptance, greedy and sampled rows:

      * greedy rows accept proposals matching the argmax chain;
      * sampled rows use rejection sampling against the deterministic draft
        (``sampling.speculative_accept``); the accept draws come from the
        ``seed ^ 0x5EC`` stream at ``step + t``, the corrections and the
        bonus from the plain ``(seed, step + t)`` stream, so the emitted
        tokens' keys are the plain decode's.

    Penalties (with ``counts``) follow plain decode's SEQUENTIAL semantics
    inside the window: position t is penalized by the base counts plus the
    window's proposals before t, and the counts gain every emitted token.
    Acceptance and the greedy argmax read the penalized logits; logprobs
    report the model's raw distribution (as :func:`decode_window`).

    Returns (out_tokens [B, T] int32, n_acc [B] int32, k_cache, v_cache[,
    counts][, (chosen_lp [B, T], top_ids [B, T, K], top_lps [B, T, K])]):
    the caller emits ``out_tokens[:, :n_acc + 1]``. ``sampled`` as in
    :func:`decode_window` (acceptance always applies the top-k / top-p
    filter, so there is no ``filtered``): with device seeds and steps and
    the flag given, the verify reads nothing back from the card."""
    T = n_spec + 1
    B = tokens.shape[0]
    dev = tokens.device
    # read before the forward is queued (as decode_window does), so an
    # all-greedy verify never waits for the card mid-stream
    if sampled is None:
        sampled = bool((temps > 0.0).any())
    logits, k_cache, v_cache = _verify_forward(
        params, cfg, tokens, positions, block_tables, seq_lens, k_cache,
        v_cache, n_spec,
    )
    raw = logits.float()
    V = raw.shape[-1]
    sample_logits = raw
    if counts is not None:
        # window bumps BEFORE each position: proposal t bumps positions > t
        # (an unproposed slot bumps nothing)
        oh = torch.zeros(B, n_spec, V, dtype=torch.int32, device=dev)
        oh.scatter_(2, proposals.clamp_min(0).long()[..., None],
                    (proposals >= 0).to(torch.int32)[..., None])
        cum = torch.cat([oh.new_zeros(B, 1, V), torch.cumsum(oh, dim=1)], dim=1)
        cnt_t = (counts[:, None] + cum).reshape(B * T, V)
        sample_logits = apply_penalties(
            raw.reshape(B * T, V), cnt_t, prompt_mask.repeat_interleave(T, 0),
            freq_pens.repeat_interleave(T), pres_pens.repeat_interleave(T),
            rep_pens.repeat_interleave(T),
        ).reshape(B, T, V)
    keys_accept = keys_sample = None
    if sampled:  # [B, n_spec, 2] and [B, T, 2], hashed on the device
        seed = _i64(seeds, dev)[:, None]
        at = _i64(steps, dev)[:, None] + torch.arange(T, device=dev)
        keys_accept = make_keys(seed ^ 0x5EC, at[:, :n_spec])
        keys_sample = make_keys(seed, at)
    out, n_acc = speculative_accept(sample_logits, proposals, keys_accept,
                                    keys_sample, temps, top_ks, top_ps)
    result = (out, n_acc, k_cache, v_cache)
    if counts is not None:
        # every emitted token (t <= n_acc) counts once
        emitted = torch.arange(T, device=dev)[None, :] <= n_acc[:, None]
        counts.scatter_add_(1, out.long(), emitted.to(counts.dtype))
        result += (counts,)
    if with_logprobs:
        chosen, top_ids, top_lps = token_logprobs(raw.reshape(B * T, V),
                                                  out.reshape(-1))
        result += ((chosen.reshape(B, T), top_ids.reshape(B, T, -1),
                    top_lps.reshape(B, T, -1)),)
    return result


# ---------------- the cache-free oracle ----------------


def _causal_attention(q, k, v, mask, scale: float, sinks=None) -> torch.Tensor:
    """Full attention of ``q [T, H, D]`` over ``k, v [T, Hkv, D]`` under
    ``mask [T, T]``: scores in the input dtype read as f32, softmax in f32
    (with each head's sink logit in the normalizer, no value row),
    probabilities cast back to v's dtype (the JAX package's
    ``prefill_attention_xla``)."""
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    s = torch.einsum("thd,shd->hts", q * scale, k).float().masked_fill(
        ~mask, -1e30)
    if sinks is None:
        p = torch.softmax(s, dim=-1)
    else:
        sk = sinks.float()[:, None, None]  # [H, 1, 1]
        m = torch.maximum(s.amax(-1, keepdim=True), sk)
        e = torch.exp(s - m) * mask
        p = e / (e.sum(-1, keepdim=True) + torch.exp(sk - m)).clamp_min(1e-30)
    return torch.einsum("hts,shd->thd", p.to(v.dtype), v)


def _mla_naive_attention(lp: dict, cfg: ModelConfig, h, positions, inv_freq,
                         msc: float, scale: float, mask) -> torch.Tensor:
    """MLA without absorption: per-head K/V rebuilt from the latent in f32
    (the JAX package's ``dense_forward`` MLA branch, deliberately apart
    from ``mla.mla_q_and_latent`` so the absorbed path is checked against
    an independent formulation). Returns ``[T, H * v_head_dim]`` in h's
    dtype."""
    T = h.shape[0]
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    C = cfg.kv_lora_rank
    if cfg.q_lora_rank:
        q = _mm(rms_norm(_mm(h, lp["wq_a"]), lp["q_norm"], cfg.rms_norm_eps),
                lp["wq_b"])
    else:
        q = _mm(h, lp["wq"])
    q = q.reshape(T, H, dn + dr)
    q_nope = q[..., :dn]
    q_pe = mla.rope_rotate(q[..., dn:], positions, inv_freq, msc)
    kv = _mm(h, lp["wkv_a"])
    c_kv = rms_norm(kv[..., :C], lp["kv_norm"], cfg.rms_norm_eps)
    k_pe = mla.rope_rotate(kv[..., C:][:, None, :], positions, inv_freq,
                           msc)[:, 0, :]
    w_kc, w_vc = mla._wkv_b_parts(lp, cfg)
    k_nope = torch.einsum("tc,chd->thd", c_kv.float(), w_kc.float())
    v = torch.einsum("tc,chd->thd", c_kv.float(), w_vc.float())
    qf = torch.cat([q_nope.float(), q_pe.float()], dim=-1)
    kf = torch.cat([k_nope, k_pe[:, None, :].float().expand(T, H, dr)], dim=-1)
    s = torch.einsum("thd,shd->hts", qf * scale, kf)
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("hts,shd->thd", p, v).reshape(T, -1).to(h.dtype)


@torch.no_grad()
def dense_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The straight full-attention forward ``[T] -> logits [T, V]`` f32,
    with no cache: the ground truth the paged paths and checkpoint loads
    are held to (the JAX package's ``dense_forward``). GQA through
    :func:`_qkv` (biases, per-head q/k norms) and plain causal attention;
    MLA through its naive, non-absorbed formulation; Gemma-3's two ropes
    and sandwich norms as the paged paths take them. Plain PyTorch on any
    device: it launches none of the port's kernels."""
    check_supported(cfg)
    T = tokens.shape[0]
    dev = tokens.device
    x = _embed(params, cfg, tokens)
    positions = torch.arange(T, device=dev)
    causal = positions[:, None] >= positions[None, :]
    inv_freq, msc, scale = _rope_and_scale(cfg, dev)
    inv_local = _rope_freqs_local(cfg, dev)
    for l, lp in _layers(params, cfg):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        if cfg.is_mla:
            o = _mla_naive_attention(lp, cfg, h, positions, inv_freq, msc,
                                     scale, causal)
        else:
            q, k, v = _qkv(lp, cfg, h)
            fr = rope_freqs_for_layer(cfg, l, inv_freq, inv_local)
            q = apply_rope(q, positions, fr, msc)
            k = apply_rope(k, positions, fr, msc)
            mask, w = causal, window_for_layer(cfg, l)
            if w > 0:
                mask = causal & (positions[:, None] - positions[None, :] < w)
            o = _causal_attention(q, k, v, mask, scale,
                                  lp.get("sinks")).reshape(T, -1)
        x = _layer_tail(x, lp, o, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, cfg, x)
