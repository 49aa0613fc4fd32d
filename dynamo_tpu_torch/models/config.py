"""Model architecture config (llama-family superset + MoE fields).

A copy of ``dynamo_tpu/models/config.py`` (the port imports nothing of the
JAX package), with the presets the port serves: ``tiny``, ``tiny_mla``,
``llama3_8b``, ``gptoss_120b`` / ``gptoss_20b`` and DeepSeek-V2-Lite (:data:`DEEPSEEK_V2_LITE_HF`, the
published ``config.json``, parsed by :meth:`ModelConfig.from_hf_config`);
and the published ``config.json`` values of Qwen2.5-7B-Instruct
(:data:`QWEN25_7B_HF`), Qwen3-8B (:data:`QWEN3_8B_HF`) and
Mistral-7B-Instruct-v0.2 (:data:`MISTRAL_7B_V02_HF`), which chip_smoke.py
serves at full width.
The port's forward covers dense GQA decoders (gpt-oss included) and the
DeepSeek MLA + MoE family; models/llama.py ``check_supported`` raises on
the rest.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional


def is_yarn(rope_scaling: dict) -> bool:
    return (
        rope_scaling.get("type") == "yarn"
        or rope_scaling.get("rope_type") == "yarn"
    )


def yarn_mscale(factor: float, mscale: float) -> float:
    """DeepSeek's YaRN attention-scale correction (ONE copy — the rope
    cos/sin correction in models/mla.py uses the same formula)."""
    import math

    if factor <= 1.0 or mscale == 0:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


@dataclass(eq=False)  # identity hash/eq, as in the JAX package
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 0  # 0 -> hidden_size // num_heads
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    # qwen3: per-head RMS norm on q and k after projection, before rope
    qk_norm: bool = False
    # olmo-2: q/k RMS norm over the FULL projection width (pre-reshape)
    qk_norm_full: bool = False
    # olmo-2: NO input/pre-FFN norms — normalization applies to the
    # sublayer OUTPUT (post_norms) only
    norm_after: bool = False
    # MoE (0 experts = dense)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0
    num_shared_experts: int = 0  # DeepSeek-style always-on experts
    # Qwen2-MoE: one shared expert of its OWN width whose contribution
    # is gated by sigmoid(x @ shared_expert_gate) instead of always-on
    shared_expert_size: int = 0  # 0 = moe_intermediate * num_shared
    shared_expert_gate: bool = False
    first_dense_layers: int = 0  # DeepSeek first_k_dense_replace
    norm_topk_prob: bool = True  # Mixtral renormalizes top-k gate probs
    # DeepSeek-V2/V3 routing variants (ref patch:3548-3560 deepseek_v2;
    # BASELINE config 5 names DeepSeek-R1 = the V3 architecture)
    moe_scoring: str = "softmax"  # "softmax" (V2) | "sigmoid" (V3)
    moe_gate_bias: bool = False  # V3 e_score_correction_bias (topk only)
    routed_scaling_factor: float = 1.0
    n_group: int = 0  # group-limited routing (0 = off)
    topk_group: int = 0
    # group score: V2 group_limited_greedy uses the group MAX, V3
    # noaux_tc the sum of the group's top-2
    moe_group_score: str = "max"
    # Multi-Latent Attention (DeepSeek-V2/V3; kv_lora_rank > 0 enables).
    # The KV cache stores the COMPRESSED latent per token: c_kv
    # [kv_lora_rank] in the k-cache slot and the shared rotated k_pe
    # [qk_rope_head_dim] in the v-cache slot, both single-"head" paged
    # arrays — attention runs ABSORBED (q_nope folded through the
    # kv_b up-projection), so per-token cache bytes are
    # kv_lora_rank + qk_rope_head_dim instead of 2*Hkv*head_dim.
    q_lora_rank: int = 0  # 0 = direct q projection (V2-Lite)
    kv_lora_rank: int = 0  # 0 = regular attention
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # DeepSeek checkpoints store rope dims interleaved (GPT-J pairs);
    # weights.py de-interleaves at load so the runtime rotation stays the
    # fast half-split form — this flag records the CHECKPOINT convention
    rope_interleave: bool = False
    # sliding-window attention (mistral v0.1-style; 0 = full attention)
    sliding_window: int = 0
    # gpt-oss: layers ALTERNATE sliding/full attention. When set, entry
    # l is layer l's window (0 = full) and the GLOBAL sliding_window is
    # forced to 0 — per-layer entries are the only source of widths
    layer_windows: tuple = ()
    # gpt-oss attention sinks: a learnable per-head logit joins every
    # softmax's normalization (no value row)
    attn_sinks: bool = False
    # gpt-oss expert FFN: fused clamped SwiGLU — gate clamped at +limit,
    # up at +-limit, glu = gate*sigmoid(alpha*gate), out = (up+1)*glu —
    # with per-expert biases on both projections
    moe_act: str = "swiglu"  # "swiglu" | "gptoss_clamp"
    # o_proj bias (gpt-oss: every attention projection carries bias)
    o_bias: bool = False
    # gemma-family variants
    hidden_act: str = "silu"  # "silu" | "gelu_tanh" (gemma GeGLU)
    rms_add_unit: bool = False  # gemma RMSNorm scales by (1 + w)
    scale_embed: bool = False  # gemma multiplies embeddings by sqrt(E)
    # gemma-2: tanh caps on attention scores / final logits, sandwich
    # (post-attention + post-FFN) norms, and a fixed query scale from
    # query_pre_attn_scalar instead of head_dim
    attn_softcap: float = 0.0  # 0 = off
    final_softcap: float = 0.0
    post_norms: bool = False
    attn_scale_base: int = 0  # 0 = use head_dim
    # gemma-3: sliding layers rope at their own LOCAL base frequency
    # (rope_local_base_freq); full layers use rope_theta (+scaling)
    rope_local_theta: float = 0.0  # 0 = single rope for all layers
    # partial rotary (Phi-4-mini, GLM, persimmon): only the first
    # head_dim * rope_partial_factor dims of each head rotate
    # (rope_partial_dim derives in __post_init__ once head_dim resolves)
    rope_partial_factor: float = 1.0
    rope_partial_dim: int = 0
    # runtime
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.layer_windows:
            self.layer_windows = tuple(self.layer_windows)
            if len(self.layer_windows) != self.num_layers:
                raise ValueError(
                    f"layer_windows has {len(self.layer_windows)} entries "
                    f"for {self.num_layers} layers"
                )
        if self.head_dim == 0:
            self.head_dim = self.hidden_size // self.num_heads
        if self.rope_partial_factor != 1.0 and not self.rope_partial_dim:
            self.rope_partial_dim = int(self.head_dim * self.rope_partial_factor)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def mla_softmax_scale(self) -> float:
        """qk_head_dim^-0.5 times the YaRN mscale^2 correction DeepSeek
        applies when rope_scaling.mscale_all_dim is set."""
        scale = self.qk_head_dim**-0.5
        rs = self.rope_scaling or {}
        if is_yarn(rs):
            m = yarn_mscale(rs.get("factor", 1.0),
                            rs.get("mscale_all_dim", 0.0) or 0.0)
            scale = scale * m * m
        return scale

    @staticmethod
    def from_hf_config(cfg: dict) -> "ModelConfig":
        archs = cfg.get("architectures") or []
        if isinstance(cfg.get("text_config"), dict) and any(
            a.startswith("Gemma3") for a in archs
        ):
            # gemma-3 multimodal checkpoints nest the language model
            # under text_config; serve that (the vision tower has no
            # serving path here)
            merged = {**cfg["text_config"], "architectures": archs}
            if cfg.get("torch_dtype") and "torch_dtype" not in merged:
                merged["torch_dtype"] = cfg["torch_dtype"]
            cfg = merged
        # Qwen2 has qkv bias baked into the architecture; its HF config
        # carries no attention_bias field
        qkv_bias = cfg.get("attention_bias", False) or any(
            a.startswith("Qwen2") for a in archs
        )
        # gemma: GeGLU activation, (1+w) norms, sqrt(E)-scaled embeddings
        is_gemma = any(a.startswith("Gemma") for a in archs) or (
            cfg.get("model_type", "").startswith("gemma")
        )
        is_gptoss = any(a.startswith("GptOss") for a in archs)
        is_gemma2 = any(a.startswith("Gemma2") for a in archs) or (
            cfg.get("model_type") == "gemma2"
        )
        is_gemma3 = any(a.startswith("Gemma3") for a in archs) or (
            cfg.get("model_type") in ("gemma3", "gemma3_text")
        )
        # EXACT arch matching: Glm4Moe (qk-norm MoE) and Glm4v
        # (multimodal, text under text_config) have different layer
        # anatomy — reject them rather than mis-serve (the file's
        # standing reject-over-wrong-logits rule)
        glm_archs = {a for a in archs if a.startswith("Glm")}
        if glm_archs - {"GlmForCausalLM", "Glm4ForCausalLM"}:
            raise ValueError(
                f"unsupported GLM variant {sorted(glm_archs)} — only "
                "GlmForCausalLM / Glm4ForCausalLM are implemented"
            )
        is_glm = bool(glm_archs) or cfg.get("model_type") in ("glm", "glm4")
        is_olmo2 = any(a.startswith("Olmo2") for a in archs) or (
            cfg.get("model_type") == "olmo2"
        )
        is_glm4 = "Glm4ForCausalLM" in glm_archs or (
            cfg.get("model_type") == "glm4"
        )
        # qwen2moe: gated shared expert; interleaved dense layers are
        # not implemented — reject rather than serve wrong logits
        is_qwen2moe = any(a.startswith("Qwen2Moe") for a in archs)
        if is_qwen2moe and (
            cfg.get("decoder_sparse_step", 1) != 1
            or cfg.get("mlp_only_layers")
        ):
            raise ValueError(
                "qwen2moe with decoder_sparse_step != 1 or mlp_only_layers "
                "is not supported (interleaved dense/sparse layers)"
            )
        # layer_types: per-layer sliding/full alternation (gpt-oss,
        # gemma-2/3 style)
        layer_windows: tuple = ()
        if (is_gptoss or is_gemma2 or is_gemma3) and cfg.get("layer_types"):
            sw = cfg.get("sliding_window") or 0
            layer_windows = tuple(
                sw if t == "sliding_attention" else 0
                for t in cfg["layer_types"]
            )
        elif is_gemma3 and cfg.get("sliding_window") and cfg.get(
            "sliding_window_pattern"
        ):
            # original gemma-3 uploads predate layer_types: every Nth
            # layer is full attention (HF: sliding iff (i+1) % N != 0)
            sw, n = cfg["sliding_window"], cfg["sliding_window_pattern"]
            layer_windows = tuple(
                sw if (i + 1) % n else 0
                for i in range(cfg.get("num_hidden_layers", 32))
            )
        elif is_gemma3 and cfg.get("sliding_window"):
            raise ValueError(
                "gemma-3 config has sliding_window but neither "
                "layer_types nor sliding_window_pattern — cannot "
                "recover the sliding/full alternation; refusing to "
                "serve wrong attention"
            )
        elif is_gemma2 and cfg.get("sliding_window"):
            # original gemma-2 uploads predate the layer_types key: the
            # architecture alternates sliding on EVEN layers
            # (modeling_gemma2: sliding iff layer_idx % 2 == 0) — a bare
            # global window would wrongly mask the full-attention layers
            sw = cfg["sliding_window"]
            layer_windows = tuple(
                sw if i % 2 == 0 else 0
                for i in range(cfg.get("num_hidden_layers", 32))
            )

        # Phi-3 keeps original_max_position_embeddings at the TOP level
        # of config.json; the longrope math needs it inside the scaling
        # dict (where yarn/llama3 checkpoints put theirs)
        rope_scaling = cfg.get("rope_scaling")
        if (
            rope_scaling
            and (rope_scaling.get("rope_type") or rope_scaling.get("type"))
            == "longrope"
            and "original_max_position_embeddings" not in rope_scaling
            and cfg.get("original_max_position_embeddings")
        ):
            rope_scaling = dict(
                rope_scaling,
                original_max_position_embeddings=cfg[
                    "original_max_position_embeddings"
                ],
            )
        act = cfg.get("hidden_act") or cfg.get("hidden_activation") or "silu"
        if act in ("gelu", "gelu_pytorch_tanh", "gelu_tanh"):
            act = "gelu_tanh"
        return ModelConfig(
            vocab_size=cfg.get("vocab_size", 32000),
            hidden_size=cfg.get("hidden_size", 4096),
            intermediate_size=cfg.get("intermediate_size", 11008),
            num_layers=cfg.get("num_hidden_layers", 32),
            num_heads=cfg.get("num_attention_heads", 32),
            num_kv_heads=cfg.get("num_key_value_heads", cfg.get("num_attention_heads", 32)),
            head_dim=cfg.get("head_dim", 0) or 0,
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_partial_factor=cfg.get("partial_rotary_factor") or 1.0,
            rope_scaling=rope_scaling,
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            max_position_embeddings=cfg.get("max_position_embeddings", 8192),
            tie_word_embeddings=cfg.get("tie_word_embeddings", is_gemma),
            attention_bias=qkv_bias,
            # qwen3 (dense and MoE): per-head q/k RMS norm, no qkv bias
            qk_norm=any(a.startswith("Qwen3") for a in archs) or is_gemma3
            or is_olmo2,
            layer_windows=layer_windows,
            attn_sinks=is_gptoss,
            moe_act="gptoss_clamp" if is_gptoss else "swiglu",
            o_bias=is_gptoss and bool(cfg.get("attention_bias")),
            # mixtral: num_local_experts; deepseek: n_routed_experts;
            # qwen2moe/qwen3moe: the bare num_experts key
            num_experts=cfg.get(
                "num_local_experts",
                cfg.get(
                    "n_routed_experts",
                    cfg.get("num_experts", 0)
                    if any(a.startswith(("Qwen3", "Qwen2Moe"))
                           for a in archs) else 0,
                ),
            ) or 0,
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
            moe_intermediate_size=cfg.get("moe_intermediate_size", 0) or 0,
            # qwen2moe: ONE gated shared expert of its own width
            num_shared_experts=cfg.get("n_shared_experts", 0) or (
                1 if is_qwen2moe else 0
            ),
            shared_expert_size=(
                cfg.get("shared_expert_intermediate_size", 0) or 0
            ) if is_qwen2moe else 0,
            shared_expert_gate=is_qwen2moe,
            first_dense_layers=cfg.get("first_k_dense_replace", 0) or 0,
            norm_topk_prob=cfg.get("norm_topk_prob", True),
            # deepseek_v2/v3 (R1 = V3): sigmoid scoring + gate bias and
            # group-limited top-k arrive with topk_method "noaux_tc"
            moe_scoring=cfg.get("scoring_func", "softmax"),
            moe_gate_bias=cfg.get("topk_method") == "noaux_tc",
            moe_group_score=(
                "top2" if cfg.get("topk_method") == "noaux_tc" else "max"
            ),
            routed_scaling_factor=cfg.get("routed_scaling_factor", 1.0),
            n_group=cfg.get("n_group", 0) or 0,
            topk_group=cfg.get("topk_group", 0) or 0,
            q_lora_rank=cfg.get("q_lora_rank") or 0,
            kv_lora_rank=cfg.get("kv_lora_rank") or 0,
            qk_nope_head_dim=cfg.get("qk_nope_head_dim") or 0,
            qk_rope_head_dim=cfg.get("qk_rope_head_dim") or 0,
            v_head_dim=cfg.get("v_head_dim") or 0,
            # interleaved (GPT-J-pair) rope storage: MLA checkpoints
            # interleave the TRAILING rope dims, GLM the LEADING partial
            # dims — both de-interleave at load so the runtime rotation
            # stays the fast half-split form
            rope_interleave=cfg.get(
                "rope_interleave",
                (cfg.get("model_type", "").startswith("deepseek")
                 and bool(cfg.get("kv_lora_rank"))) or is_glm,
            ),
            # with per-layer windows the GLOBAL width stays 0 — the
            # homogeneous paths/gates must not window every layer
            sliding_window=(
                0 if layer_windows else (cfg.get("sliding_window") or 0)
            ),
            hidden_act=act if act != "silu" else "silu",
            rms_add_unit=is_gemma,
            attn_softcap=(cfg.get("attn_logit_softcapping") or 0.0)
            if is_gemma2 else 0.0,
            final_softcap=(cfg.get("final_logit_softcapping") or 0.0)
            if is_gemma2 else 0.0,
            post_norms=is_gemma2 or is_gemma3 or is_glm4 or is_olmo2,
            norm_after=is_olmo2,
            qk_norm_full=is_olmo2,
            attn_scale_base=(cfg.get("query_pre_attn_scalar") or 0)
            if (is_gemma2 or is_gemma3) else 0,
            rope_local_theta=(cfg.get("rope_local_base_freq") or 0.0)
            if is_gemma3 else 0.0,
            scale_embed=is_gemma,
            dtype=cfg.get("torch_dtype") or "bfloat16",
        )

    @staticmethod
    def from_local_path(path: str) -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return ModelConfig.from_hf_config(json.load(f))

    @staticmethod
    def tiny(**overrides) -> "ModelConfig":
        """A small config for tests/benches."""
        base = dict(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position_embeddings=512,
        )
        base.update(overrides)
        return ModelConfig(**base)

    @staticmethod
    def tiny_mla(**overrides) -> "ModelConfig":
        """A small DeepSeek-shaped MLA config (compressed latent cache,
        absorbed attention) for tests."""
        base = dict(
            num_heads=4, num_kv_heads=4, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            q_lora_rank=24, num_layers=2,
        )
        base.update(overrides)
        return ModelConfig.tiny(**base)

    # llama-3-8b-ish for benches
    @staticmethod
    def llama3_8b(**overrides) -> "ModelConfig":
        base = dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=500000.0, max_position_embeddings=8192,
        )
        base.update(overrides)
        return ModelConfig(**base)

    # gpt-oss (published shapes): alternating sliding/full attention,
    # sinks, biased clamped-SwiGLU MoE, head_dim 64. 120b: 36 layers /
    # 128 experts; 20b: 24 layers / 32 experts — both top-4.
    @staticmethod
    def gptoss_120b(**overrides) -> "ModelConfig":
        base = dict(
            vocab_size=201088, hidden_size=2880, intermediate_size=2880,
            num_layers=36, num_heads=64, num_kv_heads=8, head_dim=64,
            rope_theta=150000.0, max_position_embeddings=131072,
            num_experts=128, num_experts_per_tok=4,
            moe_intermediate_size=2880, moe_act="gptoss_clamp",
            attn_sinks=True, o_bias=True, attention_bias=True,
            layer_windows=tuple(128 if i % 2 == 0 else 0
                                for i in range(36)),
            # the published YaRN extension (4k -> 128k), with the
            # fractional correction range of truncate=False
            rope_scaling=dict(
                rope_type="yarn", factor=32.0, beta_fast=32.0,
                beta_slow=1.0, original_max_position_embeddings=4096,
                truncate=False,
            ),
        )
        base.update(overrides)
        return ModelConfig(**base)

    @staticmethod
    def gptoss_20b(**overrides) -> "ModelConfig":
        base = dict(num_layers=24, num_experts=32,
                    layer_windows=tuple(128 if i % 2 == 0 else 0
                                        for i in range(24)))
        base.update(overrides)
        return ModelConfig.gptoss_120b(**base)


#: DeepSeek-V2-Lite's published config.json
#: (huggingface.co/deepseek-ai/DeepSeek-V2-Lite, main/config.json): 27
#: layers (the first dense, 26 MoE), hidden 2048, 16 heads, MLA with
#: kv_lora_rank 512 / rope 64 / nope 128 / v 128 and no q-lora, 64 routed
#: experts top-6 plus 2 shared (width 1408), dense width 10944, vocab
#: 102400, YaRN rope at factor 40.
DEEPSEEK_V2_LITE_HF = {
    "attention_bias": False,
    "first_k_dense_replace": 1,
    "hidden_act": "silu",
    "hidden_size": 2048,
    "intermediate_size": 10944,
    "kv_lora_rank": 512,
    "max_position_embeddings": 163840,
    "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408,
    "moe_layer_freq": 1,
    "n_group": 1,
    "n_routed_experts": 64,
    "n_shared_experts": 2,
    "norm_topk_prob": False,
    "num_attention_heads": 16,
    "num_experts_per_tok": 6,
    "num_hidden_layers": 27,
    "num_key_value_heads": 16,
    "q_lora_rank": None,
    "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06,
    "rope_scaling": {
        "beta_fast": 32,
        "beta_slow": 1,
        "factor": 40,
        "mscale": 0.707,
        "mscale_all_dim": 0.707,
        "original_max_position_embeddings": 4096,
        "type": "yarn",
    },
    "rope_theta": 10000,
    "routed_scaling_factor": 1,
    "scoring_func": "softmax",
    "seq_aux": True,
    "tie_word_embeddings": False,
    "topk_group": 1,
    "topk_method": "greedy",
    "v_head_dim": 128,
    "vocab_size": 102400,
}


def deepseek_v2_lite() -> ModelConfig:
    """The ``deepseek-v2-lite-sim`` preset: DeepSeek-V2-Lite's published
    shapes through :meth:`ModelConfig.from_hf_config`."""
    return ModelConfig.from_hf_config(DEEPSEEK_V2_LITE_HF)


#: Qwen2.5-7B-Instruct's published config.json
#: (huggingface.co/Qwen/Qwen2.5-7B-Instruct, main/config.json): 28 layers,
#: hidden 3584, 28 query heads over 4 KV heads (G = 7), q/k/v biases (the
#: Qwen2 architecture), vocab 152064, a 131072-token sliding window that
#: ``use_sliding_window: false`` turns off (read as the JAX package reads
#: it: a window that masks nothing at any context up to 131072).
QWEN25_7B_HF = {
    "architectures": ["Qwen2ForCausalLM"],
    "attention_dropout": 0.0,
    "bos_token_id": 151643,
    "eos_token_id": 151645,
    "hidden_act": "silu",
    "hidden_size": 3584,
    "initializer_range": 0.02,
    "intermediate_size": 18944,
    "max_position_embeddings": 32768,
    "max_window_layers": 28,
    "model_type": "qwen2",
    "num_attention_heads": 28,
    "num_hidden_layers": 28,
    "num_key_value_heads": 4,
    "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0,
    "sliding_window": 131072,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "use_sliding_window": False,
    "vocab_size": 152064,
}

#: Qwen3-8B's published config.json (huggingface.co/Qwen/Qwen3-8B,
#: main/config.json): 36 layers, hidden 4096, 32 query heads over 8 KV
#: heads of 128, per-head q/k RMS norms, no biases, vocab 151936.
QWEN3_8B_HF = {
    "architectures": ["Qwen3ForCausalLM"],
    "attention_bias": False,
    "attention_dropout": 0.0,
    "bos_token_id": 151643,
    "eos_token_id": 151645,
    "head_dim": 128,
    "hidden_act": "silu",
    "hidden_size": 4096,
    "initializer_range": 0.02,
    "intermediate_size": 12288,
    "max_position_embeddings": 40960,
    "max_window_layers": 36,
    "model_type": "qwen3",
    "num_attention_heads": 32,
    "num_hidden_layers": 36,
    "num_key_value_heads": 8,
    "rms_norm_eps": 1e-06,
    "rope_scaling": None,
    "rope_theta": 1000000,
    "sliding_window": None,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "use_sliding_window": False,
    "vocab_size": 151936,
}

#: Mistral-7B-Instruct-v0.2's published config.json
#: (huggingface.co/mistralai/Mistral-7B-Instruct-v0.2, main/config.json):
#: 32 layers, hidden 4096, 32 query heads over 8 KV heads, no sliding
#: window, rope theta 1e6, the 32000-piece SentencePiece vocab.
MISTRAL_7B_V02_HF = {
    "architectures": ["MistralForCausalLM"],
    "attention_dropout": 0.0,
    "bos_token_id": 1,
    "eos_token_id": 2,
    "hidden_act": "silu",
    "hidden_size": 4096,
    "initializer_range": 0.02,
    "intermediate_size": 14336,
    "max_position_embeddings": 32768,
    "model_type": "mistral",
    "num_attention_heads": 32,
    "num_hidden_layers": 32,
    "num_key_value_heads": 8,
    "rms_norm_eps": 1e-05,
    "rope_theta": 1000000.0,
    "sliding_window": None,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "vocab_size": 32000,
}


#: Gemma-3-12B's published config.json (huggingface.co/google/gemma-3-12b-it,
#: main/config.json): a multimodal checkpoint whose language model sits
#: under ``text_config`` (its vision tower is not served). The file names
#: the widths that differ from ``transformers.Gemma3TextConfig``; every
#: default it leaves implicit is spelled out below them (the CPU tests hold
#: each to ``Gemma3TextConfig()``). 48 layers, hidden 3840, 16 query heads
#: over 8 KV heads of 256 (G = 2), GeGLU width 15360, vocab 262208, tied
#: embeddings; a 1024-token window on 5 of every 6 layers (40 windowed, 8
#: full), the full layers' rope at theta 1e6 with linear scaling by 8, the
#: windowed layers' at 1e4 unscaled; queries scaled by 256 ** -0.5.
GEMMA3_12B_HF = {
    "architectures": ["Gemma3ForConditionalGeneration"],
    "model_type": "gemma3",
    "torch_dtype": "bfloat16",
    "text_config": {
        "hidden_size": 3840,
        "intermediate_size": 15360,
        "model_type": "gemma3_text",
        "num_attention_heads": 16,
        "num_hidden_layers": 48,
        "num_key_value_heads": 8,
        "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
        "sliding_window": 1024,
        # Gemma3TextConfig's defaults, which the published file leaves out
        "attention_bias": False,
        "attn_logit_softcapping": None,
        "final_logit_softcapping": None,
        "head_dim": 256,
        "hidden_activation": "gelu_pytorch_tanh",
        "max_position_embeddings": 131072,
        "query_pre_attn_scalar": 256,
        "rms_norm_eps": 1e-06,
        "rope_local_base_freq": 10000.0,
        "rope_theta": 1000000.0,
        "sliding_window_pattern": 6,
        "tie_word_embeddings": True,
        "vocab_size": 262208,
    },
}


def gemma3_12b(max_position_embeddings: int = 8192) -> ModelConfig:
    """The ``gemma3-12b-sim`` preset: Gemma-3-12B's published shapes
    through :meth:`ModelConfig.from_hf_config`, the context cut from
    131072 to ``max_position_embeddings`` positions (as the other ``*-sim``
    presets; the rope keeps its published theta and linear factor)."""
    text = {**GEMMA3_12B_HF["text_config"],
            "max_position_embeddings": max_position_embeddings}
    return ModelConfig.from_hf_config({**GEMMA3_12B_HF, "text_config": text})
