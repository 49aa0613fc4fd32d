"""Weights for the port's model: a safetensors checkpoint, a JAX parameter
tree carried over, or random draws on the device.

The JAX package's tree (``dynamo_tpu/models/llama.py`` init_params) is
``embed [V, E]``, ``final_norm [E]``, optional ``lm_head [E, V]`` and one
or two stacked layer groups, ``layers`` and (DeepSeek's
first_k_dense_replace) ``dense_layers``, with projections ``[in, out]``:
the attention leaves (``wq``/``wk``/``wv``/``wo`` with Qwen2's
``bq``/``bk``/``bv`` and Qwen3's per-head ``q_norm``/``k_norm``, or MLA's
``wq`` or ``wq_a``/``q_norm``/``wq_b``, ``wkv_a``, ``kv_norm``, ``wkv_b``,
``wo``), the norms, and the FFN (dense ``w_gate``/``w_up``/``w_down``, or
MoE ``moe_gate``, ``we_*`` expert stacks and ``shared_*``). The port keeps
that exact tree (models/llama.py).

* :func:`load_llama_params` reads a HuggingFace checkpoint directory (the
  JAX package's ``models/weights.py`` loader, same families and name
  table) with the port's own safetensors reader (:class:`SafetensorsFile`:
  the header, then ``torch.frombuffer`` over a memory map; no
  ``safetensors`` import, and bf16 never passes through numpy). Each
  stacked leaf is allocated on the device in the model dtype and filled
  one layer's slice at a time, so the host never holds more than one
  checkpoint tensor.
* :func:`save_llama_params` writes the tree back under the HF names, each
  tensor in its own dtype (:func:`write_safetensors`).
* :func:`from_jax_params` carries a JAX tree over leaf for leaf: quantized
  nodes (``{"q" | "qn": codes, "s": f32}``, models/quant.py) code for code,
  int8 as ``torch.int8``, fp8 as ``torch.float8_e4m3fn`` (numpy holds
  JAX's fp8 as an ``ml_dtypes`` type that ``torch.from_numpy`` refuses, so
  its bytes pass as uint8; ``int8_native`` codes land column-major,
  ``quant.native_layout``).
* :func:`init_random_params` draws the presets' weights on the device.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .llama import _DTYPES, _dtype, check_supported, init_params
from .quant import native_layout

#: leaves kept in float32 whatever the model dtype (as in the JAX tree and
#: its loader: the gate and router biases, gpt-oss's sink logits)
_F32_LEAVES = ("moe_gate_bias", "moe_router_bias", "sinks")

# ---------------- the safetensors format ----------------

#: safetensors dtype names <-> torch dtypes (little-endian, as written)
ST_DTYPES = {
    "F32": torch.float32, "BF16": torch.bfloat16, "F16": torch.float16,
    "I8": torch.int8, "U8": torch.uint8, "F8_E4M3": torch.float8_e4m3fn,
}
_ST_NAMES = {v: k for k, v in ST_DTYPES.items()}


class SafetensorsFile:
    """One ``.safetensors`` file: an 8-byte little-endian header length,
    the JSON header (name -> dtype, shape, [begin, end) byte offsets past
    the header), then the raw tensors. :meth:`get` is a view of the
    memory-mapped bytes (copy-on-write, so the tensor is writable and the
    file is never changed); the map closes when the file object and its
    last view are dropped."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self.entries = header
        self._base = 8 + n

    def keys(self) -> list[str]:
        return list(self.entries)

    def get(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        if e["dtype"] not in ST_DTYPES:
            raise ValueError(f"{self.path}: {name} has dtype {e['dtype']}; the "
                             f"port reads {sorted(ST_DTYPES)}")
        dt = ST_DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        count = (end - begin) // dt.itemsize
        if count == 0:
            return torch.empty(e["shape"], dtype=dt)
        return torch.frombuffer(self._map, dtype=dt, count=count,
                                offset=self._base + begin).reshape(e["shape"])


def write_safetensors(path: str, tensors: dict) -> None:
    """Write ``{name: tensor}`` (any device; each in its own dtype) as one
    safetensors file, streaming one tensor at a time through the host. The
    header is padded with spaces to 8 bytes, as the reference writer
    does."""
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name "
                             f"the port writes")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    header["__metadata__"] = {"format": "pt"}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            host = t.detach().to("cpu").contiguous().reshape(-1)
            f.write(host.view(torch.uint8).numpy().data)


def _checkpoint_index(path: str) -> dict[str, str]:
    """Tensor name -> file, from ``model.safetensors.index.json`` where the
    checkpoint is sharded with one, else from every file's header."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    index_file = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_file):
        with open(index_file) as f:
            return json.load(f)["weight_map"]
    out = {}
    for fname in files:
        out.update(dict.fromkeys(SafetensorsFile(os.path.join(path, fname)).keys(),
                                 fname))
    return out


# ---------------- the checkpoint loader ----------------


def load_llama_params(path: str, cfg: ModelConfig, device=None,
                      dtype: Optional[str] = None) -> dict:
    """A HF Llama-family (Llama, Mistral, Qwen2, Qwen3, Phi-3 with full
    rotary, Mixtral, Qwen2-MoE, Qwen3-MoE, gpt-oss in bf16 / f32, not its
    MXFP4 release, Gemma-3 text or multimodal with its ``(1 + w)`` norms
    folded) or DeepSeek-V2/V3 MLA checkpoint
    directory as the port's
    parameter dictionary on ``device`` (default: the card), in ``dtype``
    (default: the model's), ``_F32_LEAVES`` in f32. The JAX package's name
    table, transposes, multimodal prefix resolution and MLA rope
    de-interleave; DeepSeek's first_k_dense_replace layers land in
    ``dense_layers``. Refuses what :func:`llama.check_supported` refuses
    before reading any tensor."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = _DTYPES[dtype or str(cfg.dtype)]
    name_to_file = _checkpoint_index(path)
    handles: dict[str, SafetensorsFile] = {}

    # multimodal checkpoints nest the language model under
    # language_model.model.* (or model.language_model.*): resolve the
    # prefix once from wherever the embedding lives
    prefix = ""
    if "model.embed_tokens.weight" not in name_to_file:
        for cand in ("language_model.", "model.language_model."):
            if (cand + "model.embed_tokens.weight" in name_to_file
                    or cand + "embed_tokens.weight" in name_to_file):
                prefix = cand
                break

    def resolve(name: str) -> str:
        """Bare name -> this checkpoint's key: the bare name (lm_head stays
        top-level), prefix + name, or prefix replacing ``model.``."""
        if not prefix or name in name_to_file:
            return name
        if prefix + name in name_to_file:
            return prefix + name
        if name.startswith("model.") and prefix + name[6:] in name_to_file:
            return prefix + name[6:]
        return name

    def has(name: str) -> bool:
        return resolve(name) in name_to_file

    def get(name: str) -> torch.Tensor:
        name = resolve(name)
        fname = name_to_file[name]
        if fname not in handles:
            handles[fname] = SafetensorsFile(os.path.join(path, fname))
        return handles[fname].get(name)

    def deinterleave_rope(w: torch.Tensor, n_head: int, d_head: int,
                          d_rope: int) -> torch.Tensor:
        """GPT-J-pair rope columns -> the half-split layout the runtime
        rotation uses, for a ``[..., n_head * d_head]`` projection: MLA
        interleaves the TRAILING d_rope dims of each head."""
        if not cfg.rope_interleave:
            return w
        v = w.reshape(*w.shape[:-1], n_head, d_head)
        perm = torch.cat([torch.arange(0, d_rope, 2), torch.arange(1, d_rope, 2)])
        v = torch.cat([v[..., : d_head - d_rope], v[..., d_head - d_rope:][..., perm]],
                      dim=-1)
        return v.reshape(w.shape)

    def fresh(t: torch.Tensor, leaf_dtype=dt) -> torch.Tensor:
        """A device copy in ``leaf_dtype``, never a view of the map."""
        return torch.empty(t.shape, dtype=leaf_dtype, device=device).copy_(t)

    def stack(fmt: str, rng, transpose: bool = True, fix=None,
              leaf_dtype=dt) -> torch.Tensor:
        """``[L, ...]`` of one leaf, allocated on the device and filled one
        layer at a time: each layer's tensor read, transposed to ``[in,
        out]``, fixed (the rope de-interleave) and copied into its slice."""
        out = None
        for li, i in enumerate(rng):
            t = get(fmt.format(i=i))
            t = t.T if transpose else t
            t = fix(t) if fix else t
            if out is None:
                out = torch.empty((len(rng),) + tuple(t.shape), dtype=leaf_dtype,
                                  device=device)
            out[li].copy_(t)
        return out

    # gemma checkpoints store their norm weights as offsets (the model
    # scales by 1 + w): the +1 is folded in at load, in f32, so every
    # rms_norm of the forward is the family-agnostic one
    norm_fix = (lambda w: w.float() + 1.0) if cfg.rms_add_unit else None

    def norm(fmt: str, rng) -> torch.Tensor:
        return stack(fmt, rng, transpose=False, fix=norm_fix)

    def attn_leaves(rng) -> dict:
        out = {"attn_norm": norm("model.layers.{i}.input_layernorm.weight", rng)}
        if cfg.post_norms:
            # gemma's sandwich norms: post_attention_layernorm is the
            # attention OUTPUT's norm here (the pre-FFN norm it names in
            # the Llama families is pre_feedforward_layernorm)
            out["attn_post_norm"] = norm(
                "model.layers.{i}.post_attention_layernorm.weight", rng)
            out["mlp_norm"] = norm(
                "model.layers.{i}.pre_feedforward_layernorm.weight", rng)
            out["mlp_post_norm"] = norm(
                "model.layers.{i}.post_feedforward_layernorm.weight", rng)
        else:
            out["mlp_norm"] = norm(
                "model.layers.{i}.post_attention_layernorm.weight", rng)
        a = "model.layers.{i}.self_attn."
        if cfg.is_mla:
            dqk, dr, H = cfg.qk_head_dim, cfg.qk_rope_head_dim, cfg.num_heads
            q_fix = lambda w: deinterleave_rope(w, H, dqk, dr)  # noqa: E731
            if cfg.q_lora_rank:
                out["wq_a"] = stack(a + "q_a_proj.weight", rng)
                out["q_norm"] = stack(a + "q_a_layernorm.weight", rng,
                                      transpose=False)
                out["wq_b"] = stack(a + "q_b_proj.weight", rng, fix=q_fix)
            else:
                out["wq"] = stack(a + "q_proj.weight", rng, fix=q_fix)
            # the rope dims are the trailing d_rope columns (one "head")
            out["wkv_a"] = stack(
                a + "kv_a_proj_with_mqa.weight", rng,
                fix=lambda w: deinterleave_rope(w, 1, cfg.kv_lora_rank + dr, dr))
            out["kv_norm"] = stack(a + "kv_a_layernorm.weight", rng,
                                   transpose=False)
            out["wkv_b"] = stack(a + "kv_b_proj.weight", rng)
            out["wo"] = stack(a + "o_proj.weight", rng)
            return out
        if has(a.format(i=rng[0]) + "qkv_proj.weight"):
            # Phi-3 fuses q/k/v ([H + 2 Hkv] * D rows, q first): each leaf
            # takes its columns
            dq, dkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
            for key, cols in (("wq", slice(0, dq)), ("wk", slice(dq, dq + dkv)),
                              ("wv", slice(dq + dkv, None))):
                out[key] = stack(a + "qkv_proj.weight", rng,
                                 fix=lambda w, c=cols: w[..., c])
            out["wo"] = stack(a + "o_proj.weight", rng)
        else:
            for key, proj in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o")):
                out[key] = stack(a + proj + "_proj.weight", rng)
        if cfg.attention_bias:  # qwen2
            for key, proj in (("bq", "q"), ("bk", "k"), ("bv", "v")):
                out[key] = stack(a + proj + "_proj.bias", rng, transpose=False)
        if cfg.qk_norm:  # qwen3, gemma-3: per-head weight [head_dim]
            out["q_norm"] = norm(a + "q_norm.weight", rng)
            out["k_norm"] = norm(a + "k_norm.weight", rng)
        if cfg.o_bias:  # gpt-oss
            out["bo"] = stack(a + "o_proj.bias", rng, transpose=False)
        if cfg.attn_sinks:  # gpt-oss: per-head sink logits, f32
            out["sinks"] = stack(a + "sinks", rng, transpose=False,
                                 leaf_dtype=torch.float32)
        return out

    def dense_ffn_leaves(rng) -> dict:
        m = "model.layers.{i}.mlp."
        if has(m.format(i=rng[0]) + "gate_up_proj.weight"):
            # Phi-3's fused gate_up ([2F, E] rows: gate, then up)
            F = cfg.intermediate_size
            return {"w_gate": stack(m + "gate_up_proj.weight", rng,
                                    fix=lambda w: w[..., :F]),
                    "w_up": stack(m + "gate_up_proj.weight", rng,
                                  fix=lambda w: w[..., F:]),
                    "w_down": stack(m + "down_proj.weight", rng)}
        return {"w_gate": stack(m + "gate_proj.weight", rng),
                "w_up": stack(m + "up_proj.weight", rng),
                "w_down": stack(m + "down_proj.weight", rng)}

    def gptoss_moe_leaves(rng) -> dict:
        """gpt-oss stores each layer's experts FUSED: ``gate_up_proj [X, E,
        2F]`` with gate and up INTERLEAVED on the last axis (gate ``[...,
        ::2]``, up ``[..., 1::2]``) and its bias ``[X, 2F]``, ``down_proj
        [X, F, E]`` (already ``[in, out]``) and its bias ``[X, E]``; the
        router is ``mlp.router`` with a logit bias."""
        m = "model.layers.{i}.mlp."
        e = m + "experts."
        out = {"moe_gate": stack(m + "router.weight", rng),
               "moe_router_bias": stack(m + "router.bias", rng, transpose=False,
                                        leaf_dtype=torch.float32)}
        for key, name, cols in (
                ("we_gate", "gate_up_proj", slice(0, None, 2)),
                ("we_up", "gate_up_proj", slice(1, None, 2)),
                ("be_gate", "gate_up_proj_bias", slice(0, None, 2)),
                ("be_up", "gate_up_proj_bias", slice(1, None, 2)),
                ("we_down", "down_proj", slice(None)),
                ("be_down", "down_proj_bias", slice(None))):
            out[key] = stack(e + name, rng, transpose=False,
                             fix=lambda w, c=cols: w[..., c])
        return out

    def moe_ffn_leaves(rng) -> dict:
        if cfg.moe_act == "gptoss_clamp":
            return gptoss_moe_leaves(rng)
        X = cfg.num_experts

        def experts(mix: str, ds: str) -> torch.Tensor:
            """``[L, X, in, out]`` from per-expert tensors: Mixtral
            (block_sparse_moe.experts.N.w1/w3/w2) or DeepSeek/Qwen-MoE
            (mlp.experts.N.gate/up/down_proj) naming."""
            out = None
            for li, i in enumerate(rng):
                fmt = mix if has(mix.format(i=i, x=0)) else ds
                for x in range(X):
                    t = get(fmt.format(i=i, x=x)).T
                    if out is None:
                        out = torch.empty((len(rng), X) + tuple(t.shape),
                                          dtype=dt, device=device)
                    out[li, x].copy_(t)
            return out

        gate_mix = "model.layers.{i}.block_sparse_moe.gate.weight"
        gate_ds = "model.layers.{i}.mlp.gate.weight"
        out = {
            "moe_gate": stack(gate_mix if has(gate_mix.format(i=rng[0]))
                              else gate_ds, rng),
            "we_gate": experts(
                "model.layers.{i}.block_sparse_moe.experts.{x}.w1.weight",
                "model.layers.{i}.mlp.experts.{x}.gate_proj.weight"),
            "we_up": experts(
                "model.layers.{i}.block_sparse_moe.experts.{x}.w3.weight",
                "model.layers.{i}.mlp.experts.{x}.up_proj.weight"),
            "we_down": experts(
                "model.layers.{i}.block_sparse_moe.experts.{x}.w2.weight",
                "model.layers.{i}.mlp.experts.{x}.down_proj.weight"),
        }
        if cfg.moe_gate_bias:
            out["moe_gate_bias"] = stack(
                "model.layers.{i}.mlp.gate.e_score_correction_bias", rng,
                transpose=False, leaf_dtype=torch.float32)
        if cfg.num_shared_experts:
            # DeepSeek writes plural "shared_experts", Qwen2-MoE singular
            plural = "model.layers.{i}.mlp.shared_experts"
            base = (plural if has(plural.format(i=rng[0]) + ".gate_proj.weight")
                    else "model.layers.{i}.mlp.shared_expert")
            for key, proj in (("shared_gate", "gate"), ("shared_up", "up"),
                              ("shared_down", "down")):
                out[key] = stack(base + f".{proj}_proj.weight", rng)
            if cfg.shared_expert_gate:  # qwen2moe: [1, E] -> [E, 1]
                out["shared_egate"] = stack(
                    "model.layers.{i}.mlp.shared_expert_gate.weight", rng)
        return out

    kd = cfg.first_dense_layers if cfg.is_moe else 0
    rng = range(kd, cfg.num_layers)
    layers = attn_leaves(rng)
    layers.update(moe_ffn_leaves(rng) if cfg.is_moe else dense_ffn_leaves(rng))
    final_norm = get("model.norm.weight")
    params = {
        "embed": fresh(get("model.embed_tokens.weight")),
        "final_norm": fresh(norm_fix(final_norm) if norm_fix else final_norm),
        "layers": layers,
    }
    if kd:
        dense = attn_leaves(range(kd))
        dense.update(dense_ffn_leaves(range(kd)))
        params["dense_layers"] = dense
    if not cfg.tie_word_embeddings:
        params["lm_head"] = fresh(get("lm_head.weight").T)
    # every leaf is a copy: the maps close once their last view is dropped
    handles.clear()
    return params


# ---------------- the checkpoint saver ----------------

#: leaf -> (HF name, stored transposed): the JAX package's save table, plus
#: Qwen2's q/k/v biases
_HF_NAMES = {
    "attn_norm": ("model.layers.{i}.input_layernorm.weight", False),
    "wq": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{i}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "bq": ("model.layers.{i}.self_attn.q_proj.bias", False),
    "bk": ("model.layers.{i}.self_attn.k_proj.bias", False),
    "bv": ("model.layers.{i}.self_attn.v_proj.bias", False),
    "mlp_norm": ("model.layers.{i}.post_attention_layernorm.weight", False),
    "w_gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{i}.mlp.down_proj.weight", True),
    # MLA (models/mla.py)
    "wq_a": ("model.layers.{i}.self_attn.q_a_proj.weight", True),
    "q_norm": ("model.layers.{i}.self_attn.q_a_layernorm.weight", False),
    "wq_b": ("model.layers.{i}.self_attn.q_b_proj.weight", True),
    "wkv_a": ("model.layers.{i}.self_attn.kv_a_proj_with_mqa.weight", True),
    "kv_norm": ("model.layers.{i}.self_attn.kv_a_layernorm.weight", False),
    "wkv_b": ("model.layers.{i}.self_attn.kv_b_proj.weight", True),
    "moe_gate_bias": ("model.layers.{i}.mlp.gate.e_score_correction_bias", False),
    "k_norm": ("model.layers.{i}.self_attn.k_norm.weight", False),
}
#: the norm leaves a gemma checkpoint stores as offsets from 1
_NORM_LEAVES = ("final_norm", "attn_norm", "mlp_norm", "attn_post_norm",
                "mlp_post_norm", "q_norm", "k_norm")


def save_llama_params(path: str, params: dict, cfg: Optional[ModelConfig] = None) -> None:
    """Write a parameter dictionary (any device) to ``path/model.safetensors``
    under the HF names the loader reads, each tensor in its own dtype (the
    JAX package's ``save_llama_params`` writes f32): dense layers, Mixtral
    expert naming, DeepSeek's plural shared experts or Qwen2-MoE's gated
    singular one, Qwen3's per-head norms where ``cfg.qk_norm``, and
    gemma's sandwich norm names with every norm stored as its offset ``w -
    1`` (the JAX package's saver leaves the per-head q/k norms folded,
    ROADMAP C.12)."""
    if cfg is not None and cfg.rope_interleave:
        raise NotImplementedError(
            "saving back to the interleaved-rope checkpoint convention is not "
            "supported (the loader de-interleaved at load)")
    names = dict(_HF_NAMES)
    if cfg is not None and cfg.qk_norm:
        # "q_norm" is MLA's q_a_layernorm or Qwen3's per-head q norm
        names["q_norm"] = ("model.layers.{i}.self_attn.q_norm.weight", False)
    if cfg is not None and cfg.post_norms:  # gemma's sandwich norm names
        names["mlp_norm"] = ("model.layers.{i}.pre_feedforward_layernorm.weight",
                             False)
        names["attn_post_norm"] = (
            "model.layers.{i}.post_attention_layernorm.weight", False)
        names["mlp_post_norm"] = (
            "model.layers.{i}.post_feedforward_layernorm.weight", False)
    offsets = cfg is not None and cfg.rms_add_unit

    def unfold(key: str, t: torch.Tensor) -> torch.Tensor:
        """The inverse of the loader's (1 + w) fold for a gemma norm
        (every one of them, the per-head q/k norms too), in f32 and back
        to the leaf's dtype."""
        if offsets and key in _NORM_LEAVES:
            return (t.float() - 1.0).to(t.dtype)
        return t

    flat = {"model.embed_tokens.weight": params["embed"],
            "model.norm.weight": unfold("final_norm", params["final_norm"])}

    def save_group(lay: dict, off: int) -> None:
        n = next(iter(lay.values())).shape[0]
        for key, (fmt, transpose) in names.items():
            for li in range(n) if key in lay else ():
                t = unfold(key, lay[key][li])
                flat[fmt.format(i=off + li)] = t.T if transpose else t
        if "we_gate" not in lay:
            return
        experts = {"we_gate": "w1", "we_up": "w3", "we_down": "w2"}
        sbase = ("model.layers.{i}.mlp.shared_expert" if "shared_egate" in lay
                 else "model.layers.{i}.mlp.shared_experts")
        shared = {"shared_gate": sbase + ".gate_proj.weight",
                  "shared_up": sbase + ".up_proj.weight",
                  "shared_down": sbase + ".down_proj.weight",
                  "shared_egate": "model.layers.{i}.mlp.shared_expert_gate.weight"}
        for li in range(n):
            i = off + li
            flat[f"model.layers.{i}.block_sparse_moe.gate.weight"] = lay["moe_gate"][li].T
            for key, w in experts.items():
                for x in range(lay[key].shape[1]):
                    flat[f"model.layers.{i}.block_sparse_moe.experts.{x}.{w}.weight"] = (
                        lay[key][li, x].T)
            for key, fmt in shared.items():
                if key in lay:
                    flat[fmt.format(i=i)] = lay[key][li].T

    kd = 0
    if "dense_layers" in params:
        kd = next(iter(params["dense_layers"].values())).shape[0]
        save_group(params["dense_layers"], 0)
    save_group(params["layers"], kd)
    if "lm_head" in params:
        flat["lm_head.weight"] = params["lm_head"].T
    write_safetensors(os.path.join(path, "model.safetensors"), flat)


# ---------------- a JAX tree, or random draws ----------------


def _codes(x, device) -> torch.Tensor:
    """Quantized codes, bit for bit: int8 as int8, fp8 e4m3 by its bytes."""
    a = np.asarray(x)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy()).to(device)
    if a.dtype.itemsize == 1 and "float8_e4m3" in str(a.dtype):
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn).to(device)
    raise ValueError(f"quantized codes of dtype {a.dtype} are not supported")


def _leaf(x, dtype: torch.dtype, device):
    if isinstance(x, dict):  # a quantized node: codes + f32 scales
        return {k: (_leaf(v, torch.float32, device) if k == "s"
                    else native_layout(_codes(v, device)) if k == "qn"
                    else _codes(v, device)) for k, v in x.items()}
    # numpy has no bfloat16: widen to f32 on the host, narrow on the way in
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device=device, dtype=dtype
    )


def from_jax_params(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """The JAX parameter tree (leaves as numpy arrays) as the port's
    parameter dictionary on ``device``, in the model's dtype: every layer
    group and every leaf."""
    check_supported(cfg)
    dt = _dtype(cfg)
    params = {
        "embed": _leaf(tree["embed"], dt, device),
        "final_norm": _leaf(tree["final_norm"], dt, device),
    }
    for group in ("layers", "dense_layers"):
        if group in tree:
            params[group] = {
                k: _leaf(v, torch.float32 if k in _F32_LEAVES else dt, device)
                for k, v in tree[group].items()
            }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _leaf(tree["lm_head"], dt, device)
    return params


def init_random_params(cfg: ModelConfig, generator: torch.Generator,
                       device="cuda") -> dict:
    """Random weights drawn directly on ``device`` (normal x 0.02, norms
    at 1): the presets' bf16 weights (16 GB for ``llama3-8b-sim``, 31 GB
    for ``deepseek-v2-lite-sim``) never touch the host."""
    return init_params(cfg, generator, device)
