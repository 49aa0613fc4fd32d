"""Weights for the port's model: carried over from a JAX parameter tree, or
drawn at random on the device.

The JAX package's tree (``dynamo_tpu/models/llama.py`` init_params) is
``embed [V, E]``, ``final_norm [E]``, optional ``lm_head [E, V]`` and one
or two stacked layer groups, ``layers`` and (DeepSeek's
first_k_dense_replace) ``dense_layers``, with projections ``[in, out]``:
the attention leaves (``wq``/``wk``/``wv``/``wo``, or MLA's ``wq`` or
``wq_a``/``q_norm``/``wq_b``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``),
the norms, and the FFN (dense ``w_gate``/``w_up``/``w_down``, or MoE
``moe_gate``, ``we_*`` expert stacks and ``shared_*``). The port keeps that
exact tree (models/llama.py), so carrying weights over is a dtype and
device move per leaf. Quantized nodes (``{"q" | "qn": codes, "s": f32}``,
models/quant.py) carry over code for code: int8 as ``torch.int8``, fp8 as
``torch.float8_e4m3fn`` (numpy holds JAX's fp8 as an ``ml_dtypes`` type
that ``torch.from_numpy`` refuses, so its bytes pass as uint8;
``int8_native`` codes land column-major, ``quant.native_layout``). A
safetensors checkpoint loader is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .llama import _dtype, check_supported, init_params
from .quant import native_layout

#: leaves kept in float32 whatever the model dtype (as in the JAX tree)
_F32_LEAVES = ("moe_gate_bias",)


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
