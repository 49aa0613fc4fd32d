"""Weights for the port's model: carried over from a JAX parameter tree, or
drawn at random on the device.

The JAX package's tree (``dynamo_tpu/models/llama.py`` init_params) is
``embed [V, E]``, ``final_norm [E]``, optional ``lm_head [E, V]`` and
``layers.{attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down}``
stacked ``[L, ...]`` with projections ``[in, out]``; the port keeps that
exact tree (models/llama.py), so carrying weights over is a dtype and
device move per leaf. A safetensors checkpoint loader is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .llama import _dtype, check_supported, init_params

_LAYER_KEYS = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo",
               "w_gate", "w_up", "w_down")


def _leaf(x, dtype: torch.dtype, device) -> torch.Tensor:
    # numpy has no bfloat16: widen to f32 on the host, narrow on the way in
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device=device, dtype=dtype
    )


def from_jax_params(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """The JAX parameter tree (leaves as numpy arrays) as the port's
    parameter dictionary on ``device``, in the model's dtype."""
    check_supported(cfg)
    dt = _dtype(cfg)
    layers = tree["layers"]
    missing = [k for k in _LAYER_KEYS if k not in layers]
    if missing:
        raise ValueError(f"JAX layer tree lacks {missing}")
    params = {
        "embed": _leaf(tree["embed"], dt, device),
        "final_norm": _leaf(tree["final_norm"], dt, device),
        "layers": {k: _leaf(layers[k], dt, device) for k in _LAYER_KEYS},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _leaf(tree["lm_head"], dt, device)
    return params


def init_random_params(cfg: ModelConfig, generator: torch.Generator,
                       device="cuda") -> dict:
    """Random weights drawn directly on ``device`` (normal x 0.02, norms
    at 1): the ``llama3-8b-sim`` preset's 16 GB of bf16 weights never
    touch the host."""
    return init_params(cfg, generator, device)
