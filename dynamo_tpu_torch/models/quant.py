"""Post-training weight quantization and the KV-cache dtypes (PyTorch).

Counterpart of ``dynamo_tpu/models/quant.py`` (which imports JAX, so the
port keeps its own copy). Decode streams every weight from device memory
once per step, so int8/fp8 storage halves its bytes against bf16.

Scheme: symmetric per-output-channel absmax scaling over the contraction
axis. A quantized weight is a ``{"q": int8|float8_e4m3fn [..., in, out],
"s": f32 [..., out]}`` node (``"qn"`` instead of ``"q"`` for
``int8_native``, which routes ``llama._mm`` onto an int8 x int8 product;
its codes are stored column-major, the layout the card's int8 product
reads, so no call relays them);
MoE expert stacks quantize the same way (``[L, X, in, out]``, scales ``[L,
X, out]``) and ride the hand-written grouped kernel
``ops/moe_gmm.ragged_int8_gmm``. The op order is the reference's
(``absmax / qmax``, floor 1e-12, ``w / scale``, round half to even, clip),
so the codes and scales come out bit-identical to the JAX package's.

The KV cache dtypes: ``model`` and ``bfloat16`` store K/V at that width;
``int8`` is the int8-with-scales device cache (one f32 absmax scale per
(layer, physical page) for K and for V, kept in ``[L, N]`` planes beside
the caches; ``ops/kv_cache_update.kv_cache_append_quantized``);
``float8_e4m3`` is the scale-free ``float8_e4m3fn`` cache (GQA and MLA): every
write casts with :func:`to_e4m3`, every read widens the codes exactly.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import ModelConfig

WEIGHT_MODES = ("none", "int8", "fp8_e4m3", "int8_native")
KV_CACHE_DTYPES = ("model", "float8_e4m3", "bfloat16", "int8")

#: floor for every KV scale plane entry: a freshly reset page's scale
KV_SCALE_EPS = 1e-12
#: int8 symmetric range of the device KV planes
KV_INT8_QMAX = 127.0

# stacked-layer projection matrices worth quantizing ([L, in, out],
# contraction on axis -2); embeddings, norms, biases and the router stay at
# the model dtype
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "shared_gate", "shared_up", "shared_down",
               # MLA projections (mla._wkv_b_parts dequantizes wkv_b for
               # the absorbed fold; the rest ride _mm)
               "wq_a", "wq_b", "wkv_a", "wkv_b")
# expert stacks ([L, X, in, out])
_EXPERT_QUANT_KEYS = ("we_gate", "we_up", "we_down")


def _qdtype(mode: str):
    if mode in ("int8", "int8_native"):
        return torch.int8, 127.0
    if mode == "fp8_e4m3":
        return torch.float8_e4m3fn, 448.0
    raise ValueError(f"unknown quantization mode {mode!r}")


def native_layout(codes: torch.Tensor) -> torch.Tensor:
    """``int8_native`` codes ``[..., in, out]`` stored column-major in
    each matrix (strides ``(..., 1, in)``): cuBLASLt's int8 product, which
    ``torch._int_mm`` calls on the card, takes its second operand so."""
    return codes.mT.contiguous().mT


def _quantize_matrix(w: torch.Tensor, mode: str) -> dict:
    dt, qmax = _qdtype(mode)
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp_min(absmax / qmax, 1e-12)
    q = wf / scale
    if mode == "int8":
        q = torch.clamp(torch.round(q), -127, 127)
    return {"q": q.to(dt), "s": scale.squeeze(-2).float()}


def quantize_array(w: torch.Tensor, mode: str) -> dict:
    """Symmetric per-output-channel quantization of a ``[..., in, out]``
    weight: scale = absmax over the contraction axis / the dtype's max.
    A stacked weight quantizes one leading slice at a time (the same
    numbers; the f32 temporaries stay one matrix's size)."""
    base = "int8" if mode == "int8_native" else mode  # the same codes
    if w.dim() > 2:
        parts = [quantize_array(w[i], base) for i in range(w.shape[0])]
        out = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    else:
        out = _quantize_matrix(w, base)
    if mode == "int8_native":
        return {"qn": native_layout(out["q"]), "s": out["s"]}
    return out


def dequantize_array(qw: dict) -> torch.Tensor:
    q = qw["qn"] if "qn" in qw else qw["q"]
    return q.float() * qw["s"][..., None, :]


def quantize_params(params: dict, cfg: ModelConfig, mode: Optional[str]) -> dict:
    """Quantize the projection weights and the MoE expert stacks of a
    parameter dictionary (a new dictionary; leaves that stay are shared).
    ``int8_native`` covers the dense projections only: expert stacks take
    the ``"q"`` form the grouped kernel reads."""
    if mode in (None, "none"):
        return params
    if mode not in WEIGHT_MODES:
        raise ValueError(f"quantization must be one of {WEIGHT_MODES}")
    if cfg.moe_act == "gptoss_clamp":
        raise NotImplementedError(
            f"quantization={mode!r} on gpt-oss is not ported yet (its expert "
            "biases beside the quantized grouped GEMM have no test against "
            "the reference): see ROADMAP.md A.6"
        )
    keys = _QUANT_KEYS + _EXPERT_QUANT_KEYS
    out = dict(params)
    for grp in ("layers", "dense_layers"):
        if grp not in params:
            continue
        layers = dict(params[grp])
        for key in keys:
            if key in layers and not isinstance(layers[key], dict):
                kmode = ("int8" if mode == "int8_native"
                         and key in _EXPERT_QUANT_KEYS else mode)
                layers[key] = quantize_array(layers[key], kmode)
        out[grp] = layers
    return out


def kv_cache_dtype(cfg: ModelConfig, name: Optional[str]) -> Optional[torch.dtype]:
    """An ``EngineConfig.kv_cache_dtype`` name as a torch dtype (None = the
    model's own dtype)."""
    if name in (None, "model"):
        return None
    if name == "bfloat16":
        return torch.bfloat16
    if name == "int8":
        return torch.int8
    if name == "float8_e4m3":
        # GQA and MLA alike: the latent kernels read fp8 pages too
        return torch.float8_e4m3fn
    raise ValueError(f"kv_cache_dtype must be one of {KV_CACHE_DTYPES}")


#: the largest |x| that the reference's cast keeps finite: above it
#: ``astype(float8_e4m3fn)`` rounds to 480, which e4m3fn spells NaN
E4M3_FINITE_MAX = 464.0
_E4M3_NAN = 0x7F  # with the sign bit: 0xFF


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32 or bf16) as ``float8_e4m3fn``, byte for byte what the JAX
    package's ``x.astype(jnp.float8_e4m3fn)`` stores: round to nearest
    even, subnormals and signed zeros kept, and NaN (0x7F, 0xFF with the
    sign) for every ``|x| > 464``, for +-inf and for NaN. PyTorch's own
    cast agrees except there: it saturates those to +-448 (0x7E / 0xFE),
    and so does the card's ``cvt.rn.satfinite``; either way its byte keeps
    x's sign, so setting the low seven bits gives the reference's NaN. No
    host sync."""
    xf = x.float()
    codes = xf.to(torch.float8_e4m3fn).view(torch.uint8)
    return torch.where(xf.abs() <= E4M3_FINITE_MAX, codes,
                       codes | _E4M3_NAN).view(torch.float8_e4m3fn)


def store_codes(cache: torch.Tensor, rows: torch.Tensor):
    """``(target, values)`` for an ``index_put_`` of ``rows`` into
    ``cache``: an fp8 cache through its bytes with the rows cast by
    :func:`to_e4m3`, any other cache as it is with the rows cast to its
    dtype."""
    if cache.dtype == torch.float8_e4m3fn:
        return cache.view(torch.uint8), to_e4m3(rows).view(torch.uint8)
    return cache, rows.to(cache.dtype)
