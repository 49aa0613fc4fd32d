"""Per-block KV quantization codec for the offload tiers.

A copy of ``dynamo_tpu/engine/kvquant.py`` over ``torch`` tensors (host
entries of bf16 or e4m3 pages cannot be numpy arrays without
``ml_dtypes``). The codes and the f32 scales are byte for byte the
reference's:

    scale[l, b] = max(max(|x[l, :, b, :, :]|) / qmax, 1e-12)   (f32)
    q[l, h, b, :, :] = x / scale[l, b]   -> int8: rint, clip to +-127
                                         -> fp8:  float8_e4m3fn cast

one scale per (layer, block) per K/V, ``qmax`` 127 (int8) or 448 (scaled
e4m3). The e4m3 cast is ``models/quant.to_e4m3``, which stores what the
reference's ``ml_dtypes`` cast stores (round to nearest even, NaN for
``|x| > 464``, +-inf and NaN); in range the codec never comes near those
edges, because the scale maps each block's absmax to 448.

The int8 DEVICE cache (``kv_cache_dtype="int8"``) keeps its per-(layer,
page) scale planes at exactly this granularity and qmax, so an int8 device
cache and an int8 tier exchange blocks verbatim (payload and scales
adopted); any other tier codec re-encodes from the device scales, counted
in ``kv_device_export_requant_total``.

The tier round trip is not bit-exact, so :func:`measure_logprob_drift`
ships beside the codec: greedy agreement and chosen-token logprob drift
against a full-width engine; ``--kv-quant`` defaults to ``"none"``.
"""

from __future__ import annotations

import torch

from ..models.quant import to_e4m3

#: tier KV codec modes (EngineConfig.kv_quant / --kv-quant)
KV_QUANT_MODES = ("none", "int8", "fp8")

_EPS = 1e-12


def quant_dtype(mode: str) -> torch.dtype:
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"kv_quant must be one of {KV_QUANT_MODES[1:]}, got {mode!r}")


def _qmax(mode: str) -> float:
    return 127.0 if mode == "int8" else 448.0


def _expand(scale: torch.Tensor, axes: tuple) -> torch.Tensor:
    for a in sorted(axes):
        scale = scale.unsqueeze(a)
    return scale


def _quantize(x: torch.Tensor, axes: tuple, mode: str):
    """Absmax over ``axes`` (everything but layer + block), one scale per
    remaining (layer[, block]) coordinate."""
    dt, qmax = quant_dtype(mode), _qmax(mode)
    xf = x.float()
    scale = torch.clamp_min(torch.amax(xf.abs(), dim=axes) / qmax, _EPS)
    q = xf / _expand(scale, axes)
    if mode == "int8":
        q = torch.clamp(torch.round(q), -127, 127).to(dt)
    else:
        q = to_e4m3(q)
    return q.contiguous(), scale.contiguous()


def quantize_stack(k: torch.Tensor, v: torch.Tensor, mode: str):
    """Quantize a block stack pair ([L, H, n, bs, D] each; k and v may
    have different H/D: MLA latents). Returns (qk, qv, ks, vs) with scales
    [L, n] f32."""
    qk, ks = _quantize(k, (1, 3, 4), mode)
    qv, vs = _quantize(v, (1, 3, 4), mode)
    return qk, qv, ks, vs


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return to_e4m3(x) if dtype == torch.float8_e4m3fn else x.to(dtype)


def dequantize_stack(qk, qv, ks, vs, dtype: torch.dtype):
    """Invert :func:`quantize_stack` back to full-width ``dtype``."""
    k = qk.float() * ks.float()[:, None, :, None, None]
    v = qv.float() * vs.float()[:, None, :, None, None]
    return _cast(k, dtype), _cast(v, dtype)


def quantize_entry(k: torch.Tensor, v: torch.Tensor, mode: str):
    """Quantize ONE block ([L, H, bs, D] pair), the host-pool / disk entry
    form. Scales are [L] f32 per K/V."""
    qk, ks = _quantize(k, (1, 2, 3), mode)
    qv, vs = _quantize(v, (1, 2, 3), mode)
    return qk, qv, ks, vs


def dequantize_entry(qk, qv, ks, vs, dtype: torch.dtype):
    k = qk.float() * ks.float()[:, None, None, None]
    v = qv.float() * vs.float()[:, None, None, None]
    return _cast(k, dtype), _cast(v, dtype)


def entry_nbytes(entry: tuple) -> int:
    """Bytes one pool/staging entry occupies (payload + any scale vectors):
    the unit of the tiers' byte budgets."""
    n = entry[0].nbytes + entry[1].nbytes
    if len(entry) > 2 and entry[2] is not None:
        n += entry[2].nbytes + entry[3].nbytes
    return n


def wire_block_bytes(block_bytes: int, itemsize: int, layers: int,
                     mode: str) -> int:
    """Bytes ONE block costs on the tier planes under ``mode``: the payload
    at 1 byte per element plus the per-layer f32 scale pair; the full-width
    ``block_bytes`` without a codec."""
    if mode in (None, "none"):
        return int(block_bytes)
    elems = block_bytes // max(itemsize, 1)
    return int(elems * quant_dtype(mode).itemsize + 2 * layers * 4)


# ---------------- logprob-drift harness (the quality gate) ----------------


async def measure_logprob_drift(
    ref_engine,
    quant_engine,
    prompts: list,
    max_tokens: int = 16,
    park=None,
    stat_key: str = "kv_quant_logprob_drift_max",
) -> dict:
    """Greedy-token agreement + chosen-token logprob drift of a quantized
    engine against a full-width reference, on a fixed prompt set (the
    reference's protocol: the reference engine serves each prompt cold;
    the quantized engine serves it once, ``park(quant_engine, prompt)``
    churns the prefix into the quantized tiers, and the second serve,
    restored through the codec, is the stream compared). The max drift is
    recorded on the quantized engine's ``stats[stat_key]``."""
    from ..protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from ..runtime.engine import Context

    def req(toks):
        return PreprocessedRequest(
            token_ids=list(toks),
            stop_conditions=StopConditions(max_tokens=max_tokens,
                                           ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0, seed=0,
                                             logprobs=0),
            eos_token_ids=[],
        )

    async def serve(engine, toks):
        out_toks, out_lps = [], []
        async for o in engine.generate(Context(req(toks))):
            out_toks.extend(o.token_ids)
            for lp in o.logprobs or []:
                out_lps.append(float(lp["logprob"]))
        return out_toks, out_lps

    agree = total = 0
    deltas: list[float] = []
    for toks in prompts:
        ref_toks, ref_lps = await serve(ref_engine, toks)
        await serve(quant_engine, toks)  # populate the quantized tiers
        if park is not None:
            await park(quant_engine, toks)
        q_toks, q_lps = await serve(quant_engine, toks)
        n = min(len(ref_toks), len(q_toks))
        total += n
        agree += sum(1 for i in range(n) if ref_toks[i] == q_toks[i])
        deltas.extend(abs(a - b) for a, b in zip(ref_lps, q_lps))
    drift_max = max(deltas) if deltas else 0.0
    result = {
        "n_prompts": len(prompts),
        "n_tokens": total,
        "greedy_agreement": round(agree / total, 6) if total else 1.0,
        "logprob_delta_max": round(drift_max, 6),
        "logprob_delta_mean": (
            round(sum(deltas) / len(deltas), 6) if deltas else 0.0
        ),
    }
    stats = getattr(quant_engine, "stats", None)
    if stats is not None:
        stats[stat_key] = max(float(stats.get(stat_key, 0.0)), drift_max)
    return result
