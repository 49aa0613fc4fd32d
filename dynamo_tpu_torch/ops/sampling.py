"""Batched token sampling on the device (PyTorch).

Counterpart of ``dynamo_tpu/ops/sampling.py``: temperature / top-k / top-p
/ greedy for a whole decode batch with per-request parameters as vectors,
sampling penalties, and logprobs.

Randomness reproduces the JAX package bit for bit: each draw is keyed on
``fold_in(key(seed), step)`` and drawn as ``jax.random.categorical``
(argmax of the logits plus Gumbel noise from ``jax.random.uniform``), with
JAX's default threefry2x32 generator in its partitionable form. The
threefry hash is ported as plain integer tensor ops (uint32 values held in
int64 tensors), batched over rows, on the tensor's device. Greedy rows are
exact too: ``torch.argmax`` and ``jnp.argmax`` both return the first
maximum.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
TOPK_LOGPROBS = 20  # OpenAI's top_logprobs cap; the host slices per-request

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds, JAX's ``threefry2x32_p``) on
    uint32 values held in int64 tensors, broadcast together. Returns the
    two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def make_keys(seeds, steps, device="cpu") -> torch.Tensor:
    """``[..., 2]`` key data, uint32 values in int64:
    ``key_data(fold_in(key(seed), step))`` per (seed, step) pair, the two
    broadcast together. ``key(seed)`` of an int32 seed is ``[0, seed]``;
    folding in ``step`` hashes the counter pair ``(0, step)`` under that
    key. Host sequences hash on the host and move to ``device``; tensors
    hash on their own device (``device`` unused), so a captured CUDA graph
    computes each replay's keys from the values then in ``seeds`` and
    ``steps``."""
    if torch.is_tensor(seeds):
        seed = seeds.to(torch.int64) & _M32
        step = torch.as_tensor(steps, device=seeds.device).to(torch.int64) & _M32
    else:
        seed = torch.as_tensor([int(s) & _M32 for s in seeds], dtype=torch.int64)
        step = torch.as_tensor([int(s) & _M32 for s in steps], dtype=torch.int64)
    seed, step = torch.broadcast_tensors(seed, step)
    k1, k2 = threefry2x32(torch.zeros_like(seed), seed,
                          torch.zeros_like(step), step)
    keys = torch.stack([k1, k2], dim=-1)
    return keys if torch.is_tensor(seeds) else keys.to(device)


def _uniform(keys: torch.Tensor, V: int, device) -> torch.Tensor:
    """``jax.random.uniform(key, (V,), minval=tiny, maxval=1)`` per row of
    ``keys [B, 2]``: the row's bits are the hash of the counter pairs
    ``(0, i)``, XORed; 23 of them fill a float in [1, 2)."""
    keys = keys.to(device)
    i = torch.arange(V, dtype=torch.int64, device=device)[None, :]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(i), i)
    bits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    floats = bits.view(torch.float32) - 1.0
    return torch.clamp_min(floats * (1.0 - _F32_TINY) + _F32_TINY, _F32_TINY)


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    keys: Optional[torch.Tensor],  # [B, 2] key data (make_keys); None = all greedy
    temperature: torch.Tensor,  # [B] 0 => greedy
    top_k: torch.Tensor,  # [B] 0 => disabled
    top_p: torch.Tensor,  # [B] 1.0 => disabled
    filtered: Optional[bool] = None,  # any top-k / top-p row; None = read it
) -> torch.Tensor:  # [B] int32
    """An all-greedy batch (``keys`` None: callers that know every
    temperature is 0 make no keys) is one argmax and never waits for the
    card; a filter-free sampled batch skips the full-vocab sort; sampled
    rows draw ``jax.random.categorical``: the argmax of Gumbel noise plus
    the temperature-scaled logits. ``filtered`` says whether any row of
    ``top_k`` / ``top_p`` filters; callers that know it (the engine, from
    its host arrays) spare the read of the card, which a captured step
    cannot make."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if keys is None:
        return greedy
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    if filtered is None:
        filtered = bool(((top_k > 0) | (top_p < 1.0)).any())
    if filtered:
        scaled = _apply_topk_topp(scaled, top_k, top_p)
    sampled = _categorical(keys, scaled)
    return torch.where(temperature <= 0.0, greedy, sampled)


def _categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, row)`` per row of ``logits [R, V]``
    under ``keys [R, 2]``: the argmax of Gumbel noise plus the logits."""
    gumbel = -torch.log(-torch.log(_uniform(keys, logits.shape[-1], logits.device)))
    return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)


def _uniform_scalar(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)`` (shape ``()``, minval 0, maxval 1) per
    key of ``keys [..., 2]``: the hash of the counter pair ``(0, 0)``,
    XORed, 23 bits filling a float in [1, 2), minus 1. Unlike
    :func:`_uniform` (the Gumbel draw's ``minval=tiny``) nothing is
    rescaled or clamped: 0 is a possible draw."""
    zero = torch.zeros_like(keys[..., 0])
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], zero, zero)
    bits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def _apply_topk_topp(
    scaled: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor
) -> torch.Tensor:
    """Mask temperature-scaled logits to the top-k / nucleus support."""
    V = scaled.shape[-1]
    kth = torch.where(top_k > 0, top_k.clamp(max=V), V).long()  # [B]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth_val = torch.gather(sorted_desc, 1, (kth - 1)[:, None])
    scaled = torch.where(scaled < kth_val, NEG_INF, scaled)
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    inside = cum - probs_sorted < top_p[:, None]
    thresh = torch.where(inside, sorted_desc, float("inf")).amin(-1, keepdim=True)
    return torch.where(scaled < thresh, NEG_INF, scaled)


def filtered_dist(
    logits: torch.Tensor,  # [B, V] float32
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
) -> torch.Tensor:
    """The exact masked/temperature-scaled logits sample_tokens draws from
    (speculative acceptance scores proposals against the SAME distribution
    the plain sampler uses)."""
    return _apply_topk_topp(logits / temperature.clamp_min(1e-6)[:, None],
                            top_k, top_p)


def speculative_accept(
    logits: torch.Tensor,  # [B, T, V] f32: position t predicts token t+1
    proposals: torch.Tensor,  # [B, T-1] int32, -1 = no proposal (never accepts)
    keys_accept: Optional[torch.Tensor],  # [B, T-1, 2] accept draws; None = all greedy
    keys_sample: Optional[torch.Tensor],  # [B, T, 2] correction/bonus draws
    temperature: torch.Tensor,  # [B] 0 => greedy rows
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
) -> tuple[torch.Tensor, torch.Tensor]:  # (out_tokens [B, T] int32, n_acc [B])
    """Rejection-sampling acceptance for deterministic (prompt-lookup)
    drafts: the draft distribution is a point mass on the proposal, so

      * proposal d_t is accepted with probability p_t(d_t);
      * on rejection the correction is drawn from the residual, p with d_t
        masked out (lossless in distribution);
      * greedy rows (temperature 0) accept iff d_t is the argmax, and their
        correction is the argmax.

    The full-acceptance bonus position (t = T-1) samples normally.
    ``out_tokens[:, t]`` is d_t for t < n_acc and the correction/bonus at t
    = n_acc; the caller emits exactly n_acc + 1 tokens per row. An
    all-greedy batch (callers pass no keys) never sorts and draws nothing,
    as in :func:`sample_tokens`."""
    B, T, V = logits.shape
    g = T - 1
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, T]
    d = proposals.clamp_min(0).to(torch.int32)  # safe gather index
    valid = proposals >= 0
    accept = (d == greedy[:, :g]) & valid
    corr = greedy
    if keys_sample is not None:
        is_greedy = (temperature <= 0.0)[:, None]
        scaled = filtered_dist(
            logits.reshape(B * T, V), temperature.repeat_interleave(T),
            top_k.repeat_interleave(T), top_p.repeat_interleave(T),
        ).reshape(B, T, V)
        probs = torch.softmax(scaled, dim=-1)
        p_d = torch.gather(probs[:, :g], 2, d.long()[..., None])[..., 0]
        u = _uniform_scalar(keys_accept.to(logits.device))  # [B, g]
        accept = torch.where(is_greedy, accept, (u < p_d) & valid)
        # the residual: each position's proposal masked out (none at the
        # bonus position and where nothing was proposed)
        masked = torch.cat([valid, valid.new_zeros(B, 1)], dim=1)  # [B, T]
        d_full = torch.cat([d, d.new_zeros(B, 1)], dim=1).long()
        mask = torch.zeros(B, T, V, dtype=torch.bool, device=logits.device)
        mask.scatter_(2, d_full[..., None], masked[..., None])
        resid = scaled.masked_fill(mask, NEG_INF)
        drawn = _categorical(keys_sample.reshape(B * T, 2),
                             resid.reshape(B * T, V)).reshape(B, T)
        corr = torch.where(is_greedy, greedy, drawn)
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)  # [B]
    t_idx = torch.arange(T, device=logits.device)[None, :]
    ahead = torch.cat([d, d.new_zeros(B, 1)], dim=1)
    out = torch.where(t_idx < n_acc[:, None], ahead, corr).to(torch.int32)
    return out, n_acc.to(torch.int32)


def apply_penalties(
    logits: torch.Tensor,  # [B, V] float32
    counts: torch.Tensor,  # [B, V] int32 output-token counts
    prompt_mask: torch.Tensor,  # [B, V] bool: token appeared in the prompt
    freq_pen: torch.Tensor,  # [B] float32 (0 = off)
    pres_pen: torch.Tensor,  # [B] float32 (0 = off)
    rep_pen: torch.Tensor,  # [B] float32 (1.0 = off)
) -> torch.Tensor:
    """OpenAI/HF sampling penalties, vLLM semantics: frequency and presence
    penalize OUTPUT tokens (additive); repetition penalizes prompt AND
    output tokens (divide positive logits by r, multiply negative ones)."""
    cf = counts.float()
    logits = logits - freq_pen[:, None] * cf
    logits = logits - pres_pen[:, None] * (cf > 0)
    seen = prompt_mask | (counts > 0)
    r = torch.where(rep_pen[:, None] <= 0.0, 1.0, rep_pen[:, None])
    penalized = torch.where(logits > 0, logits / r, logits * r)
    return torch.where(seen, penalized, logits)


def bump_counts(counts: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """counts[b, tokens[b]] += 1 for every row, in place (a scatter-add:
    integer sums, the same counts in any order)."""
    idx = tokens.long()[:, None]
    return counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=counts.dtype))


def sample_first_token(
    logits: torch.Tensor,  # [1, V] float32
    keys: Optional[torch.Tensor],  # [1, 2] (make_keys); None = greedy
    temperature: torch.Tensor,  # [1]
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    freq_pen: torch.Tensor,
    pres_pen: torch.Tensor,
    rep_pen: torch.Tensor,
    prompt_ids: torch.Tensor,  # [P] int token ids of the prompt
    gen_ids: torch.Tensor,  # [G] ids generated so far (non-empty on replay)
) -> torch.Tensor:  # [1] int32
    """The prefill's first-token sample with full penalty semantics: the
    prompt-membership mask and the output counts rebuild from the id lists
    (the replay-after-preemption case)."""
    V = logits.shape[-1]
    mask = torch.zeros(V, dtype=torch.bool, device=logits.device)
    mask[prompt_ids.long()] = True
    counts = torch.zeros(V, dtype=torch.int32, device=logits.device)
    counts.index_put_((gen_ids.long(),), torch.ones_like(gen_ids, dtype=torch.int32),
                      accumulate=True)
    logits = apply_penalties(logits.float(), counts[None], mask[None],
                             freq_pen, pres_pen, rep_pen)
    return sample_tokens(logits, keys, temperature, top_k, top_p)


def token_logprobs(
    logits: torch.Tensor,  # [B, V] float32 (raw model logits)
    chosen: torch.Tensor,  # [B] int32 the emitted token
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(chosen_logprob [B], top_ids [B, K], top_logprobs [B, K]) of the
    model's own distribution (pre-temperature/penalty)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    chosen_lp = torch.gather(logp, 1, chosen.long()[:, None])[:, 0]
    top_lp, top_ids = torch.topk(logp, min(TOPK_LOGPROBS, logp.shape[-1]), dim=-1)
    return chosen_lp, top_ids.to(torch.int32), top_lp
