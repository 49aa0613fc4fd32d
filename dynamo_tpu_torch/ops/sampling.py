"""Batched token sampling on the device (PyTorch).

Counterpart of ``dynamo_tpu/ops/sampling.py``: temperature / top-k / top-p
/ greedy for a whole decode batch with per-request parameters as vectors,
sampling penalties, and logprobs.

Randomness: the JAX package keys each draw on
``fold_in(key(seed), step)`` (threefry). The port draws from a per-(request,
step) ``torch.Generator`` seeded from the same (seed, step) pair
(:func:`make_keys`), so a seeded request replays deterministically within
the port but does NOT reproduce the JAX package's token stream. Greedy
rows are exact: ``torch.argmax`` and ``jnp.argmax`` both return the first
maximum.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG_INF = -1e30
TOPK_LOGPROBS = 20  # OpenAI's top_logprobs cap; the host slices per-request


def make_keys(
    seeds: Sequence[int], steps: Sequence[int], temps: Sequence[float],
    device,
) -> list[Optional[torch.Generator]]:
    """One generator per row, seeded from (seed, step); None for greedy
    rows (temperature <= 0), which draw nothing."""
    out: list[Optional[torch.Generator]] = []
    for seed, step, t in zip(seeds, steps, temps):
        if t <= 0.0:
            out.append(None)
            continue
        g = torch.Generator(device=device)
        g.manual_seed(((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
        out.append(g)
    return out


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    keys: Sequence[Optional[torch.Generator]],  # per row (make_keys)
    temperature: torch.Tensor,  # [B] 0 => greedy
    top_k: torch.Tensor,  # [B] 0 => disabled
    top_p: torch.Tensor,  # [B] 1.0 => disabled
) -> torch.Tensor:  # [B] int32
    """An all-greedy batch (every key None: make_keys gives greedy rows
    none) is one argmax and never waits for the card; a filter-free
    sampled batch skips the full-vocab sort; sampled rows draw a
    Gumbel-max categorical."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if all(g is None for g in keys):
        return greedy
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    if bool(((top_k > 0) | (top_p < 1.0)).any()):
        scaled = _apply_topk_topp(scaled, top_k, top_p)
    sampled = greedy.clone()
    for b, g in enumerate(keys):
        if g is None:  # a greedy row in a mixed batch
            continue
        u = torch.rand(scaled.shape[-1], generator=g, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
        sampled[b] = torch.argmax(scaled[b] + gumbel).to(torch.int32)
    return sampled


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
    """counts[b, tokens[b]] += 1 for every row, in place."""
    rows = torch.arange(tokens.shape[0], device=counts.device)
    counts.index_put_((rows, tokens.long()), torch.ones_like(rows, dtype=counts.dtype),
                      accumulate=True)
    return counts


def sample_first_token(
    logits: torch.Tensor,  # [1, V] float32
    keys: Sequence[Optional[torch.Generator]],  # [1]
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
