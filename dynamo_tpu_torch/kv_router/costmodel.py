"""Transfer-cost-aware scoring: a candidate's predicted TTFT (NetKV,
PAPERS.md).

The router-side half of ``dynamo_tpu/kv_router/costmodel.py``, copied:
:func:`predict_worker_ttft_ms` converts one candidate's per-tier overlap
depths (``OverlapScores.device_scores`` + the tier-inclusive overlay) into
milliseconds using that candidate's advertised calibration (the
``kv_cost_obs_total`` / ``kv_link_*`` / ``kv_prefill_tok_s`` keys of its
``load_metrics``): device blocks cost ~0, host/disk blocks cost restore
time, peer-held continuations cost pull time over the observed link (ICI
class when the serving peer shares the candidate's slice), and missing
blocks cost modeled prefill, so routing minimizes **predicted TTFT =
queue_wait + transfer + prefill** instead of maximizing raw overlap.
Returns ``None`` while the candidate is cold (< ``min_obs`` observations,
or geometry/throughput unadvertised) — the scheduler then falls back to
the overlap scoring wholesale, so a half-calibrated fleet never mixes
incomparable score scales.

The worker-side half (the reference's ``TransferCostModel``) is not here:
a torch worker advertises its measured prefill throughput from
``TorchEngine`` itself and has no host, disk or peer links to calibrate.
"""

from __future__ import annotations

from typing import Optional


# ---------------- router-side scoring ----------------


def tail_adjusted_ttft_ms(
    pred_ms: float, tail_ms: Optional[float]
) -> float:
    """Price a candidate at its measured tail (the autopilot's
    tail-aware routing loop, docs/autopilot.md).

    ``pred_ms`` is the calibration model's prediction — built from
    EWMA *means*, so a bimodal worker (periodic GC, a noisy co-tenant,
    a wedged executor firing every few seconds) averages its stalls
    away and keeps winning the argmin. ``tail_ms`` is the worker's
    windowed measured tail (p99 of queue-wait + prefill over the last
    window, :class:`~dynamo_tpu_torch.autopilot.tails.TailTracker`): what a
    request routed there actually risks paying. The effective score is
    the max of the two — the model's structural terms (transfer legs,
    overlap) still differentiate healthy candidates, but no candidate
    may score better than its own recent tail says it serves. None
    (no window evidence — cold or idle worker) changes nothing."""
    if tail_ms is None:
        return pred_ms
    return max(pred_ms, tail_ms)


def _restore_gbps(link_gbps: dict) -> Optional[float]:
    """Effective local-tier restore bandwidth for a candidate: the
    router can't see how a chain splits between host DRAM and disk, so
    it prices the whole lower-tier run at the SLOWER of the two
    advertised classes — conservative, and exact once the disk tier is
    empty or absent."""
    speeds = [link_gbps[k] for k in ("host", "disk") if link_gbps.get(k)]
    return min(speeds) if speeds else None


def link_leg_ms(
    link_gbps: dict, link_lat_ms: dict, link: str, nbytes: int
) -> Optional[float]:
    """One transfer leg from a candidate's advertised calibration:
    per-op latency floor + bytes over bandwidth. None when the class
    was never observed."""
    g = link_gbps.get(link)
    if not g:
        return None
    return (link_lat_ms or {}).get(link, 0.0) + nbytes / (g * 1e9) * 1e3


def restore_leg_ms(
    link_gbps: dict, link_lat_ms: dict, nbytes: int
) -> Optional[float]:
    """The local-tier restore leg (slower of host/disk, see
    :func:`_restore_gbps`), latency floor included."""
    g = _restore_gbps(link_gbps)
    if g is None:
        return None
    lat = max(
        (link_lat_ms or {}).get(k, 0.0)
        for k in ("host", "disk")
        if link_gbps.get(k)
    )
    return lat + nbytes / (g * 1e9) * 1e3


def predict_worker_ttft_ms(
    load,
    overlaps,
    isl_blocks: int,
    pending: int = 0,
    min_obs: int = 4,
    peer_slice_fp: str = "",
    peer_wire_bytes: int = 0,
) -> Optional[float]:
    """Predicted TTFT (ms) for routing one ``isl_blocks``-block prompt
    to ``load``'s worker, from the candidate's advertised calibration:

        queue_wait = requests that must clear a slot before this one
                     × one modeled prompt prefill
        restore    = (tier-inclusive − device) overlap blocks over the
                     candidate's observed host/disk restore link
        pull       = the continuation a deeper peer holds, over the
                     observed peer link (ICI class when ``peer_slice_fp``
                     matches the candidate's slice), plus its restore
                     leg; an unobserved pull link prices as recompute
        prefill    = remaining blocks at the corrected prefill tok/s

    The sum is scaled by ``1 + busy_slot_fraction`` (co-location
    interference: in-flight work timeshares the chips even before the
    queue term engages — the continuous load-spreading the legacy
    scorer's gamma term provided).

    The pull term is an estimate against the DEEPEST other chain; the
    hint that actually fires may name a different (nearest-adequate)
    peer or none (``KvScheduler.choose_peer``). The divergence is
    bounded and conservative — choose_peer only ever picks a peer whose
    predicted cost beats recompute, and recompute is exactly this
    term's fallback pricing — so the argmin ranks candidates on a
    pessimistic but consistently-scaled view.

    Returns None while the candidate is cold: fewer than ``min_obs``
    observations, block geometry unadvertised, throughput unobserved,
    or a needed restore link never measured — the scheduler falls back
    to overlap scoring for the whole decision (cold-start contract)."""
    if load.cost_obs < min_obs or load.block_bytes <= 0 or load.block_size <= 0:
        return None
    tok_s = load.prefill_tok_s
    if not tok_s or tok_s <= 0:
        return None
    w = load.worker_id
    # restore/pull legs move TIER/WIRE bytes: the quantized per-block
    # size when the worker advertises a --kv-quant codec (half the
    # bytes -> half the predicted leg), the full width otherwise
    bs = load.block_size
    bb = load.wire_bytes_per_block
    isl = max(isl_blocks, 1)
    tier = min(overlaps.scores.get(w, 0), isl)
    dev = min(overlaps.device(w), tier)
    restore = tier - dev
    # deepest chain any OTHER worker holds: the continuation past this
    # candidate's own tiers is pullable over the fleet prefix cache
    peer_depth = max(
        (min(ov, isl) for w2, ov in overlaps.scores.items() if w2 != w),
        default=0,
    )
    peer_extra = max(peer_depth - tier, 0)
    missing = max(isl - tier - peer_extra, 0)

    def prefill_ms(blocks: int) -> float:
        return blocks * bs / tok_s * 1e3

    link_gbps = load.link_gbps or {}
    link_lat = getattr(load, "link_lat_ms", None) or {}
    ms = 0.0
    # queue: how many in-flight/queued requests must finish before a
    # slot frees for this one, each modeled at one prompt's prefill
    ahead = max(
        load.active_requests + load.waiting + pending + 1 - load.total_slots,
        0,
    )
    ms += ahead * prefill_ms(isl)
    if restore > 0:
        leg = restore_leg_ms(link_gbps, link_lat, restore * bb)
        if leg is None:
            return None  # a tiered candidate that never restored is cold
        ms += leg
    if peer_extra > 0:
        link = (
            "ici"
            if peer_slice_fp and load.slice_fp
            and peer_slice_fp == load.slice_fp
            else "peer"
        )
        # the WIRE leg moves bytes at the serving peer's codec width
        # (peers serve their stored form); the landing/restore leg is
        # this candidate's own tier width
        pull = link_leg_ms(
            link_gbps, link_lat,
            link if link_gbps.get(link) else "peer",
            peer_extra * (peer_wire_bytes or bb),
        )
        land = restore_leg_ms(link_gbps, link_lat, peer_extra * bb)
        if pull is not None and land is not None:
            ms += pull + land
        else:
            # never pulled / never restored: price the continuation as
            # recompute — conservative, and exactly what the worker
            # will do if the pull keeps failing
            missing += peer_extra
    ms += prefill_ms(missing)
    # co-location interference: below slot saturation the queue term is
    # zero, but every in-flight/pending request still timeshares the
    # chips our prefill runs on — scale by the busy-slot fraction so a
    # burst of cold prompts spreads across calibrated workers instead
    # of piling onto whichever advertises the highest tok/s (the load
    # spreading the legacy scorer's gamma term provided)
    share = (
        (load.active_requests + load.waiting + pending)
        / max(load.total_slots, 1)
    )
    return ms * (1.0 + share)
