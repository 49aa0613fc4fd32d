"""Self-calibrating link/tier transfer-cost model (NetKV, PAPERS.md).

A copy of ``dynamo_tpu/kv_router/costmodel.py``, both halves:

* **Worker side**: each worker owns a :class:`TransferCostModel` and folds
  its own observed timings into per-link-class bandwidth/latency EWMAs
  (h2d restores "host", disk promotions "disk"; the peer, ICI and DCN
  classes come with the fleet pull and disaggregation), plus an observed
  prefill token throughput fed by dedicated prefill chunks only. The
  estimates ship in ``load_metrics`` (``counters()``), so the router
  prices every candidate with its own measurements.

* **Router side**: :func:`predict_worker_ttft_ms` converts one candidate's
  per-tier overlap depths (``OverlapScores.device_scores`` + the
  tier-inclusive overlay) into milliseconds using that candidate's
  advertised calibration (the ``kv_cost_obs_total`` / ``kv_link_*`` /
  ``kv_prefill_tok_s`` keys of its ``load_metrics``): device blocks cost
  ~0, host/disk blocks cost restore time, peer-held continuations cost
  pull time over the observed link (ICI class when the serving peer shares
  the candidate's slice), and missing blocks cost modeled prefill, so
  routing minimizes **predicted TTFT = queue_wait + transfer + prefill**
  instead of maximizing raw overlap. Returns ``None`` while the candidate
  is cold (< ``min_obs`` observations, or geometry/throughput
  unadvertised); the scheduler then falls back to the overlap scoring
  wholesale, so a half-calibrated fleet never mixes incomparable score
  scales.
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import Optional

#: the link classes a worker can observe, slowest-to-fastest in a
#: typical deployment: cross-host TCP (dcn), peer prefix pulls (peer —
#: also TCP today, but measured separately because serve-side export
#: stacking dominates small pulls), local disk promotion (disk), host
#: h2d restore (host), same-slice device→device handoff (ici)
LINK_CLASSES = ("dcn", "peer", "disk", "host", "ici")


@dataclass
class LinkEstimate:
    """EWMA bandwidth + per-op latency for one link class."""

    gbps: float = 0.0  # gigaBYTES/s (effective, includes per-op setup)
    lat_ms: float = 0.0  # per-op latency floor (wall minus bytes/bw)
    n: int = 0
    last_ts: float = 0.0


class TransferCostModel:
    """One worker's (or one test's) calibration state. Thread-safe: the
    observation sites span the event loop, the device executor and the
    offload executor threads."""

    #: one sample can move an EWMA by at most this factor in either
    #: direction (restart clamp): a worker restarted into a congested
    #: minute — or one absurd timer reading — must not repoint routing
    #: by orders of magnitude before the EWMA has evidence
    SAMPLE_CLAMP = 8.0

    def __init__(
        self,
        block_bytes: int = 0,
        alpha: float = 0.25,
        min_obs: int = 4,
        obs_ttl_s: float = 900.0,
        prefill_seed_tok_s: float = 0.0,
        corr_bounds: tuple[float, float] = (0.25, 4.0),
        clock=None,
    ):
        self.block_bytes = int(block_bytes)
        self.alpha = alpha
        self.min_obs = min_obs
        self.obs_ttl_s = obs_ttl_s
        #: roofline-style seed (tokens/s one prefill replica sustains);
        #: 0 = unseeded, the pure observation EWMA serves instead
        self.prefill_seed_tok_s = float(prefill_seed_tok_s)
        self.corr_bounds = corr_bounds
        self._clock = clock or _time.monotonic
        self._lock = threading.Lock()
        self._links: dict[str, LinkEstimate] = {}
        # observed prefill throughput: EWMA tok/s + a multiplicative
        # correction on the seed (CapacityModel's observed/modeled fold)
        self._prefill = LinkEstimate()
        self._prefill_corr = 1.0
        self.obs_total = 0

    # ---------------- observation (worker side) ----------------

    def _fold(self, est: LinkEstimate, sample: float, now: float) -> None:
        if est.n == 0 or now - est.last_ts > self.obs_ttl_s:
            # first sample, or the estimate went stale (worker idled
            # through a topology change): restart the EWMA rather than
            # averaging across two different worlds
            est.gbps = sample
            est.n = 1 if est.n == 0 else est.n
        else:
            lo = est.gbps / self.SAMPLE_CLAMP
            hi = est.gbps * self.SAMPLE_CLAMP
            s = min(max(sample, lo), hi)
            est.gbps = (1 - self.alpha) * est.gbps + self.alpha * s
        est.last_ts = now

    def observe(self, link: str, nbytes: int, wall_s: float) -> None:
        """Fold one measured transfer (``nbytes`` moved in ``wall_s``)
        into the link class's estimate. Bad samples are dropped, never
        raised — observation sites sit on serving paths."""
        if nbytes <= 0 or wall_s <= 0 or link not in LINK_CLASSES:
            return
        sample_gbps = nbytes / wall_s / 1e9
        now = self._clock()
        with self._lock:
            est = self._links.setdefault(link, LinkEstimate())
            had = est.n
            self._fold(est, sample_gbps, now)
            if had:
                est.n = had + 1
            # latency floor: the part of the wall the bandwidth model
            # doesn't explain (connection setup, executor hop, ack)
            modeled_ms = nbytes / (est.gbps * 1e9) * 1e3
            lat_sample = max(wall_s * 1e3 - modeled_ms, 0.0)
            est.lat_ms = (
                lat_sample if had == 0
                else (1 - self.alpha) * est.lat_ms + self.alpha * lat_sample
            )
            self.obs_total += 1

    def observe_prefill(self, tokens: int, wall_s: float) -> None:
        """Fold one measured prefill chunk (device time) into the
        throughput model — the correction term on the roofline seed."""
        if tokens <= 0 or wall_s <= 0:
            return
        tok_s = tokens / wall_s
        now = self._clock()
        with self._lock:
            est = self._prefill
            had = est.n
            self._fold(est, tok_s, now)
            if had:
                est.n = had + 1
            if self.prefill_seed_tok_s > 0:
                lo, hi = self.corr_bounds
                sample = tok_s / self.prefill_seed_tok_s
                self._prefill_corr = min(
                    hi,
                    max(lo, (1 - self.alpha) * self._prefill_corr
                        + self.alpha * sample),
                )
            self.obs_total += 1

    # ---------------- queries ----------------

    def _fresh(self, est: LinkEstimate) -> bool:
        return (
            est.n > 0
            and (self.obs_ttl_s <= 0
                 or self._clock() - est.last_ts <= self.obs_ttl_s)
        )

    def link_gbps(self, link: str) -> Optional[float]:
        """Observed effective bandwidth for one link class, or None when
        the class was never observed or the last observation aged out
        (``obs_ttl_s`` — a dead link must stop informing routing)."""
        with self._lock:
            est = self._links.get(link)
            if est is None or not self._fresh(est):
                return None
            return est.gbps

    def transfer_ms(self, link: str, nbytes: int) -> Optional[float]:
        with self._lock:
            est = self._links.get(link)
            if est is None or not self._fresh(est) or est.gbps <= 0:
                return None
            return est.lat_ms + nbytes / (est.gbps * 1e9) * 1e3

    def prefill_tok_s(self) -> Optional[float]:
        """Corrected prefill throughput: seed × observed correction when
        roofline-seeded, else the pure observation EWMA (None until the
        first chunk lands)."""
        with self._lock:
            if self.prefill_seed_tok_s > 0:
                return self.prefill_seed_tok_s * self._prefill_corr
            if self._prefill.n == 0 or not self._fresh(self._prefill):
                return None
            return self._prefill.gbps  # tok/s rides the same EWMA slot

    # ---------------- export (load_metrics -> WorkerLoad) ----------------

    def counters(self) -> dict:
        """The worker's advertised calibration: folded into
        ``engine.load_metrics`` and scraped into ``WorkerLoad`` so the
        router prices this worker with its own measurements. Latency
        floors ride alongside the bandwidths — a 1-block restore is
        dominated by per-op setup, not bytes/bw."""
        with self._lock:
            links = {
                name: round(est.gbps, 6)
                for name, est in self._links.items()
                if self._fresh(est)
            }
            lats = {
                name: round(est.lat_ms, 4)
                for name, est in self._links.items()
                if self._fresh(est)
            }
        tok_s = self.prefill_tok_s()
        return {
            "kv_cost_obs_total": self.obs_total,
            "kv_link_gbps": links,
            "kv_link_lat_ms": lats,
            "kv_prefill_tok_s": round(tok_s, 3) if tok_s else 0.0,
        }


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
