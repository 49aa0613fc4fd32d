"""KV-aware worker selection: a copy of ``dynamo_tpu/kv_router/scheduler.py``
(the reference's lib/llm/src/kv_router/scheduler.rs:84-316). ``WorkerLoad``
reads the reference's whole scrape schema, so a torch worker and a JAX
worker are scored from one table. The reference's soft exclusions of
workers a planner's capacity watermarks or an autopilot's health
directives name are left out with the subscriptions that feed them.

Cost model per candidate worker, as in the reference (scheduler.rs:221-262):

  normalized_new_tokens = tokens the worker would have to prefill / isl
  load_deviation        = worker kv usage - mean kv usage
  request_load_ratio    = active requests / slots

  cost = alpha * load_deviation
       + (1 - alpha) * normalized_new_tokens
       + gamma * request_load_ratio

with a "balance mode" switch: when the kv-load standard deviation across
workers exceeds a threshold the weights flip to prioritize load (alpha
0.7) over cache overlap (alpha 0.3 otherwise). Full workers are skipped;
if every worker is saturated the scheduler reports AllWorkersBusy so the
caller can queue (ref scheduler.rs:165-174). Selected workers get an
optimistic local load bump so concurrent decisions spread out (ref
scheduler.rs:281-282).
"""

from __future__ import annotations

import logging
import time as _time
from dataclasses import dataclass, field
from typing import Optional

from ..autopilot.tails import TailTracker
from .costmodel import (
    link_leg_ms,
    predict_worker_ttft_ms,
    restore_leg_ms,
    tail_adjusted_ttft_ms,
)
from .indexer import OverlapScores
from .protocols import (
    KV_HIT_RATE_SUBJECT,
    KV_PREFETCH_MAX_BLOCKS,
    KV_PREFETCH_SUBJECT,
    KVHitRateEvent,
    KvPrefetchHint,
)

logger = logging.getLogger(__name__)


class AllWorkersBusy(Exception):
    pass


@dataclass
class WorkerLoad:
    worker_id: int
    kv_active_blocks: int = 0
    kv_total_blocks: int = 1
    active_requests: int = 0
    total_slots: int = 1
    waiting: int = 0
    # async offload-tier surface (engine OffloadManager.stats): scraped
    # for the fleet metrics endpoint, not used by the cost model
    offload_blocks_resident: int = 0
    offload_d2h_flush_async: int = 0
    offload_prefetch_hits: int = 0
    offload_restore_hidden_frac: float = 0.0
    # third-tier + fleet-prefix-cache surface: disk-tier
    # residency/hits, peer-pull volume, and the fraction of pulled
    # blocks whose cross-worker transfer stayed off every TTFT path
    disk_blocks_resident: int = 0
    disk_hit_blocks: int = 0
    peer_pull_blocks: int = 0
    peer_pull_hidden_frac: float = 0.0
    # disk-tier health + fleet-serve volume: corrupt entries discarded
    # as clean misses, host->disk demotions, and blocks this worker
    # served to peers from its host/disk tiers (the d2h device-tier
    # serve counts separately below)
    disk_corrupt_discards: int = 0
    disk_demotions: int = 0
    peer_serve_blocks: int = 0
    # resilience surface: a draining worker (SIGTERM received, lease
    # still live) must not be picked — its engine bounces new work
    draining: int = 0
    drains_total: int = 0
    drain_handoffs: int = 0
    migration_resumes: int = 0
    # elastic-reshard surface: ``resharding`` marks a live morph window
    # — the worker HOLDS work through it (requests queue, nothing
    # bounces), so unlike ``draining`` it is a SOFT exclusion: prefer
    # any non-morphing worker, fall back rather than refuse
    resharding: int = 0
    resharded_total: int = 0
    reshard_hold_ms: float = 0.0
    reshard_kv_moved_blocks: int = 0
    #: the worker's deployed tensor-parallel degree (0 = not
    #: advertised); seeds the planner's morph guard from reality
    mesh_tp: int = 0
    # disagg KV-handoff surface (DisaggEngine.stats): streamed (layer-
    # wise, transfer hidden behind prefill) vs bulk deliveries, plus the
    # segment volume landed through the incremental scatter path
    kv_stream_deliveries: int = 0
    kv_bulk_deliveries: int = 0
    kv_stream_segments: int = 0
    # mixed-batch fusion surface (engine stats): fused steps dispatched
    # and how many prefill SEGMENTS packed into them — segments/steps
    # near 1 under a deep prompt queue means head-of-line blocking the
    # packer should be absorbing (docs/architecture.md mixed batching)
    mixed_steps: int = 0
    mixed_prefill_segments: int = 0
    # cumulative serving counters (engine stats): the planner's
    # telemetry aggregator turns scrape-to-scrape deltas into fleet
    # arrival/throughput rates
    requests_total: int = 0
    tokens_generated: int = 0
    prompt_tokens_total: int = 0
    # runtime-sanitizer surface (the reference's analysis.sanitizer, exported
    # through engine.load_metrics when a sanitizer is active): event-loop
    # stalls and worst lock holds observed on THIS worker — production
    # stalls become fleet gauges instead of test-time-only signals
    loop_stalls: int = 0
    loop_stall_max_ms: float = 0.0
    lock_holds: int = 0
    lock_hold_max_ms: float = 0.0
    writers_leaked: int = 0
    # executor pressure (sanitizer.register_executor): the deepest
    # pending-task backlog any registered executor (offload d2h/disk,
    # engine device dispatch) has reached — a wedged executor shows up
    # here before it shows up as TTFT
    executor_pending_max: int = 0
    # transfer-cost calibration (kv_router/costmodel.py): the worker's
    # observed per-link-class bandwidths, corrected prefill throughput,
    # and KV block geometry — everything the router needs to convert
    # this candidate's overlap depths into predicted milliseconds.
    # cost_obs gates cold-start: below the scheduler's cost_min_obs the
    # candidate routes on overlap like before
    cost_obs: int = 0
    link_gbps: dict = field(default_factory=dict)
    link_lat_ms: dict = field(default_factory=dict)
    prefill_tok_s: float = 0.0
    block_bytes: int = 0
    block_size: int = 0
    # tier/wire bytes per block under the worker's --kv-quant codec
    # (== block_bytes when quantization is off; 0 = not advertised,
    # pre-quant worker): restore and peer-pull legs move THESE bytes,
    # so predict/choose_peer price them with this, not the device width
    wire_block_bytes: int = 0
    # kv-quant codec activity (OffloadManager.stats): blocks encoded
    # into the quantized tiers/wire, and the bytes that saved vs full
    # width — the capacity win, observable per worker
    kv_quant_blocks: int = 0
    kv_quant_bytes_saved: int = 0
    # worst logprob drift the kv-quant quality harness recorded on this
    # worker (0 until a harness ran) — operators watch this gauge when
    # a quantized tier is enabled fleet-wide
    kv_quant_logprob_drift_max: float = 0.0
    # int8-with-scales DEVICE cache lane (kv_cache_dtype="int8",
    # models/quant.py): resident quantized pages, cumulative page
    # requantizations (appends that grew a page's absmax scale), HBM
    # bytes the lane saved vs full width, exports forced off the device
    # codec (full-width/fp8 bounce — ideally 0 with an int8 tier), and
    # the measured decode throughput of the low-precision lane
    kv_device_quant_pages: int = 0
    kv_device_requants: int = 0
    kv_device_bytes_saved: int = 0
    kv_device_export_requants: int = 0
    lowprec_tok_s: float = 0.0
    # accelerator-slice fingerprint (parallel/mesh.slice_fingerprint):
    # two workers advertising the same fp can hand KV device→device
    # over ICI — the peer chooser prices their pulls at the ici class
    slice_fp: str = ""
    # ICI fast-path + device-tier fleet-cache activity (gauges)
    ici_handoffs: int = 0
    peer_serve_d2h_blocks: int = 0
    weight_prestage_requests: int = 0
    # multi-model serving surface (engine.served_models / adapter
    # registry): the model names this worker can serve — "" is the base
    # model. An EMPTY tuple means the worker predates the advertisement
    # (or serves base only) and is treated as a wildcard so legacy
    # fleets keep routing unchanged; select_worker filters on this
    # BEFORE scoring, because no cost model makes an adapter-less
    # worker serve an adapter
    models: tuple = ()
    # adapter-prestage effectiveness: bytes of adapter weights staged
    # ahead of traffic via prefetch hints, and requests that found
    # their adapter already resident (the stall the prestage hid)
    prestage_bytes: int = 0
    prestage_hits: int = 0
    # per-model TTFT distributions (hist_ttft_ms: model name -> to_vec
    # bucket vector, "" = base): the metrics component renders these as
    # model-labelled histogram families and trace replay asserts
    # per-model p99 SLOs from them
    model_hists: dict = field(default_factory=dict)
    # SLO observatory (docs/observability.md): worker-side latency
    # distributions as serialized histogram bucket vectors
    # (observability/hist.py to_vec form, keyed queue_wait_ms /
    # prefill_ms / restore_ms / handoff_ms) — the metrics component
    # renders them as per-worker Prometheus histogram families and the
    # planner's telemetry merges them loss-free across the fleet
    hists: dict = field(default_factory=dict)
    # XLA compile ledger counters + warmup coverage: distinct program
    # buckets compiled (with total compile wall-ms), and how many of
    # the warmup-reachable buckets were actually warmed — a production
    # TTFT spike correlating with a compiles_total step IS a cold
    # bucket, attributable instead of anonymous
    xla_compiles: int = 0
    xla_compile_ms: float = 0.0
    xla_warm_buckets: int = 0
    xla_reachable_buckets: int = 0
    # autopilot actuation surface (docs/autopilot.md): control-plane
    # warmups this worker ran (and the wall they took — the compile tax
    # paid OFF the hot path), plus the worker's mirrored quarantine
    # state: currently pulled from rotation, and total times it was
    autopilot_warmups: int = 0
    autopilot_warmup_ms: float = 0.0
    autopilot_quarantined: int = 0
    autopilot_quarantines: int = 0
    # TPU device-memory telemetry: allocator view (bytes_limit == 0
    # marks the attributed-sum fallback on backends without
    # memory_stats) plus the engine's exact KV-pool/weights attribution
    hbm_bytes_in_use: int = 0
    hbm_bytes_limit: int = 0
    hbm_kv_pool_bytes: int = 0
    hbm_weights_bytes: int = 0
    # monotonic stamp set at scrape time (None = constructed directly /
    # legacy producer): the scheduler discards loads older than
    # ``SchedulerConfig.load_ttl_s`` instead of trusting a dead
    # worker's last report
    ts: Optional[float] = None

    @staticmethod
    def from_stats(worker_id: int, d: dict, ts: Optional[float] = None) -> "WorkerLoad":
        """One WorkerLoad from a worker's ``load_metrics`` payload — the
        single mapping the metrics aggregator, the bench harness and
        tests all share, so the scrape schema can't drift per consumer."""
        return WorkerLoad(
            worker_id=worker_id,
            kv_active_blocks=d.get("kv_active_blocks", 0),
            kv_total_blocks=max(d.get("kv_total_blocks", 1), 1),
            active_requests=d.get("request_active_slots", 0),
            total_slots=max(d.get("request_total_slots", 1), 1),
            waiting=d.get("num_requests_waiting", 0),
            offload_blocks_resident=d.get("offload_blocks_resident", 0),
            offload_d2h_flush_async=d.get("d2h_flush_async", 0),
            offload_prefetch_hits=d.get("h2d_prefetch_hits", 0),
            offload_restore_hidden_frac=d.get(
                "restore_latency_hidden_frac", 0.0),
            disk_blocks_resident=d.get("disk_blocks_resident", 0),
            disk_hit_blocks=d.get("disk_hit_blocks_total", 0),
            peer_pull_blocks=d.get("peer_pull_blocks_total", 0),
            peer_pull_hidden_frac=d.get("peer_pull_hidden_frac", 0.0),
            disk_corrupt_discards=d.get("disk_corrupt_discards", 0),
            disk_demotions=d.get("disk_demotions_total", 0),
            peer_serve_blocks=d.get("peer_serve_blocks_total", 0),
            draining=d.get("draining", 0),
            drains_total=d.get("drains_total", 0),
            drain_handoffs=d.get("drain_handoffs", 0),
            migration_resumes=d.get("migration_resumes", 0),
            resharding=d.get("resharding", 0),
            resharded_total=d.get("resharded_total", 0),
            reshard_hold_ms=d.get("reshard_hold_ms", 0.0),
            reshard_kv_moved_blocks=d.get("reshard_kv_moved_blocks", 0),
            mesh_tp=d.get("mesh_tp", 0),
            kv_stream_deliveries=d.get("streamed_deliveries", 0),
            kv_bulk_deliveries=d.get("bulk_deliveries", 0),
            kv_stream_segments=d.get("kv_stream_segments", 0),
            mixed_steps=d.get("mixed_steps", 0),
            mixed_prefill_segments=d.get("mixed_prefill_segments", 0),
            requests_total=d.get("requests_total", 0),
            tokens_generated=d.get("tokens_generated", 0),
            prompt_tokens_total=d.get("prompt_tokens_total", 0),
            loop_stalls=d.get("san_loop_stalls", 0),
            loop_stall_max_ms=d.get("san_loop_stall_max_ms", 0.0),
            lock_holds=d.get("san_lock_holds", 0),
            lock_hold_max_ms=d.get("san_lock_hold_max_ms", 0.0),
            writers_leaked=d.get("san_writers_leaked", 0),
            executor_pending_max=d.get("san_executor_pending_max", 0),
            cost_obs=d.get("kv_cost_obs_total", 0),
            link_gbps=dict(d.get("kv_link_gbps") or {}),
            link_lat_ms=dict(d.get("kv_link_lat_ms") or {}),
            prefill_tok_s=d.get("kv_prefill_tok_s", 0.0),
            block_bytes=d.get("kv_block_bytes", 0),
            block_size=d.get("kv_block_size", 0),
            wire_block_bytes=d.get("kv_wire_block_bytes", 0),
            kv_quant_blocks=d.get("kv_quant_blocks_total", 0),
            kv_quant_bytes_saved=d.get("kv_quant_bytes_saved_total", 0),
            kv_quant_logprob_drift_max=d.get(
                "kv_quant_logprob_drift_max", 0.0),
            kv_device_quant_pages=d.get("kv_device_quant_pages", 0),
            kv_device_requants=d.get("kv_device_requants_total", 0),
            kv_device_bytes_saved=d.get("kv_device_bytes_saved_total", 0),
            kv_device_export_requants=d.get(
                "kv_device_export_requant_total", 0),
            lowprec_tok_s=d.get("lowprec_tok_s", 0.0),
            slice_fp=str(d.get("kv_slice_fp") or ""),
            ici_handoffs=d.get("ici_handoffs", 0),
            peer_serve_d2h_blocks=d.get("peer_serve_d2h_blocks_total", 0),
            weight_prestage_requests=d.get("weight_prestage_requests", 0),
            models=tuple(d.get("served_models") or ()),
            prestage_bytes=d.get("weight_prestage_bytes", 0),
            prestage_hits=d.get("weight_prestage_hits", 0),
            model_hists=dict(d.get("hist_ttft_ms") or {}),
            hists={
                name: vec
                for name, vec in (
                    ("queue_wait_ms", d.get("hist_queue_wait_ms")),
                    ("prefill_ms", d.get("hist_prefill_ms")),
                    ("restore_ms", d.get("hist_restore_ms")),
                    ("handoff_ms", d.get("hist_handoff_ms")),
                )
                if vec
            },
            xla_compiles=d.get("xla_compiles_total", 0),
            xla_compile_ms=d.get("xla_compile_ms_total", 0.0),
            xla_warm_buckets=d.get("xla_warm_buckets", 0),
            xla_reachable_buckets=d.get("xla_reachable_buckets", 0),
            autopilot_warmups=d.get("autopilot_warmups_applied", 0),
            autopilot_warmup_ms=d.get("autopilot_warmup_ms_total", 0.0),
            autopilot_quarantined=d.get("autopilot_quarantined", 0),
            autopilot_quarantines=d.get("autopilot_quarantines_total", 0),
            hbm_bytes_in_use=d.get("hbm_bytes_in_use", 0),
            hbm_bytes_limit=d.get("hbm_bytes_limit", 0),
            hbm_kv_pool_bytes=d.get("hbm_kv_pool_bytes", 0),
            hbm_weights_bytes=d.get("hbm_weights_bytes", 0),
            ts=ts,
        )

    def serves(self, model: str) -> bool:
        """Can this worker serve ``model``? ``""`` (base traffic) is
        always servable; a worker advertising no model list is a legacy
        wildcard (pre-multi-model producer — routing must not strand
        it), and so is one whose advertisement CONTAINS ``""`` (a
        single-model engine with no configured served name accepts any
        name — the legacy contract); otherwise the name must be in the
        advertisement."""
        if not model:
            return True
        if not self.models:
            return True
        return "" in self.models or model in self.models

    @property
    def wire_bytes_per_block(self) -> int:
        """Bytes one block actually moves on this worker's tier/wire
        planes: the quantized advertisement when present, the full
        width otherwise (pre-quant workers keep their old pricing)."""
        return self.wire_block_bytes or self.block_bytes

    @property
    def kv_usage(self) -> float:
        return self.kv_active_blocks / max(self.kv_total_blocks, 1)

    @property
    def slot_usage(self) -> float:
        return self.active_requests / max(self.total_slots, 1)

    @property
    def saturated(self) -> bool:
        return self.active_requests >= self.total_slots and self.waiting > 0


@dataclass
class ProcessedEndpoints:
    loads: list[WorkerLoad]

    def __post_init__(self):
        self.by_id = {l.worker_id: l for l in self.loads}

    @property
    def load_avg(self) -> float:
        if not self.loads:
            return 0.0
        return sum(l.kv_usage for l in self.loads) / len(self.loads)

    @property
    def load_std(self) -> float:
        if not self.loads:
            return 0.0
        avg = self.load_avg
        return (sum((l.kv_usage - avg) ** 2 for l in self.loads) / len(self.loads)) ** 0.5

    def worker_ids(self) -> list[int]:
        return sorted(self.by_id)


@dataclass
class SchedulerConfig:
    overlap_alpha: float = 0.3  # weight on load when caches matter more
    balance_alpha: float = 0.7  # weight on load in balance mode
    balance_threshold: float = 0.2  # load-std that flips to balance mode
    gamma: float = 0.2  # request-load term
    #: discard WorkerLoad snapshots older than this (stamped at scrape
    #: time): a worker that died between scrapes keeps advertising its
    #: last (often attractive, near-idle) load until its lease TTL
    #: lapses — routing must not trust it. 0 disables the check.
    #: Default is deliberately >> the 1s scrape interval: it guards a
    #: wedged metrics plane, not one missed tick (a dead worker drops
    #: out of the very next successful scrape on its own).
    load_ttl_s: float = 30.0
    #: transfer-cost-aware placement (costmodel.py): score candidates by
    #: predicted TTFT = queue_wait + transfer + prefill from their own
    #: advertised link/throughput calibration. Falls back to the overlap
    #: cost above whenever ANY candidate is still cold — mixing the two
    #: score scales in one decision would be meaningless. False = the
    #: overlap scoring unconditionally.
    cost_model: bool = True
    #: calibration observations a candidate must advertise before its
    #: predicted TTFT is trusted (cold-start gate)
    cost_min_obs: int = 4
    #: tail-aware routing (autopilot loop 1): fold each candidate's
    #: WINDOWED measured tail (p-quantile of queue-wait + prefill,
    #: differenced from the scraped cumulative histograms) into the
    #: cost-mode score as a floor — a bimodal worker is priced at its
    #: tail instead of the mean its EWMA calibration reports. Inert for
    #: workers with no window evidence (cold / idle / pre-observatory
    #: producers), so legacy fleets route unchanged.
    tail_aware: bool = True
    tail_q: float = 0.99
    tail_window_s: float = 60.0
    #: window samples the tail needs before it is trusted
    tail_min_count: int = 8


class KvScheduler:
    def __init__(self, drt=None, component=None,
                 config: Optional[SchedulerConfig] = None, clock=None):
        self.cfg = config or SchedulerConfig()
        self.drt = drt
        self._clock = clock or _time.monotonic
        # windowed per-worker tails from the scraped cumulative
        # histograms (autopilot tail-aware routing)
        self.tails = TailTracker(
            window_s=self.cfg.tail_window_s, q=self.cfg.tail_q,
            min_count=self.cfg.tail_min_count, clock=self._clock,
        )
        self.route_tail_overrides = 0
        self._hit_subject = (
            component.event_subject(KV_HIT_RATE_SUBJECT) if component else None
        )
        self._prefetch_subject = (
            component.event_subject(KV_PREFETCH_SUBJECT) if component else None
        )
        self.prefetch_hints_sent = 0
        # optimistic in-flight bumps: worker -> extra requests assumed
        self._pending: dict[int, int] = {}
        # last decision's route mode + prediction (observability:
        # riders on the KVHitRateEvent -> route_predicted_ttft_ms gauge)
        self.last_predicted_ttft_ms: Optional[float] = None
        self.route_cost_decisions = 0
        self.route_overlap_decisions = 0

    def select_worker(
        self,
        endpoints: ProcessedEndpoints,
        overlaps: OverlapScores,
        isl_blocks: int,
        avoid: frozenset = frozenset(),
        model: str = "",
    ) -> int:
        loads = [l for l in endpoints.loads]
        if not loads:
            raise AllWorkersBusy("no workers")
        if self.cfg.tail_aware:
            # feed the tail windows from every scrape that flows
            # through a decision (deduped on the scrape stamp) — the
            # quarantined/held workers' tails keep updating too, so
            # their recovery is visible when they return
            for l in endpoints.loads:
                self.tails.observe(l.worker_id, l.hists, ts=l.ts)
        if model:
            # model filter comes BEFORE every score: a worker without
            # the adapter can't serve the request at any cost, and the
            # hard exclusion must not soften into the avoid/watermark
            # fallbacks below. Distinct error text — "no worker serves
            # this model" is a deployment gap, not transient pressure
            loads = [l for l in loads if l.serves(model)]
            if not loads:
                raise AllWorkersBusy(f"no worker serves model {model!r}")
        if self.cfg.load_ttl_s > 0:
            now = self._clock()
            fresh = [
                l for l in loads
                if l.ts is None or now - l.ts <= self.cfg.load_ttl_s
            ]
            if not fresh:
                # every load is stale (metrics plane wedged / all
                # workers dead): refuse rather than route on fiction —
                # the caller falls back to round robin over discovery
                raise AllWorkersBusy("all worker loads stale")
            loads = fresh
        candidates = [l for l in loads if not l.saturated and not l.draining]
        if not candidates:
            raise AllWorkersBusy("all workers saturated or draining")
        # a worker mid-morph (elastic reshard) HOLDS new work through
        # the quiesce window instead of bouncing it, so exclusion is
        # soft: route around it while it morphs, but a one-worker pool
        # still serves (its requests just wait out the hold)
        not_morphing = [l for l in candidates if not l.resharding]
        candidates = not_morphing or candidates
        # ``avoid`` carries the workers a migrating request already failed
        # on. A freshly-killed worker stays in discovery (and in the
        # metrics view) until its lease TTL lapses, and prefix affinity
        # would re-pick the corpse every time — soft-exclude: prefer any
        # other worker, but fall back rather than refuse when the avoid
        # set covers every candidate (lone-worker restarts)
        if avoid:
            preferred = [l for l in candidates if l.worker_id not in avoid]
            candidates = preferred or candidates

        best_id = None
        self.last_predicted_ttft_ms = None
        if self.cfg.cost_model:
            # transfer-cost-aware placement: every candidate must be
            # calibration-ready (predict returns None when cold) — a
            # single cold candidate falls the WHOLE decision back to
            # overlap scoring, because the two score scales (predicted
            # milliseconds vs the normalized overlap cost) aren't
            # comparable within one argmin
            preds = []
            for l in candidates:
                peer = self._deepest_peer(endpoints, overlaps, l.worker_id)
                p = predict_worker_ttft_ms(
                    l, overlaps, isl_blocks,
                    pending=self._pending.get(l.worker_id, 0),
                    min_obs=self.cfg.cost_min_obs,
                    peer_slice_fp=peer.slice_fp if peer else "",
                    # pull legs move bytes at the SERVING peer's codec
                    # width (it ships its stored form), not this
                    # candidate's
                    peer_wire_bytes=(
                        peer.wire_bytes_per_block if peer else 0
                    ),
                )
                if p is None:
                    preds = None
                    break
                if self.cfg.tail_aware:
                    # tail-aware routing: no candidate may score better
                    # than its own windowed measured tail — the mean-
                    # built model hides a bimodal worker's p99
                    adjusted = tail_adjusted_ttft_ms(
                        p, self.tails.tail_ms(l.worker_id)
                    )
                    if adjusted > p:
                        self.route_tail_overrides += 1
                    p = adjusted
                preds.append((p, l.worker_id))
            if preds:
                # ties (identical candidates, or a model with barely
                # enough observations) break on the EXISTING overlap
                # score then worker id — never on float-sum iteration
                # order, which flaps routing between scrapes
                p, best_id = min(
                    preds,
                    key=lambda t: (
                        t[0], -overlaps.scores.get(t[1], 0), t[1]
                    ),
                )
                self.last_predicted_ttft_ms = p
                self.route_cost_decisions += 1

        if best_id is None:
            balance_mode = endpoints.load_std > self.cfg.balance_threshold
            alpha = (
                self.cfg.balance_alpha if balance_mode
                else self.cfg.overlap_alpha
            )
            avg = endpoints.load_avg

            def legacy_cost(l: WorkerLoad) -> float:
                overlap = overlaps.scores.get(l.worker_id, 0)
                norm_new = max(isl_blocks - overlap, 0) / max(isl_blocks, 1)
                pending = self._pending.get(l.worker_id, 0)
                req_ratio = (
                    (l.active_requests + pending) / max(l.total_slots, 1)
                )
                return (
                    alpha * (l.kv_usage - avg)
                    + (1 - alpha) * norm_new
                    + self.cfg.gamma * req_ratio
                )

            # same deterministic tie-break as the cost mode: equal-cost
            # candidates (identical loads, float-sum ties) must pick the
            # same worker regardless of the loads list's scrape order
            best_id = min(
                candidates,
                key=lambda l: (
                    legacy_cost(l),
                    -overlaps.scores.get(l.worker_id, 0),
                    l.worker_id,
                ),
            ).worker_id
            self.route_overlap_decisions += 1

        self._pending[best_id] = self._pending.get(best_id, 0) + 1
        self._emit_hit_rate(best_id, isl_blocks, overlaps.scores.get(best_id, 0))
        return best_id

    @staticmethod
    def _deepest_peer(
        endpoints: ProcessedEndpoints, overlaps: OverlapScores, worker_id: int
    ) -> Optional[WorkerLoad]:
        """Load of the deepest OTHER chain's worker — the peer a pull
        would come from, so the prediction prices the wire leg at that
        peer's slice (ICI class on a match) and codec width."""
        best_w, best_ov = None, 0
        for w, ov in overlaps.scores.items():
            if w != worker_id and (ov > best_ov or (ov == best_ov and
                                                    best_w is not None
                                                    and w < best_w)):
                best_w, best_ov = w, ov
        if best_w is None:
            return None
        return endpoints.by_id.get(best_w)

    def choose_peer(
        self,
        endpoints: ProcessedEndpoints,
        overlaps: OverlapScores,
        worker_id: int,
        n_hint: int,
    ) -> tuple[Optional[int], int]:
        """Pick the peer a prefetch hint should name: the NEAREST
        adequate peer, not the deepest. Candidates are workers whose
        chain outruns the routed worker's own tiers; with the routed
        worker's calibration in hand each candidate is scored by net
        benefit = prefill saved − predicted pull cost (priced at the
        ICI class when the peer shares the routed worker's slice), so a
        same-slice peer covering the chain beats a deeper peer across
        DCN whenever the extra depth isn't worth the slower wire. Cold
        model (or a pull predicted to cost more than recompute for
        every candidate) falls back to the deepest-chain rule.
        Deterministic: ties break on depth then worker id."""
        tier_cov = min(overlaps.scores.get(worker_id, 0), n_hint)
        cands = sorted(
            (w, min(ov, n_hint))
            for w, ov in overlaps.scores.items()
            if w != worker_id and min(ov, n_hint) > tier_cov
        )
        if not cands:
            return None, 0
        load = endpoints.by_id.get(worker_id)
        scored = None
        if (
            self.cfg.cost_model
            and load is not None
            and load.cost_obs >= self.cfg.cost_min_obs
            and load.prefill_tok_s > 0
            and load.block_bytes > 0
            and load.block_size > 0
        ):
            link_gbps = load.link_gbps or {}
            scored = []
            for w, depth in cands:
                extra = depth - tier_cov
                peer = endpoints.by_id.get(w)
                link = (
                    "ici"
                    if peer is not None and load.slice_fp
                    and peer.slice_fp == load.slice_fp
                    and link_gbps.get("ici")
                    else "peer"
                )
                # the WIRE leg moves bytes at the SERVING PEER's codec
                # width (the peer serves its stored form — a full-width
                # peer ships full-width bytes to a quantized puller, and
                # vice versa), so price the pull with the peer's
                # advertisement; the LANDING leg re-encodes into this
                # worker's own tiers and restores at its width
                peer_bb = (
                    peer.wire_bytes_per_block
                    if peer is not None and peer.wire_bytes_per_block
                    else load.wire_bytes_per_block
                )
                pull = link_leg_ms(
                    link_gbps, load.link_lat_ms, link, extra * peer_bb
                )
                # the pulled chain lands in host staging and still pays
                # the h2d restore leg — same pricing as predict's pull
                # term, or the two would disagree on whether a pull
                # beats recompute
                land = restore_leg_ms(
                    link_gbps, load.link_lat_ms,
                    extra * load.wire_bytes_per_block,
                )
                if pull is None or land is None:
                    scored = None  # cold pull/restore -> deepest fallback
                    break
                saved_ms = extra * load.block_size / load.prefill_tok_s * 1e3
                scored.append((saved_ms - pull - land, depth, w))
        if scored:
            net, depth, w = max(
                scored, key=lambda t: (t[0], t[1], -t[2])
            )
            if net <= 0:
                # every pull costs more than recomputing the blocks —
                # don't name a peer at all (the hint's local restore
                # still fires)
                return None, 0
            return w, depth
        # cold-start / overlap-only: deepest chain, worker id tie-break
        w, depth = max(cands, key=lambda t: (t[1], -t[0]))
        return w, depth

    def request_finished(self, worker_id: int) -> None:
        """Release the optimistic bump once the request lands/completes."""
        n = self._pending.get(worker_id, 0)
        if n <= 1:
            self._pending.pop(worker_id, None)
        else:
            self._pending[worker_id] = n - 1

    def emit_prefetch(
        self, worker_id: int, blocks: list,
        peer_worker_id: Optional[int] = None, peer_blocks: int = 0,
        model: Optional[str] = None,
    ) -> None:
        """Ship the routed request's block-hash chain to the chosen
        worker as a prefetch hint ((tokens_hash, block_hash) pairs in
        prompt order) — fired when the worker's known device overlap
        doesn't cover the prompt, so the worker can start its host-tier
        h2d upload before the request arrives (engine.prefetch_hint).
        ``peer_worker_id`` names the peer whose radix chain covers the
        prompt deeper than the routed worker's own tiers (to depth
        ``peer_blocks``) — the worker pulls the continuation from that
        peer's host/disk tier over the transfer plane (fleet prefix
        cache). ``model`` names the routed model/adapter so the worker
        can pre-stage its weights (PRESERVE) alongside the KV.
        Best-effort: a lost hint only costs the overlap."""
        if self.drt is None or self._prefetch_subject is None or not blocks:
            return
        capped = blocks[:KV_PREFETCH_MAX_BLOCKS]
        hint = KvPrefetchHint(
            worker_id, [[l, s] for l, s in capped],
            peer_worker_id=peer_worker_id,
            peer_blocks=min(peer_blocks, len(capped)),
            model=model,
        )
        try:
            self.drt.bus.publish(self._prefetch_subject, hint.to_bytes())
            self.prefetch_hints_sent += 1
        except Exception:  # noqa: BLE001
            logger.debug("prefetch-hint publish failed", exc_info=True)

    def _emit_hit_rate(self, worker_id: int, isl_blocks: int, overlap: int) -> None:
        if self.drt is None or self._hit_subject is None:
            return
        try:
            self.drt.bus.publish(
                self._hit_subject,
                KVHitRateEvent(
                    worker_id, isl_blocks, overlap,
                    # -1 = the decision fell back to overlap scoring
                    # (cold start / cost model off) — the metrics
                    # component skips the gauge for those
                    predicted_ttft_ms=(
                        round(self.last_predicted_ttft_ms, 3)
                        if self.last_predicted_ttft_ms is not None else -1.0
                    ),
                ).to_bytes(),
            )
        except Exception:  # noqa: BLE001
            logger.debug("hit-rate publish failed", exc_info=True)
