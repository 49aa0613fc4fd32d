"""The port's KV router (``dynamo_tpu_torch.kv_router``) on the CPU: copies
of the in-process cases of ``tests/test_kv_router.py``,
``tests/test_cost_routing.py`` (the router-side cost model) and the
windowed-tail cases of ``tests/test_autopilot.py``, pointed at the port;
the KV events a port worker publishes held byte for byte to the
reference's for the same allocator actions; and two fleets on tiny f32
models with the same numpy weights, each routing a repeated prompt to the
worker that holds it: a ``JaxEngine`` worker on the reference's runtime
and a ``TorchEngine`` worker on the port's behind the reference's hub and
router, and a port-only fleet (hub, router, two ``TorchEngine`` workers).
The launcher's hub + two workers + KV-routed frontend, as processes, is
the slow case at the end."""

import asyncio
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

import dynamo_tpu.kv_router as ref_kv
import dynamo_tpu.runtime as ref_rt
import dynamo_tpu.runtime.hub as ref_hub
import dynamo_tpu_torch.kv_router as port_kv
import dynamo_tpu_torch.runtime as port_rt
import dynamo_tpu_torch.runtime.hub as port_hub
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.engine import allocator as ref_alloc
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu_torch.autopilot.tails import TailTracker, delta_hist
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine import allocator as port_alloc
from dynamo_tpu_torch.engine.allocator import sequence_block_hashes
from dynamo_tpu_torch.engine.hist import MS_BUCKETS, Histogram
from dynamo_tpu_torch.kv_router import (
    KvRouter,
    OverlapScores,
    PrefixIndex,
    ProcessedEndpoints,
    RouterEvent,
    WorkerLoad,
)
from dynamo_tpu_torch.kv_router.costmodel import (
    predict_worker_ttft_ms,
    tail_adjusted_ttft_ms,
)
from dynamo_tpu_torch.kv_router.protocols import (
    KV_PREFETCH_SUBJECT,
    KvCacheEvent,
    KvPrefetchHint,
    StoredBlock,
)
from dynamo_tpu_torch.kv_router.scheduler import (
    AllWorkersBusy,
    KvScheduler,
    SchedulerConfig,
)
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, LocalBus, LocalStore

REPO = Path(__file__).resolve().parent.parent
T = 10.0  # bound on every network wait


def _hashes(tokens, bs=4):
    return [s for _l, s in sequence_block_hashes(tokens, bs)]


def _stored_event(worker, tokens, bs=4):
    hashes = sequence_block_hashes(tokens, bs)
    blocks = [StoredBlock(block_hash=s, tokens_hash=l) for l, s in hashes]
    return RouterEvent(worker, KvCacheEvent.stored(None, blocks))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


# ---------------- index ----------------


def test_index_find_matches_depth():
    idx = PrefixIndex()
    tokens = list(range(16))  # 4 blocks
    idx.apply_event(_stored_event(1, tokens))
    idx.apply_event(_stored_event(2, tokens[:8]))  # worker 2 has 2 blocks

    scores = idx.find_matches(_hashes(tokens))
    assert scores.scores == {1: 4, 2: 2}
    assert scores.total_blocks == 4

    # divergent suffix: only shared prefix counts
    other = tokens[:8] + [99, 98, 97, 96]
    scores = idx.find_matches(_hashes(other))
    assert scores.scores == {1: 2, 2: 2}


def test_index_removed_and_remove_worker():
    idx = PrefixIndex()
    tokens = list(range(16))
    idx.apply_event(_stored_event(1, tokens))
    idx.apply_event(_stored_event(2, tokens))
    h = _hashes(tokens)
    # worker 1 evicts the second block -> its chain depth ends at 1
    idx.apply_event(RouterEvent(1, KvCacheEvent.removed([h[1]])))
    scores = idx.find_matches(h)
    assert scores.scores == {1: 1, 2: 4}
    # worker 2 dies entirely
    idx.remove_worker(2)
    scores = idx.find_matches(h)
    assert scores.scores == {1: 1}


# ---------------- scheduler ----------------


def make_eps(*loads):
    return ProcessedEndpoints([
        WorkerLoad(worker_id=i + 1, kv_active_blocks=int(u * 100), kv_total_blocks=100,
                   active_requests=a, total_slots=8, waiting=w)
        for i, (u, a, w) in enumerate(loads)
    ])


def test_scheduler_prefers_overlap_when_balanced():
    s = KvScheduler()
    eps = make_eps((0.5, 2, 0), (0.5, 2, 0))
    overlaps = OverlapScores(scores={2: 8}, total_blocks=10)
    assert s.select_worker(eps, overlaps, 10) == 2


def test_scheduler_prefers_load_in_balance_mode():
    s = KvScheduler()
    # huge load skew: worker 1 nearly full, worker 2 empty
    eps = make_eps((0.95, 7, 0), (0.05, 0, 0))
    overlaps = OverlapScores(scores={1: 10}, total_blocks=10)
    # balance mode outweighs the perfect overlap on worker 1
    assert s.select_worker(eps, overlaps, 10) == 2


def test_scheduler_avoid_set_soft_excludes():
    s = KvScheduler()
    eps = make_eps((0.5, 2, 0), (0.5, 2, 0))
    overlaps = OverlapScores(scores={1: 10}, total_blocks=10)
    assert s.select_worker(eps, overlaps, 10, avoid=frozenset({1})) == 2
    s.request_finished(2)
    # soft: when the avoid set covers every candidate, still pick one
    assert s.select_worker(eps, overlaps, 10, avoid=frozenset({1, 2})) in (1, 2)


def test_scheduler_all_busy_and_optimistic_bump():
    s = KvScheduler()
    eps = make_eps((0.5, 8, 3), (0.5, 8, 1))
    with pytest.raises(AllWorkersBusy):
        s.select_worker(eps, OverlapScores(), 4)
    # optimistic bumps spread ties
    eps = make_eps((0.5, 0, 0), (0.5, 0, 0))
    first = s.select_worker(eps, OverlapScores(), 4)
    second = s.select_worker(eps, OverlapScores(), 4)
    assert {first, second} == {1, 2}
    s.request_finished(first)
    s.request_finished(second)


# ---------------- the router-side cost model ----------------


def _calibrated_load(wid, link_gbps, tok_s=10_000.0, obs=50, **kw):
    kw.setdefault("total_slots", 8)
    kw.setdefault("kv_total_blocks", 100)
    return WorkerLoad(
        worker_id=wid, cost_obs=obs, link_gbps=dict(link_gbps),
        prefill_tok_s=tok_s, block_bytes=1 << 20, block_size=16, **kw,
    )


def test_predict_matrix_device_hot_vs_deep_tier_flips_with_link():
    # candidate DEEP holds all 20 blocks but only in host/disk tiers;
    # candidate HOT holds 12 hot on device. 1 MiB blocks.
    overlaps = OverlapScores(
        scores={1: 20, 2: 12}, total_blocks=20, device_scores={1: 0}
    )
    slow = _calibrated_load(1, {"host": 0.001, "disk": 0.001})
    hot = _calibrated_load(2, {"host": 1.0})
    p_slow = predict_worker_ttft_ms(slow, overlaps, 20)
    p_hot = predict_worker_ttft_ms(hot, overlaps, 20)
    assert p_slow > p_hot
    s = KvScheduler()
    eps = ProcessedEndpoints([slow, hot])
    assert s.select_worker(eps, overlaps, 20) == 2
    assert s.last_predicted_ttft_ms == pytest.approx(p_hot)
    assert s.route_cost_decisions == 1
    s.request_finished(2)
    # fast restore link: the deeper chain wins (restore ≈ free)
    fast = _calibrated_load(1, {"host": 100.0, "disk": 100.0})
    eps = ProcessedEndpoints([fast, hot])
    assert s.select_worker(eps, overlaps, 20) == 1


def test_predict_queue_wait_term():
    overlaps = OverlapScores(scores={1: 20, 2: 12}, total_blocks=20,
                             device_scores={1: 0})
    busy = _calibrated_load(1, {"host": 100.0}, active_requests=1,
                            total_slots=1)
    idle = _calibrated_load(2, {"host": 100.0})
    assert (
        predict_worker_ttft_ms(busy, overlaps, 20)
        > predict_worker_ttft_ms(idle, overlaps, 20)
    )
    # below saturation the co-location share still spreads load
    ov2 = OverlapScores(scores={}, total_blocks=20)
    half = _calibrated_load(1, {"host": 100.0}, active_requests=4)
    empty = _calibrated_load(2, {"host": 100.0})
    assert (
        predict_worker_ttft_ms(half, ov2, 20)
        > predict_worker_ttft_ms(empty, ov2, 20)
    )


def test_cost_cold_start_falls_back_to_overlap():
    overlaps = OverlapScores(scores={1: 20, 2: 12}, total_blocks=20,
                             device_scores={1: 0})
    calibrated = _calibrated_load(1, {"host": 0.001})
    cold = WorkerLoad(worker_id=2, kv_total_blocks=100, total_slots=8)
    s = KvScheduler()
    wid = s.select_worker(
        ProcessedEndpoints([calibrated, cold]), overlaps, 20
    )
    assert wid == 1  # deepest overlap, NOT the cost model's pick
    assert s.last_predicted_ttft_ms is None
    assert s.route_overlap_decisions == 1 and s.route_cost_decisions == 0


def test_tie_break_deterministic_across_scrape_order():
    overlaps = OverlapScores(scores={}, total_blocks=8)
    for cfg in (SchedulerConfig(), SchedulerConfig(cost_model=False)):
        picks = set()
        for order in ((1, 2), (2, 1)):
            s = KvScheduler(config=cfg)
            loads = [_calibrated_load(w, {"host": 1.0}) for w in order]
            picks.add(s.select_worker(
                ProcessedEndpoints(loads), overlaps, 8
            ))
        assert picks == {1}, f"{cfg.cost_model=} flapped: {picks}"
    # equal predicted TTFT but different overlap: overlap breaks first
    s = KvScheduler()
    ov = OverlapScores(scores={1: 2, 2: 2, 3: 4}, total_blocks=20,
                       device_scores={})
    loads = [_calibrated_load(w, {"host": 1e9}, tok_s=1e12)
             for w in (1, 2, 3)]
    assert s.select_worker(ProcessedEndpoints(loads), ov, 20) == 3


def test_choose_peer_nearest_adequate_not_deepest():
    overlaps = OverlapScores(
        scores={10: 2, 20: 16, 30: 20}, total_blocks=20
    )
    routed = _calibrated_load(
        10, {"ici": 10.0, "peer": 0.0005, "host": 1.0}, tok_s=1000.0)
    routed.slice_fp = "slice-A"
    near = _calibrated_load(20, {"host": 1.0})
    near.slice_fp = "slice-A"
    deep = _calibrated_load(30, {"host": 1.0})
    deep.slice_fp = "slice-B"
    eps = ProcessedEndpoints([routed, near, deep])
    s = KvScheduler()
    peer, blocks = s.choose_peer(eps, overlaps, 10, n_hint=20)
    assert (peer, blocks) == (20, 16)
    # cold model: deepest chain
    s2 = KvScheduler(config=SchedulerConfig(cost_model=False))
    assert s2.choose_peer(eps, overlaps, 10, n_hint=20) == (30, 20)
    # every pull worse than recompute -> no peer named
    slow_everything = _calibrated_load(
        10, {"ici": 1e-9, "peer": 1e-9, "host": 1.0}, tok_s=1e12)
    eps3 = ProcessedEndpoints([slow_everything, near, deep])
    assert s.choose_peer(eps3, overlaps, 10, n_hint=20) == (None, 0)
    # no restore link observed -> deepest-chain fallback
    no_restore = _calibrated_load(10, {"ici": 10.0, "peer": 1.0})
    eps4 = ProcessedEndpoints([no_restore, near, deep])
    assert s.choose_peer(eps4, overlaps, 10, n_hint=20) == (30, 20)


def test_worker_load_from_stats_roundtrips_cost_fields():
    d = {
        "kv_active_blocks": 5, "kv_total_blocks": 50,
        "kv_cost_obs_total": 9, "kv_link_gbps": {"host": 2.5, "ici": 40.0},
        "kv_link_lat_ms": {"host": 0.7}, "kv_prefill_tok_s": 1234.5,
        "kv_block_bytes": 4096,
        "kv_block_size": 16, "kv_slice_fp": "abc123",
        "ici_handoffs": 3, "peer_serve_d2h_blocks_total": 7,
        "weight_prestage_requests": 2,
    }
    w = WorkerLoad.from_stats(42, d, ts=1.0)
    assert w.cost_obs == 9 and w.link_gbps == {"host": 2.5, "ici": 40.0}
    assert w.link_lat_ms == {"host": 0.7}
    assert w.prefill_tok_s == 1234.5 and w.block_bytes == 4096
    assert w.slice_fp == "abc123" and w.ici_handoffs == 3
    assert w.peer_serve_d2h_blocks == 7 and w.weight_prestage_requests == 2


def test_worker_load_reads_a_torch_workers_scrape_as_the_reference_does():
    """The same ``load_metrics`` payload through the port's and the
    reference's ``WorkerLoad.from_stats``: equal fields."""
    eng = TorchEngine(EngineConfig(model=ModelConfig.tiny(dtype="float32"),
                                   **GEOMETRY), device="cpu")
    d = json.loads(json.dumps(eng.load_metrics() | eng.stats))
    got = WorkerLoad.from_stats(3, d, ts=5.0)
    ref = ref_kv.WorkerLoad.from_stats(3, d, ts=5.0)
    assert got.__dict__ == ref.__dict__


# ---------------- windowed tails ----------------


def _vec(values):
    h = Histogram(MS_BUCKETS)
    for v in values:
        h.observe(v)
    return h.to_vec()


def test_tail_tracker_windows_out_old_history():
    clk = FakeClock(1000.0)
    tt = TailTracker(window_s=10.0, q=0.99, min_count=8, clock=clk)
    slow = [5000.0] * 50  # the bad era
    tt.observe(1, {"queue_wait_ms": _vec(slow)}, ts=clk())
    clk.advance(12.0)  # bad era ages out of the window
    tt.observe(1, {"queue_wait_ms": _vec(slow)}, ts=clk())
    clk.advance(5.0)
    fast = slow + [2.0] * 20  # cumulative: old stalls + new fast era
    tt.observe(1, {"queue_wait_ms": _vec(fast)}, ts=clk())
    tail = tt.tail_ms(1)
    assert tail is not None and tail < 50.0


def test_tail_tracker_sees_fresh_pathology():
    clk = FakeClock(1000.0)
    tt = TailTracker(window_s=10.0, q=0.99, min_count=8, clock=clk)
    fast = [2.0] * 500
    tt.observe(1, {"queue_wait_ms": _vec(fast)}, ts=clk())
    clk.advance(11.0)
    tt.observe(1, {"queue_wait_ms": _vec(fast)}, ts=clk())
    clk.advance(5.0)
    sick = fast + [4000.0] * 10  # last 5s: stalls
    tt.observe(1, {"queue_wait_ms": _vec(sick)}, ts=clk())
    tail = tt.tail_ms(1)
    assert tail is not None and tail > 1000.0


def test_tail_min_count_gates_thin_evidence():
    clk = FakeClock(1000.0)
    tt = TailTracker(window_s=10.0, min_count=8, clock=clk)
    tt.observe(1, {"queue_wait_ms": _vec([1.0])}, ts=clk())
    assert tt.tail_ms(1) is None  # single snapshot: no window at all
    clk.advance(11.0)
    tt.observe(1, {"queue_wait_ms": _vec([1.0] * 4)}, ts=clk())
    assert tt.tail_ms(1) is None  # 3 window samples < min_count
    clk.advance(2.0)
    tt.observe(1, {"queue_wait_ms": _vec([1.0] * 20)}, ts=clk())
    assert tt.tail_ms(1) is not None


def test_tail_counter_reset_rebases_window():
    clk = FakeClock(1000.0)
    tt = TailTracker(window_s=10.0, min_count=1, clock=clk)
    tt.observe(1, {"queue_wait_ms": _vec([1.0] * 20)}, ts=clk())
    clk.advance(11.0)
    # engine restarted: cumulative counts went DOWN
    tt.observe(1, {"queue_wait_ms": _vec([1.0] * 5)}, ts=clk())
    assert tt.tail_ms(1) is None
    assert tt.rebases == 1
    clk.advance(2.0)
    tt.observe(1, {"queue_wait_ms": _vec([1.0] * 9)}, ts=clk())
    assert tt.tail_ms(1) is not None


def test_delta_hist_rejects_bounds_skew():
    a = Histogram(MS_BUCKETS)
    a.observe(5.0)
    b = Histogram(MS_BUCKETS[:-4])
    b.observe(5.0)
    assert delta_hist(a.to_vec(), b.to_vec()) is None
    assert delta_hist(a.to_vec(), {"garbage": 1}) is None
    assert delta_hist(a.to_vec(), None) is not None


def test_tail_adjusted_ttft_floors_prediction():
    assert tail_adjusted_ttft_ms(10.0, None) == 10.0
    assert tail_adjusted_ttft_ms(10.0, 3.0) == 10.0
    assert tail_adjusted_ttft_ms(10.0, 250.0) == 250.0


def test_scheduler_tail_fold_reroutes_bimodal_worker():
    clk = FakeClock(1000.0)
    s = KvScheduler(
        config=SchedulerConfig(tail_window_s=10.0, tail_min_count=8),
        clock=clk,
    )

    def eps_with(hists1):
        mk = lambda wid, h: WorkerLoad(  # noqa: E731
            worker_id=wid, total_slots=8, kv_total_blocks=100,
            cost_obs=50, link_gbps={"host": 1.0}, prefill_tok_s=10_000.0,
            block_bytes=1 << 20, block_size=16, hists=h, ts=clk(),
        )
        return ProcessedEndpoints([mk(1, hists1), mk(2, {})])

    assert s.select_worker(eps_with({}), OverlapScores(), 4) == 1
    s.request_finished(1)
    base = [2.0] * 100
    s.tails.observe(1, {"queue_wait_ms": _vec(base)}, ts=clk())
    clk.advance(11.0)
    s.tails.observe(1, {"queue_wait_ms": _vec(base)}, ts=clk())
    clk.advance(5.0)
    sick = _vec(base + [8000.0] * 10)
    picked = s.select_worker(
        eps_with({"queue_wait_ms": sick}), OverlapScores(), 4
    )
    assert picked == 2
    assert s.route_tail_overrides >= 1
    s.request_finished(picked)


# ---------------- prefetch hints ----------------


def test_schedule_emits_prefetch_hint_for_uncovered_prompt(run):
    """Routing a request whose prompt extends past the chosen worker's
    device radix match ships the block-hash chain on the component's
    kv-prefetch subject (a reference worker's listener consumes it); a
    fully-covered prompt does not."""
    async def main():
        store, bus = LocalStore(), LocalBus()
        drt = await DistributedRuntime.from_settings(store=store, bus=bus)
        comp = drt.namespace("dyn").component("worker")
        router = await KvRouter(drt, comp, block_size=4).start()
        router.metrics.endpoints = make_eps((0.1, 1, 0))  # worker 1

        sub = bus.subscribe(comp.event_subject(KV_PREFETCH_SUBJECT))
        prompt = list(range(300, 324))  # 6 blocks, index cold
        wid, overlap = await router.schedule(prompt)
        assert wid == 1 and overlap == 0
        msg = await sub.next(1.0)
        assert msg is not None
        hint = KvPrefetchHint.from_bytes(msg.payload)
        assert hint.worker_id == 1
        pairs = sequence_block_hashes(prompt, 4)
        # block-multiple prompt: the final block can never be claimed by
        # admission (it hashes prompt[:-1]), so the hint excludes it
        assert hint.blocks == [[l, s] for l, s in pairs[:-1]]
        router.request_finished(wid)

        # full coverage: worker 1 now holds the whole chain -> no hint
        router.indexer.index.apply_event(_stored_event(1, prompt))
        wid, overlap = await router.schedule(prompt)
        assert wid == 1 and overlap == len(pairs)
        assert await sub.next(0.2) is None
        await drt.shutdown()

    run(main())


# ---------------- KV events on the wire ----------------


class _Capture:
    """A runtime stand-in whose bus keeps what is published."""

    def __init__(self):
        self.sent = []
        self.bus = types.SimpleNamespace(
            publish=lambda subject, payload: self.sent.append((subject, payload)))


def _allocator_actions(alloc_mod, publisher_cls, component):
    drt = _Capture()
    pub = publisher_cls(drt, component, 0x1F)
    alloc = alloc_mod.BlockAllocator(8, 4)
    pub.attach(alloc)
    toks = list(range(40, 56))  # 4 full blocks
    blocks = alloc.allocate(4)
    parent = None
    for i, b in enumerate(blocks):
        parent = alloc.commit_full_block(b, toks[4 * i:4 * i + 4], parent)
    alloc.free(blocks)
    # the same prompt again claims the chain from the reuse pool
    alloc.free(alloc.match_prefix(toks))
    # a cold allocation big enough to evict the reuse pool
    fresh = alloc.allocate(7)
    alloc.free(fresh)
    return drt.sent


def test_kv_events_are_the_references_bytes():
    """The same allocator actions (commit a 4-block chain, free it, claim
    it again, evict it) publish the same subjects and payload bytes from
    the port's allocator + publisher as from the reference's; a port index
    fed the port's events answers as a reference index fed its own."""
    port_comp = port_rt.Component(None, "dynamo", "backend")
    ref_comp = ref_rt.Component(None, "dynamo", "backend")
    got = _allocator_actions(port_alloc, port_kv.KvEventPublisher, port_comp)
    ref = _allocator_actions(ref_alloc, ref_kv.KvEventPublisher, ref_comp)
    assert got == ref
    kinds = [json.loads(p)["kind"] for _s, p in got]
    assert kinds.count("stored") == 4 and "removed" in kinds
    assert {s for s, _p in got} == {"dynamo.backend.kv_events"}
    pidx, ridx = port_kv.PrefixIndex(), ref_kv.PrefixIndex()
    for _s, p in got[:4]:
        pidx.apply_event(port_kv.RouterEvent.from_bytes(p))
        ridx.apply_event(ref_kv.RouterEvent.from_bytes(p))
    h = _hashes(list(range(40, 56)))
    assert pidx.find_matches(h).scores == ridx.find_matches(h).scores == {0x1F: 4}
    ev = port_kv.RouterEvent.from_bytes(got[0][1])
    assert ev.to_bytes() == ref_kv.RouterEvent.from_bytes(got[0][1]).to_bytes()


# ---------------- fleets: a repeated prompt routes to its holder ----------------

GEOMETRY = dict(num_blocks=64, block_size=4, max_batch_size=4,
                max_context=128, prefill_chunk=32)
PROMPT_A = list(range(100, 124))  # 6 blocks of 4
PROMPT_B = list(range(200, 224))


def _jax_engine():
    cfg = JaxModelConfig.tiny(dtype="float32")
    return JaxEngine(JaxEngineConfig(model=cfg, **GEOMETRY), seed=0)


def _torch_engine_like(jeng):
    cfg = ModelConfig.tiny(dtype="float32")
    tree = jax.tree.map(np.asarray, jeng.params)
    return TorchEngine(EngineConfig(model=cfg, **GEOMETRY),
                       params=from_jax_params(tree, cfg), device="cpu")


def _req(tokens):
    return PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=StopConditions(max_tokens=4),
        sampling_options=SamplingOptions(temperature=0.0),
        eos_token_ids=[511],
    ).to_dict()


def _tokens(items):
    """Token ids of a stream: Annotated dicts off the wire, or an engine's
    own outputs."""
    out = []
    for a in items:
        data = getattr(a, "data", a)
        out += data.get("token_ids", []) if isinstance(data, dict) else data.token_ids
    return out


PORT = types.SimpleNamespace(rt=port_rt, kv=port_kv, hub=port_hub)
REF = types.SimpleNamespace(rt=ref_rt, kv=ref_kv, hub=ref_hub)


async def _start_worker(impl, hub_address, engine):
    store, bus, conn = await asyncio.wait_for(impl.hub.connect_hub(hub_address), T)
    drt = await impl.rt.DistributedRuntime.from_settings(store=store, bus=bus)
    comp = drt.namespace("dyn").component("worker")
    impl.kv.KvEventPublisher(drt, comp, drt.primary_lease_id).attach(engine.allocator)
    await comp.endpoint("gen").serve(engine, stats_handler=engine.load_metrics)
    return drt, conn


async def _drive_fleet(front, hub_address, engines):
    """Two workers behind ``front``'s KV router: prompt A through the router,
    prompt B pinned to the other worker; once the index and a scrape have
    caught up, each prompt schedules onto its holder with at least 5 of its
    6 blocks matched, and streams the same greedy tokens again. Returns
    the greedy tokens each worker gave for A and for B."""
    workers = []
    for impl, engine in engines:
        workers.append(await _start_worker(impl, hub_address, engine))
    store, bus, fconn = await asyncio.wait_for(front.hub.connect_hub(hub_address), T)
    drt = await front.rt.DistributedRuntime.from_settings(store=store, bus=bus)
    comp = drt.namespace("dyn").component("worker")
    client = await comp.endpoint("gen").client().start()
    for _ in range(500):
        if len(client.instance_ids()) == 2:
            break
        await asyncio.sleep(0.01)
    assert len(client.instance_ids()) == 2
    router = await asyncio.wait_for(front.kv.KvRouter(drt, comp, block_size=4).start(), T)
    routed = front.kv.router.KvRoutedEngine(router, client)
    Ctx, collect = front.rt.Context, front.rt.collect

    async def tokens(stream):
        return _tokens(await asyncio.wait_for(collect(stream), 60))

    async def holder(prompt):
        """The one worker the index places the prompt on, once >= 5 of its
        blocks have arrived as events."""
        for _ in range(500):
            scores = router.indexer.find_matches(_hashes(prompt)).scores
            if len(scores) == 1 and max(scores.values()) >= 5:
                break
            await asyncio.sleep(0.02)
        assert len(scores) == 1, scores
        return next(iter(scores))

    out_a = await tokens(routed.generate(Ctx(_req(PROMPT_A))))
    holders = {"A": await holder(PROMPT_A)}
    other = next(w for w in client.instance_ids() if w != holders["A"])
    out_b = await tokens(await client.direct(Ctx(_req(PROMPT_B)), other))
    holders["B"] = await holder(PROMPT_B)
    assert holders["A"] != holders["B"]

    def all_idle():
        eps = router.metrics.endpoints
        return len(eps.loads) == 2 and all(
            l.active_requests == 0 and l.waiting == 0 for l in eps.loads)

    for _ in range(30):  # completed scrapes, not ticks of a clock
        if all_idle():
            break
        await router.metrics.next_scrape(timeout=T)
    assert all_idle()
    for name, prompt in (("A", PROMPT_A), ("B", PROMPT_B)):
        wid, overlap = await router.schedule(prompt)
        assert wid == holders[name] and overlap >= 5, (name, wid, overlap)
        router.request_finished(wid)
    assert await tokens(routed.generate(Ctx(_req(PROMPT_A)))) == out_a
    # dead-worker cleanup drops its residency from the index
    router.remove_worker(holders["A"])
    assert router.indexer.find_matches(_hashes(PROMPT_A)).scores == {}
    # each prompt on the worker that does not hold it, for the token check
    cross_a = await tokens(await client.direct(Ctx(_req(PROMPT_A)), holders["B"]))
    cross_b = await tokens(await client.direct(Ctx(_req(PROMPT_B)), holders["A"]))
    by_worker = {holders["A"]: (out_a, cross_b), holders["B"]: (cross_a, out_b)}
    for wdrt, wconn in workers:
        await wdrt.shutdown()
        await wconn.close()
    await drt.shutdown()
    await fconn.close()
    return [by_worker[w.worker_id] for w, _c in workers]


def test_mixed_fleet_behind_the_reference_router(run):
    """The reference's TCP hub and KV router in front of one ``JaxEngine``
    worker (reference runtime and publisher) and one ``TorchEngine`` worker
    (the port's), sharing one index: each worker's prompt routes back to
    it, and both workers give the same greedy tokens for both prompts."""
    jeng = _jax_engine()
    teng = _torch_engine_like(jeng)

    async def main():
        hub = ref_hub.HubServer()
        await hub.start()
        try:
            return await _drive_fleet(REF, hub.address, [(REF, jeng), (PORT, teng)])
        finally:
            await hub.close()
            await jeng.close()
            await teng.close()

    (jax_a, jax_b), (torch_a, torch_b) = run(main())
    assert len(jax_a) == len(jax_b) == 4
    assert torch_a == jax_a and torch_b == jax_b


def test_port_fleet_behind_the_port_router(run):
    """The port's hub and KV router in front of two ``TorchEngine`` workers
    on the port's runtime: each prompt routes back to its holder, and the
    greedy tokens equal a ``JaxEngine``'s with the same weights."""
    jeng = _jax_engine()
    engines = [_torch_engine_like(jeng), _torch_engine_like(jeng)]

    async def main():
        hub = port_hub.HubServer()
        await hub.start()
        try:
            fleet = await _drive_fleet(PORT, hub.address,
                                       [(PORT, e) for e in engines])
            ref = []
            for prompt in (PROMPT_A, PROMPT_B):
                ref.append(_tokens(await ref_rt.collect(jeng.generate(
                    ref_rt.Context(_req(prompt))))))
            return fleet, ref
        finally:
            await hub.close()
            await jeng.close()
            for e in engines:
                await e.close()

    fleet, ref = run(main())
    assert [list(ab) for ab in fleet] == [ref, ref]


# ---------------- the launcher's roles, as processes ----------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, path, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


async def _scrape(hub_address):
    store, bus, conn = await asyncio.wait_for(port_hub.connect_hub(hub_address), T)
    drt = await DistributedRuntime.from_settings(store=store, bus=bus)
    try:
        comp = drt.namespace("dynamo").component("backend")
        return {s["instance_id"]: s["data"]
                for s in await comp.scrape_stats(timeout=T)}
    finally:
        await drt.shutdown()
        await conn.close()


@pytest.mark.slow
def test_dynamo_run_hub_two_workers_and_kv_frontend():
    """``dynamo_run hub``, two ``in=dyn://… out=torch`` workers on the tiny
    preset and an ``in=http out=dyn://… --router kv`` frontend with no card
    visible, each its own process: the frontend serves the model, a
    repeated prompt is served from one worker's prefix cache, and SIGTERM on
    a worker revokes its lease (discovery drops it at once), exits 0, and
    leaves the model served by the other."""
    hub_port, http_port = _free_port(), _free_port()
    hub = f"127.0.0.1:{hub_port}"
    mod = [sys.executable, "-m", "dynamo_tpu_torch.launch.dynamo_run"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    common = ["--hub", hub, "--model-path", "tiny", "--host", "127.0.0.1"]
    procs = []

    def spawn(args):
        p = subprocess.Popen(mod + args, cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        # a thread drains the child's output, so neither a silent child nor
        # a full pipe can block the test past its deadlines
        p.lines = queue.Queue()
        p.reader = threading.Thread(
            target=lambda: [p.lines.put(x) for x in p.stdout], daemon=True)
        p.reader.start()
        procs.append(p)
        return p

    def wait_line(p, needle, timeout=120):
        deadline = time.monotonic() + timeout
        while (left := deadline - time.monotonic()) > 0:
            try:
                line = p.lines.get(timeout=min(left, 1.0))
            except queue.Empty:
                if p.poll() is not None and p.lines.empty():
                    break
                continue
            if needle in line:
                return line
        raise AssertionError(f"{needle!r} not printed")

    try:
        wait_line(spawn(["hub", "--host", "127.0.0.1", "--hub-port", str(hub_port)]),
                  "hub listening")
        workers = [spawn(["in=dyn://dynamo.backend.generate", "out=torch",
                          "--device", "cpu"] + common) for _ in range(2)]
        for w in workers:
            wait_line(w, "serving 'tiny'")
        front = spawn(["in=http", "out=dyn://dynamo.backend.generate", "--router", "kv",
                       "--http-port", str(http_port)] + common)
        wait_line(front, "OpenAI server")
        prompt = "a long shared prefix for the KV router " * 3
        req = {"model": "tiny", "prompt": prompt, "max_tokens": 4, "temperature": 0.0}
        first = _post(http_port, "/v1/completions", req)
        time.sleep(2.5)  # a metrics scrape after the first completes
        second = _post(http_port, "/v1/completions", req)
        assert second["choices"][0]["text"] == first["choices"][0]["text"]
        stats = asyncio.run(_scrape(hub))
        assert len(stats) == 2
        hits = {w: d["prefix_cache_hits_tokens"] for w, d in stats.items()}
        assert sorted(v > 0 for v in hits.values()) == [False, True], hits
        # SIGTERM: lease revoked, process gone, the model still served
        workers[0].send_signal(signal.SIGTERM)
        assert workers[0].wait(timeout=30) == 0
        left = asyncio.run(_scrape(hub))
        assert len(left) == 1
        third = _post(http_port, "/v1/completions", req)
        assert third["choices"][0]["text"] == first["choices"][0]["text"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            p.reader.join(timeout=10)
            p.stdout.close()
