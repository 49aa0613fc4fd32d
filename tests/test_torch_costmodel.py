"""The worker-side transfer-cost model of the port against the reference.

``dynamo_tpu_torch/kv_router/costmodel.py`` carries both halves of the
reference's ``kv_router/costmodel.py``. Here: the reference's cost-model
unit cases, pointed at the port's ``TransferCostModel``; and the prefill
rate a ``TorchEngine`` advertises against a ``JaxEngine``'s under the same
dedicated-chunk timings (a fake clock): equal ``counters()`` after two
chunks at 1000 and 20 000 tok/s (2750.0: the EWMA with its 8x clamp), 0.0
after the estimate's ``obs_ttl_s`` of idle, and a prompt that prefills in
fused mixed steps feeds neither engine.
"""

import asyncio
import time as _real_time

import jax
import numpy as np
import pytest

import dynamo_tpu.engine.engine as jax_engine_mod
import dynamo_tpu_torch.engine.engine as torch_engine_mod
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.kv_router.costmodel import TransferCostModel as RefCostModel
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStops
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu.runtime import collect as jax_collect
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.kv_router.costmodel import TransferCostModel
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context, collect

GEOMETRY = dict(num_blocks=64, block_size=4, max_batch_size=4,
                max_context=128, prefill_chunk=32)


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


# ---------------- the reference's cost-model units ----------------


def test_costmodel_ewma_converges_and_prices_transfers():
    m = TransferCostModel(block_bytes=1 << 17)
    for _ in range(30):
        m.observe("host", 20_000_000, 0.01)  # 2 GB/s steady
    g = m.link_gbps("host")
    assert g is not None and abs(g - 2.0) < 0.05
    ms = m.transfer_ms("host", 20_000_000)
    assert 8.0 < ms < 13.0
    assert m.counters()["kv_link_gbps"]["host"] == pytest.approx(g, rel=1e-6)
    assert m.counters()["kv_cost_obs_total"] == 30


def test_costmodel_restart_clamp_bounds_one_sample():
    m = TransferCostModel()
    for _ in range(10):
        m.observe("peer", 1_000_000_000, 1.0)
    m.observe("peer", 1_000_000_000_000, 1.0)
    assert m.link_gbps("peer") < 1.0 * (1 + 0.25 * TransferCostModel.SAMPLE_CLAMP)
    m2 = TransferCostModel()
    for _ in range(10):
        m2.observe("peer", 1_000_000_000, 1.0)
    m2.observe("peer", 1_000_000, 1.0)
    assert m2.link_gbps("peer") > 1.0 / 2.0


def test_costmodel_stale_observation_ttl():
    clk = FakeClock()
    m = TransferCostModel(obs_ttl_s=60.0, clock=clk)
    m.observe("disk", 10_000_000, 0.1)
    assert m.link_gbps("disk") is not None
    clk.t += 61.0
    assert m.link_gbps("disk") is None
    assert "disk" not in m.counters()["kv_link_gbps"]
    m.observe("disk", 100_000_000, 0.1)  # 1 GB/s now: a restart
    assert m.link_gbps("disk") == pytest.approx(1.0, rel=0.01)


def test_costmodel_prefill_cold_start_and_seed_correction():
    m = TransferCostModel()
    assert m.prefill_tok_s() is None
    for _ in range(5):
        m.observe_prefill(640, 0.1)
    assert m.prefill_tok_s() == pytest.approx(6400, rel=0.05)
    s = TransferCostModel(prefill_seed_tok_s=1000.0)
    assert s.prefill_tok_s() == 1000.0
    for _ in range(50):
        s.observe_prefill(10_000, 0.1)
    assert s.prefill_tok_s() == pytest.approx(4000.0)


def test_costmodel_counters_equal_the_reference():
    """One seeded observation script through both classes (links, latency
    floors, prefill samples, idle gaps past the TTL): equal ``counters()``
    after every step."""
    clk = FakeClock()
    ref, got = RefCostModel(clock=clk), TransferCostModel(clock=clk)
    rng = np.random.default_rng(3)
    for step in range(60):
        link = ("host", "disk", "peer", "nowhere")[step % 4]
        nbytes = int(rng.integers(-10, 1 << 26))
        wall = float(rng.uniform(-1e-3, 0.5))
        tokens = int(rng.integers(-5, 4096))
        for m in (ref, got):
            m.observe(link, nbytes, wall)
            m.observe_prefill(tokens, wall)
        clk.t += float(rng.choice([0.0, 30.0, 1000.0]))
        assert got.counters() == ref.counters(), step


# ---------------- C.13: the advertised prefill rate ----------------


class _FakeTime:
    """The engine modules' ``time``: ``perf_counter`` is a fake clock that
    only the chunk wrappers advance; the rest is the real module."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def __getattr__(self, name):
        return getattr(_real_time, name)


def _time_chunks(engine, fake: _FakeTime, durations: list):
    """Wrap the engine's dedicated chunk so each takes the next of
    ``durations`` seconds on the fake clock (0.01 s once they run out)."""
    inner = engine._run_one_chunk

    def timed(seq, pos):
        out = inner(seq, pos)
        fake.t += durations.pop(0) if durations else 0.01
        return out

    engine._run_one_chunk = timed


#: one JAX model config for the module: the reference's programs compile once
JCFG = JaxModelConfig.tiny(dtype="float32")


def _engines(monkeypatch):
    jeng = JaxEngine(JaxEngineConfig(model=JCFG, **GEOMETRY), seed=0)
    tree = jax.tree.map(np.asarray, jeng.params)
    tcfg = ModelConfig.tiny(dtype="float32")
    teng = TorchEngine(EngineConfig(model=tcfg, **GEOMETRY),
                       params=from_jax_params(tree, tcfg), device="cpu")
    fakes = []
    for mod, eng in ((jax_engine_mod, jeng), (torch_engine_mod, teng)):
        fake = _FakeTime()
        monkeypatch.setattr(mod, "time", fake)
        fakes.append(fake)
        # the estimates' own clock (their age against obs_ttl_s)
        eng.cost._clock = FakeClock()
    return (jeng, teng), fakes


def test_advertised_prefill_rate_equals_the_reference(run, monkeypatch):
    """C.13: a 40-token prompt prefills in two dedicated chunks (32 and 8
    tokens) timed at 1000 and 20 000 tok/s on both engines: both advertise
    2750.0 (the second sample clamped to 8x, alpha 0.25) with equal
    counters; after 1000 s without a prefill (obs_ttl_s is 900) both
    advertise 0.0."""
    (jeng, teng), fakes = _engines(monkeypatch)
    toks = list(range(10, 50))

    async def serve(engine, fake, req, ctx, collect_fn):
        _time_chunks(engine, fake, [0.032, 0.0004])
        await collect_fn(engine.generate(ctx(req)))

    try:
        run(serve(jeng, fakes[0], JaxRequest(
            token_ids=toks, stop_conditions=JaxStops(max_tokens=2),
            sampling_options=JaxSampling(temperature=0.0)), JaxContext,
            jax_collect))
        run(serve(teng, fakes[1], PreprocessedRequest(
            token_ids=toks, stop_conditions=StopConditions(max_tokens=2),
            sampling_options=SamplingOptions(temperature=0.0)), Context, collect))
        ref, got = jeng.cost.counters(), teng.cost.counters()
        assert got == ref
        assert got["kv_prefill_tok_s"] == 2750.0 and got["kv_cost_obs_total"] == 2
        assert teng.load_metrics()["kv_prefill_tok_s"] == 2750.0
        for eng in (jeng, teng):
            eng.cost._clock.t += 1000.0
        assert teng.cost.counters() == jeng.cost.counters()
        assert teng.load_metrics()["kv_prefill_tok_s"] == 0.0
        assert jeng.load_metrics()["kv_prefill_tok_s"] == 0.0
    finally:
        run(jeng.close())
        run(teng.close())


def test_mixed_steps_feed_neither_engines_prefill_rate(run, monkeypatch):
    """A prompt that arrives while another decodes prefills in fused mixed
    steps: the decoding prompt's own dedicated chunk is each engine's only
    prefill observation."""
    (jeng, teng), fakes = _engines(monkeypatch)

    async def serve(engine, fake, mk, ctx, collect_fn):
        _time_chunks(engine, fake, [])
        first = asyncio.Event()

        async def long():
            async for o in engine.generate(ctx(mk(list(range(10, 20)), 24))):
                if o.token_ids:
                    first.set()

        async def late():
            await first.wait()
            await collect_fn(engine.generate(ctx(mk(list(range(100, 160)), 3))))

        await asyncio.gather(long(), late())

    try:
        run(serve(jeng, fakes[0], lambda t, n: JaxRequest(
            token_ids=t, stop_conditions=JaxStops(max_tokens=n),
            sampling_options=JaxSampling(temperature=0.0)), JaxContext,
            jax_collect))
        run(serve(teng, fakes[1], lambda t, n: PreprocessedRequest(
            token_ids=t, stop_conditions=StopConditions(max_tokens=n),
            sampling_options=SamplingOptions(temperature=0.0)), Context, collect))
        assert jeng.stats["mixed_steps"] > 0 and teng.stats["mixed_steps"] > 0
        assert teng.cost.counters() == jeng.cost.counters()
        assert teng.cost.counters()["kv_cost_obs_total"] == 1
    finally:
        run(jeng.close())
        run(teng.close())


class _StubEvent:
    """A CUDA event's two calls the engine makes: whether the work before
    it completed, and the ms since an earlier event."""

    def __init__(self, t_ms: float, done: bool = True):
        self.t_ms, self.done = t_ms, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end: "_StubEvent") -> float:
        return end.t_ms - self.t_ms


def test_card_chunk_timings_fold_in_order_once_complete():
    """On the card a dedicated chunk is timed by a pair of CUDA events that
    are read only once they completed: the completed ones fold into the
    cost model oldest first, as the host-clock path would fold the same
    times, and an incomplete one (and all after it) waits for a later
    call."""
    from collections import deque
    from types import SimpleNamespace

    ref = TransferCostModel(block_bytes=1 << 20)
    for tokens, s in ((512, 0.25), (16, 0.01)):
        ref.observe_prefill(tokens, s)
    eng = SimpleNamespace(cost=TransferCostModel(block_bytes=1 << 20),
                          _chunk_events=deque())
    late = _StubEvent(400.0, done=False)
    eng._chunk_events.extend([
        (512, _StubEvent(0.0), _StubEvent(250.0)),
        (16, _StubEvent(300.0), _StubEvent(310.0)),
        (64, _StubEvent(320.0), late),
    ])
    TorchEngine._observe_chunk_events(eng)
    assert len(eng._chunk_events) == 1
    assert eng.cost.counters() == ref.counters()
    late.done = True
    TorchEngine._observe_chunk_events(eng)
    ref.observe_prefill(64, 0.08)
    assert not eng._chunk_events
    assert eng.cost.counters() == ref.counters()
