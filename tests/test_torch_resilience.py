"""Migration and graceful drain in the port (``dynamo_tpu_torch.resilience``
and ``TorchEngine.drain``) on the CPU, against the reference package.

Copies of ``tests/test_resilience.py`` pointed at the port: the disconnect
classifier's taxonomy, resume-annotation continuity of a seeded sampled
stream with a frequency penalty (bit-equal to an undisturbed run), the
engine's drain (in-flight work finishes, new work bounces with the
migration signal), the drain coordinator handing a stream off at its
deadline and the migration layer finishing it on the other worker, a
``mid_drain`` fault aborting the sequence, and the migration wrapper's
policy edges over a scripted engine. And the two packages interoperating:
a stream handed off by a draining port worker resumes on a JAX worker
behind the reference's frontend, and the reverse, with greedy tokens equal
to an undisturbed run's.
"""

import asyncio

import pytest

import dynamo_tpu.resilience as ref_res
import dynamo_tpu.runtime as ref_rt
import dynamo_tpu.runtime.hub as ref_hub
import dynamo_tpu_torch.runtime.hub as port_hub
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.resilience import (
    MIGRATION_SIGNAL,
    DrainCoordinator,
    FailureKind,
    MigratingEngine,
    MigrationPolicy,
    classify_failure,
    faultpoints,
)
from dynamo_tpu_torch.runtime import (
    Annotated,
    AsyncEngine,
    Context,
    DistributedRuntime,
    EngineClient,
    LocalBus,
    LocalStore,
)
from tests.test_torch_disagg import jax_engine, torch_engine

pytestmark = pytest.mark.faultinject

TINY = ModelConfig.tiny()


def make_engine(**kw):
    cfg = EngineConfig(
        model=TINY, num_blocks=64, block_size=4, max_batch_size=4,
        max_context=128, prefill_chunk=32, **kw,
    )
    return TorchEngine(cfg, seed=0, device="cpu")


def make_req(tokens=None, max_tokens=10, temperature=0.0, seed=None,
             annotations=None, **so):
    return PreprocessedRequest(
        token_ids=list(tokens if tokens is not None else range(100, 116)),
        stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=SamplingOptions(
            temperature=temperature, seed=seed, **so
        ),
        eos_token_ids=[511],
        annotations=annotations or {},
    )


@pytest.fixture(autouse=True)
def _fault_hygiene():
    faultpoints.reset()
    yield
    faultpoints.reset()


def _chunk(item):
    """Normalize a stream item (LLMEngineOutput or Annotated[dict], of
    either package) to (token_ids, finish_reason, text, error)."""
    if hasattr(item, "is_error") and hasattr(item, "error"):
        if item.is_error():
            return [], None, None, item.error or "error"
        d = item.data or {}
        return (
            list(d.get("token_ids") or []), d.get("finish_reason"),
            d.get("text"), None,
        )
    fr = item.finish_reason.value if item.finish_reason else None
    return list(item.token_ids or []), fr, item.text, None


async def drive(engine, req, annotations=None, ctx=Context):
    """-> (tokens, finishes:list, errors:list, final_chunk_fields)."""
    toks, finishes, errors, final = [], [], [], {}
    async for item in engine.generate(ctx(req, annotations=annotations)):
        t, fr, text, err = _chunk(item)
        if err is not None:
            errors.append(err)
            continue
        toks.extend(t)
        if fr is not None:
            finishes.append(fr)
            if hasattr(item, "is_error"):
                final = dict(item.data or {})
            else:
                final = {
                    "prompt_tokens": item.prompt_tokens,
                    "completion_tokens": item.completion_tokens,
                    "text": item.text,
                }
    return toks, finishes, errors, final


async def reference_tokens(engine, req):
    toks, finishes, errors, _ = await drive(engine, req)
    assert finishes and not errors
    await engine.close()
    return toks


def test_classify_failure_taxonomy():
    assert classify_failure(
        "response stream truncated: worker connection lost"
    ) is FailureKind.WORKER_LOST
    assert classify_failure("worker shutdown: stream aborted").retryable
    assert classify_failure(MIGRATION_SIGNAL).retryable
    assert classify_failure(
        "fault injected: worker killed at mid_decode (hit 1)"
    ).retryable
    assert classify_failure(exc=ConnectionError("hub connection lost")) \
        is FailureKind.TRANSIENT
    assert classify_failure("some model error") is FailureKind.FATAL
    assert not classify_failure("some model error").retryable

    class _FakeClient:
        def __init__(self, ids):
            self._ids = ids

        def instance_ids(self):
            return self._ids

    # worker still registered -> TCP blip, not lease loss
    assert classify_failure(
        "response stream truncated: worker connection reset",
        worker_id=7, client=_FakeClient([7, 8]),
    ) is FailureKind.TRANSIENT
    assert classify_failure(
        "response stream truncated: worker connection reset",
        worker_id=7, client=_FakeClient([8]),
    ) is FailureKind.LEASE_LOST
    # the wire's words are the reference's: either frontend migrates
    # either package's streams
    assert MIGRATION_SIGNAL == ref_res.MIGRATION_SIGNAL
    assert ref_res.classify_failure(MIGRATION_SIGNAL).retryable


def test_resume_annotation_continuity_sampled_with_penalties(run):
    """A resumed request (prompt + tokens-so-far + resume annotation) on a
    FRESH engine continues the original sampled stream bit for bit: the
    per-step keys (seed, generated) pick up at the seam and the
    frequency-penalty state rebuilds from the true prompt/output split."""
    req = make_req(max_tokens=10, temperature=0.9, seed=11,
                   frequency_penalty=0.6)
    cuts = (1, 4, 9)
    ref_engine = make_engine(decode_window=1)
    resume_engines = {cut: make_engine(decode_window=1) for cut in cuts}

    async def main():
        ref = await reference_tokens(ref_engine, req)
        assert len(ref) == 10
        for cut in cuts:
            resumed = make_req(
                tokens=req.token_ids + ref[:cut], max_tokens=10,
                temperature=0.9, seed=11, frequency_penalty=0.6,
                annotations={"resume": {"prompt_len": len(req.token_ids)}},
            )
            e = resume_engines[cut]
            toks, finishes, errors, final = await drive(e, resumed)
            assert not errors and finishes == ["length"]
            assert toks == ref[cut:], f"cut={cut}"
            # usage counts from the ORIGINAL prompt, not the splice
            assert final["prompt_tokens"] == len(req.token_ids)
            assert final["completion_tokens"] == 10
            assert e.stats["migration_resumes"] == 1
            assert e.load_metrics()["migration_resumes"] == 1
            await e.close()

    run(main())


def test_drain_lets_inflight_finish_and_bounces_new_work(run):
    e = make_engine(decode_window=1)

    async def main():
        req = make_req(max_tokens=8)
        stream_task = asyncio.ensure_future(drive(e, req))
        while e.stats["requests_total"] == 0:
            await asyncio.sleep(0.005)
        res = await e.drain(deadline_s=30.0, handoff=True)
        toks, finishes, errors, _ = await stream_task
        # generous deadline: the stream finished NATURALLY, no handoff
        assert finishes == ["length"] and len(toks) == 8 and not errors
        assert res["handed_off"] == 0
        assert e.stats["drains_total"] == 1
        lm = e.load_metrics()
        assert lm["draining"] == 1 and lm["drains_total"] == 1
        assert lm["drain_handoffs"] == 0
        # new work during/after drain bounces with the migration signal
        toks2, finishes2, _e2, final2 = await drive(e, make_req())
        assert toks2 == [] and finishes2 == ["error"]
        assert final2.get("text") == MIGRATION_SIGNAL
        await e.close()

    run(main())


async def _two_worker_stack(engines):
    store, bus = LocalStore(), LocalBus()
    drts, handles = [], []
    for e in engines:
        drt = await DistributedRuntime.from_settings(store=store, bus=bus)
        h = await drt.namespace("res").component("w").endpoint("gen").serve(
            e, stats_handler=e.load_metrics
        )
        drts.append(drt)
        handles.append(h)
    front = await DistributedRuntime.from_settings(store=store, bus=bus)
    client = (
        await front.namespace("res").component("w").endpoint("gen")
        .client().start()
    )
    await client.wait_for_instances(timeout=5)
    return drts, handles, front, client


def test_drain_deadline_hands_off_and_migration_resumes(run):
    """DrainCoordinator on worker 1 with a zero deadline: the in-flight
    stream is handed off mid-decode and the migration layer finishes it
    on worker 2, bit-exact, with the lease revoked only afterwards."""
    engines = [make_engine(decode_window=1) for _ in range(2)]
    ref_engine = make_engine(decode_window=1)
    req = make_req(max_tokens=16)

    async def main():
        ref = await reference_tokens(ref_engine, make_req(max_tokens=16))
        drts, handles, front, client = await _two_worker_stack(engines)
        e1 = engines[0]
        mig = MigratingEngine(
            EngineClient(client), MigrationPolicy(max_migrations=4),
            client=client,
        )
        stream_task = asyncio.ensure_future(drive(mig, req.to_dict()))
        # round robin sends the first request to the first-leased worker;
        # wait until it is streaming tokens
        while e1.stats["tokens_generated"] < 3:
            await asyncio.sleep(0.005)
        coord = DrainCoordinator(
            drts[0], engines=[e1], handles=[handles[0]], deadline_s=0.0,
        )
        res = await coord.drain()
        assert res["handed_off"] >= 1
        toks, finishes, errors, _ = await stream_task
        assert errors == []
        assert finishes == ["length"]
        assert toks == ref
        assert mig.stats["migrations_total"] >= 1
        assert engines[1].stats["migration_resumes"] == 1
        assert e1.load_metrics()["drain_handoffs"] >= 1
        # the drained worker left discovery (lease revoked last)
        for _ in range(100):
            if len(client.instance_ids()) == 1:
                break
            await asyncio.sleep(0.02)
        assert client.instance_ids() == [drts[1].primary_lease_id]
        await e1.close()
        await engines[1].close()
        await drts[1].shutdown()
        await front.shutdown()

    run(main())


def test_mid_drain_fault_aborts_drain(run):
    """Arming ``mid_drain`` kills the coordinator right after it leaves
    discovery: the drain aborts (counted in drain_errors), the engines
    are never drained, and the aborted sequence does NOT revoke the lease
    or stop the ingress (a real mid-drain crash dies before those)."""

    class _Handle:
        def __init__(self):
            self.deregistered = False
            self.stopped = False

        async def deregister(self):
            self.deregistered = True

        def inflight_count(self):
            return 0

        async def stop(self):
            self.stopped = True

    class _Drt:
        def __init__(self):
            self.shutdowns = 0

        async def shutdown(self):
            self.shutdowns += 1

    class _Engine:
        def __init__(self):
            self.drained = 0

        async def drain(self, deadline_s=0.0, handoff=True):
            self.drained += 1
            return {"handed_off": 0}

    async def main():
        h, drt, e = _Handle(), _Drt(), _Engine()
        coord = DrainCoordinator(
            drt, engines=[e], handles=[h], deadline_s=0.0
        )
        faultpoints.arm("mid_drain", "kill")
        await coord.trigger()
        assert h.deregistered  # step 1 ran: discovery keys deleted
        assert e.drained == 0  # fault fired before the engine drain
        assert not h.stopped and drt.shutdowns == 0  # sequence aborted
        assert coord.stats["drain_errors"] == 1
        # delay flavor: the drain survives (slow, not dead) and runs the
        # full sequence through lease revocation
        faultpoints.reset()
        faultpoints.arm("mid_drain", "delay", delay_s=0.01)
        h2, drt2, e2 = _Handle(), _Drt(), _Engine()
        coord2 = DrainCoordinator(
            drt2, engines=[e2], handles=[h2], deadline_s=0.0
        )
        res = await coord2.drain()
        assert res["drained"] and e2.drained == 1
        assert h2.stopped and drt2.shutdowns == 1

    run(main())


# ---------------------------------------------------------------------------
# migration policy edges
# ---------------------------------------------------------------------------


class _ScriptedEngine(AsyncEngine):
    """Inner engine driven by a list of per-attempt scripts."""

    def __init__(self, scripts):
        self.scripts = list(scripts)
        self.requests = []

    async def generate(self, request):
        self.requests.append(request)
        script = self.scripts.pop(0) if self.scripts else ["finish"]
        for step in script:
            if step == "finish":
                yield Annotated.from_data(
                    {"token_ids": [], "finish_reason": "length"}
                )
                return
            if step == "truncate":
                return  # end with neither finish nor error
            if isinstance(step, tuple) and step[0] == "error":
                yield Annotated.from_error(step[1])
                return
            yield Annotated.from_data({"token_ids": [step]})


def test_migration_truncation_resumes_with_splice(run):
    async def main():
        inner = _ScriptedEngine([[1, 2, 3, "truncate"], [4, 5, "finish"]])
        mig = MigratingEngine(inner, MigrationPolicy(max_migrations=2))
        req = make_req(tokens=[10, 11, 12])
        toks, finishes, errors, _ = await drive(mig, req)
        assert toks == [1, 2, 3, 4, 5] and finishes == ["length"]
        assert errors == []
        # the re-dispatch carried prompt + tokens-so-far + resume marker
        assert len(inner.requests) == 2
        resumed = inner.requests[1].data
        assert resumed["token_ids"] == [10, 11, 12, 1, 2, 3]
        assert resumed["annotations"]["resume"]["prompt_len"] == 3

    run(main())


def test_migration_redispatch_avoids_failed_worker(run):
    """A killed worker stays in discovery until its lease TTL lapses: the
    re-dispatch carries the failed worker id so the router steers around
    it, and the stale pin does not leak into the re-dispatch."""

    class _RoutedEngine(_ScriptedEngine):
        # mimic KvRoutedEngine: stamp the pinned instance, then fail
        async def generate(self, request):
            request.annotations["routed_worker_id"] = 7
            async for item in super().generate(request):
                yield item

    async def main():
        inner = _RoutedEngine([[1, 2, "truncate"], ["finish"]])
        mig = MigratingEngine(inner, MigrationPolicy(max_migrations=2))
        _toks, finishes, errors, _ = await drive(mig, make_req())
        assert finishes == ["length"] and errors == []
        assert len(inner.requests) == 2
        resumed = inner.requests[1]
        assert resumed.annotations["migration.avoid_workers"] == [7]

    run(main())


def test_migration_fatal_error_not_retried_and_budget_bounds(run):
    async def main():
        # deterministic engine error: surfaced unchanged, inner called once
        inner = _ScriptedEngine([[("error", "some model error")]])
        mig = MigratingEngine(inner, MigrationPolicy(max_migrations=3))
        _toks, _fin, errors, _ = await drive(mig, make_req())
        assert errors == ["some model error"]
        assert len(inner.requests) == 1
        assert mig.stats["migrations_total"] == 0

        # endless truncation: bounded by max_migrations, then surfaced
        inner = _ScriptedEngine([["truncate"]] * 10)
        mig = MigratingEngine(inner, MigrationPolicy(max_migrations=2))
        _toks, _fin, errors, _ = await drive(mig, make_req())
        assert len(errors) == 1 and "migration budget exhausted" in errors[0]
        assert len(inner.requests) == 3  # original + 2 re-dispatches

        # off-switch: the first retryable failure surfaces as-is
        inner = _ScriptedEngine([["truncate"]])
        mig = MigratingEngine(inner, MigrationPolicy(enabled=False))
        _toks, _fin, errors, _ = await drive(mig, make_req())
        assert len(errors) == 1 and "truncated" in errors[0]
        assert len(inner.requests) == 1

    run(main())


# ---------------------------------------------------------------------------
# the two packages through one hub
# ---------------------------------------------------------------------------


class _Pinned:
    """The frontend's dispatch for the interop test: the first attempt goes
    to the victim, every re-dispatch to the survivor (so the direction of
    the handoff is the test's, not round robin's)."""

    def __init__(self, client, victim, survivor, engine_base):
        self.client, self.order = client, [victim, survivor]
        self.base = engine_base

    def build(self):
        outer = self

        class _Engine(outer.base):
            async def generate(self, request):
                target = outer.order[0]
                if len(outer.order) > 1:
                    outer.order.pop(0)
                async for item in await outer.client.direct(request, target):
                    yield item

        return _Engine()


@pytest.mark.parametrize("victim", ["torch", "jax"])
def test_drained_stream_resumes_across_packages(run, victim):
    """A port worker and a JAX worker serve one endpoint through one hub.
    The victim's package drains it (zero deadline) while it streams a
    32-token greedy request; the frontend of the OTHER package (its
    ``MigratingEngine`` over its own client) resumes the stream on the
    survivor: no error, one finish, the tokens of an undisturbed run, the
    survivor's ``migration_resumes`` at 1 and the victim's
    ``drain_handoffs`` above 0."""
    n = 32
    prompt = list(range(10, 34))

    def jreq():
        from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
        from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
        from dynamo_tpu.protocols.common import StopConditions as JaxStops
        return JaxRequest(token_ids=list(prompt),
                          stop_conditions=JaxStops(max_tokens=n, ignore_eos=True),
                          sampling_options=JaxSampling(temperature=0.0),
                          eos_token_ids=[511])

    async def main():
        ref = await reference_tokens(torch_engine(decode_window=1),
                                     make_req(prompt, n))
        hub = port_hub.HubServer(host="127.0.0.1", port=0)
        await hub.start()
        sides = {}
        for name, pkg in (("torch", (port_hub, DistributedRuntime)),
                          ("jax", (ref_hub, ref_rt.DistributedRuntime))):
            store, bus, conn = await pkg[0].connect_hub(hub.address)
            sides[name] = (await pkg[1].from_settings(store=store, bus=bus), conn)
        engines = {"torch": torch_engine(decode_window=1),
                   "jax": jax_engine(decode_window=1)}
        handles = {}
        for name, (drt, _conn) in sides.items():
            handles[name] = await drt.namespace("res").component("w").endpoint(
                "gen").serve(engines[name], stats_handler=engines[name].load_metrics)
        survivor = "jax" if victim == "torch" else "torch"
        front_drt, front_conn = sides[survivor]
        client = await front_drt.namespace("res").component("w").endpoint(
            "gen").client().start()
        await client.wait_for_instances(timeout=5)
        for _ in range(100):
            if len(client.instance_ids()) == 2:
                break
            await asyncio.sleep(0.02)
        ids = {k: d.primary_lease_id for k, (d, _c) in sides.items()}
        if survivor == "jax":  # the reference's frontend
            base, mig_cls, policy, ctx = (ref_rt.AsyncEngine, ref_res.MigratingEngine,
                                          ref_res.MigrationPolicy, ref_rt.Context)
            req = jreq().to_dict()
            coord_cls = DrainCoordinator
        else:
            base, mig_cls, policy, ctx = (AsyncEngine, MigratingEngine,
                                          MigrationPolicy, Context)
            req = make_req(prompt, n).to_dict()
            coord_cls = ref_res.DrainCoordinator
        inner = _Pinned(client, ids[victim], ids[survivor], base).build()
        mig = mig_cls(inner, policy(max_migrations=3), client=client)
        task = asyncio.ensure_future(drive(mig, req, ctx=ctx))
        victim_engine = engines[victim]
        for _ in range(3000):
            if victim_engine.stats["tokens_generated"] >= 3 or task.done():
                break
            await asyncio.sleep(0.005)
        assert not task.done() and victim_engine.stats["tokens_generated"] >= 3
        # hold the victim at its device lock until its engine drains, so the
        # handoff finds the stream in flight however fast the steps run
        async with victim_engine._device_lock:
            drain = asyncio.ensure_future(coord_cls(
                sides[victim][0], engines=[victim_engine],
                handles=[handles[victim]], deadline_s=0.0).drain())
            while not victim_engine._draining:
                await asyncio.sleep(0.005)
        res = await drain
        assert res["handed_off"] >= 1
        toks, finishes, errors, _ = await asyncio.wait_for(task, 60)
        try:
            assert errors == [] and finishes == ["length"]
            assert toks == ref and len(toks) == n
            assert mig.stats["migrations_total"] == 1
            assert engines[survivor].stats["migration_resumes"] == 1
            lm = victim_engine.load_metrics()
            assert lm["draining"] == 1 and lm["drain_handoffs"] >= 1
        finally:
            for e in engines.values():
                await e.close()
            await sides[survivor][0].shutdown()
            for _d, conn in sides.values():
                await conn.close()
            await hub.close()

    run(main())
