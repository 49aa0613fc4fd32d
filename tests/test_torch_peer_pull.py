"""The fleet prefix cache's peer pull and the router-hinted prefetch in the
port (``kv_router/publisher.py KvPrefetchListener`` / ``KvPeerServer``,
``engine/offload.py``'s peer side, ``TorchEngine.prefetch_hint``) on the
CPU.

Copies of ``tests/test_prefix_fleet.py``'s peer tests (the router's hint
naming a deeper peer, the export / staging / claim accounting of the
offload manager, the whole pull over a bus and real TCP landed, promoted
and claimed bit-exact, a peer killed mid-serve, a miss answered at once)
and of ``tests/test_offload_pipeline.py``'s hinted prefetch against a cold
restore, pointed at the port; a pull served from the peer's device pages;
and the two packages through one hub: a port worker pulls a prefix from a
JAX peer and serves one to a JAX puller, with tokens equal to the peer's
own serve.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

import dynamo_tpu.kv_router as ref_kv
import dynamo_tpu.runtime as ref_rt
import dynamo_tpu.runtime.hub as ref_hub
import dynamo_tpu_torch.engine.offload as offload_mod
import dynamo_tpu_torch.runtime.hub as port_hub
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStops
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.allocator import sequence_block_hashes
from dynamo_tpu_torch.engine.offload import OffloadManager
from dynamo_tpu_torch.kv_router import (
    KvPeerServer,
    KvPrefetchListener,
    KvRouter,
    RouterEvent,
)
from dynamo_tpu_torch.kv_router.protocols import (
    KV_PREFETCH_SUBJECT,
    KvCacheEvent,
    KvPrefetchHint,
    StoredBlock,
)
from dynamo_tpu_torch.kv_router.scheduler import ProcessedEndpoints, WorkerLoad
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.resilience import faultpoints
from dynamo_tpu_torch.runtime import (
    Context,
    DistributedRuntime,
    LocalBus,
    LocalStore,
    collect,
)

PROMPT = list(range(100, 124))  # 6 blocks of 4

_MODELS: dict = {}


def _weights():
    """(JAX config, JAX params, port config, port params): one tiny f32
    model for the module."""
    if not _MODELS:
        jcfg = JaxModelConfig.tiny(dtype="float32")
        jparams = JaxEngine(JaxEngineConfig(model=jcfg, num_blocks=17, block_size=4,
                                            max_context=64), seed=0).params
        tcfg = ModelConfig.tiny(dtype="float32")
        _MODELS["tiny"] = (jcfg, jparams, tcfg,
                           from_jax_params(jax.tree.map(np.asarray, jparams), tcfg))
    return _MODELS["tiny"]


def _geometry(disk_path=None, **kw):
    base = dict(num_blocks=17, block_size=4, max_batch_size=2, max_context=64,
                prefill_chunk=32, host_cache_blocks=8)
    if disk_path is not None:
        base.update(disk_cache_blocks=64, disk_cache_path=str(disk_path))
    base.update(kw)
    return base


def _peer_geometry(disk_path=None, **kw):
    # a bigger device pool: the puller must not evict the pulled prefix
    return _geometry(disk_path, **{"num_blocks": 33, "host_cache_blocks": 64, **kw})


def torch_engine(geometry: dict) -> TorchEngine:
    _j, _jp, tcfg, tparams = _weights()
    return TorchEngine(EngineConfig(model=tcfg, **geometry), params=tparams,
                       device="cpu")


def jax_engine(geometry: dict) -> JaxEngine:
    jcfg, jparams, _t, _tp = _weights()
    return JaxEngine(JaxEngineConfig(model=jcfg, **geometry), params=jparams)


class Api:
    """One package's request types and collect, so a helper drives either
    engine."""

    def __init__(self, req, stops, samp, ctx, coll):
        self.req, self.stops, self.samp, self.ctx, self.coll = (
            req, stops, samp, ctx, coll)

    async def toks(self, engine, tokens, n=2) -> list:
        r = self.req(token_ids=list(tokens),
                     stop_conditions=self.stops(max_tokens=n, ignore_eos=True),
                     sampling_options=self.samp(temperature=0.0, seed=0),
                     eos_token_ids=[511])
        return [t for o in await self.coll(engine.generate(self.ctx(r)))
                for t in o.token_ids]


TORCH = Api(PreprocessedRequest, StopConditions, SamplingOptions, Context, collect)
JAX = Api(JaxRequest, JaxStops, JaxSampling, ref_rt.Context, ref_rt.collect)


def _hashes(tokens, bs=4):
    return [s for _l, s in sequence_block_hashes(tokens, bs)]


async def _park(api, engine, prompt, tier: str, min_blocks=5) -> list:
    """Serve ``prompt`` once, then churn until its chain sits in the named
    tier ("device": no churn; "host": the host or disk tier; "disk"): returns
    the first serve's greedy tokens."""
    await api.toks(engine, range(450, 462))  # the resume prefill's bucket
    toks = await api.toks(engine, prompt)
    if tier == "device":
        return toks
    for i in range(6):
        await api.toks(engine, range(200 + 30 * i, 224 + 30 * i))
    chain = _hashes(prompt)[:min_blocks]
    for _ in range(300):
        if tier == "disk":
            covered = engine.offload.disk.match_chain(chain)
        else:
            covered = next((i for i, h in enumerate(chain)
                            if not engine.offload.tier_contains(h)), len(chain))
        if covered >= min_blocks:
            return toks
        await asyncio.sleep(0.02)
    raise AssertionError(f"chain never parked in the peer's {tier} tier")


def _hint(prompt=PROMPT, worker=2, peer=1, n=5) -> KvPrefetchHint:
    pairs = sequence_block_hashes(prompt, 4)
    return KvPrefetchHint(worker, [[l, s] for l, s in pairs[:n]],
                          peer_worker_id=peer, peer_blocks=n)


async def _wait(cond, what: str, tries=500):
    for _ in range(tries):
        if cond():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(what)


# ---------------- the router's hint ----------------


def test_router_hint_names_deeper_peer(run):
    """Routing to a worker whose tiers miss while another worker's chain
    covers the prompt stamps that peer into the hint."""

    async def main():
        store, bus = LocalStore(), LocalBus()
        drt = await DistributedRuntime.from_settings(store=store, bus=bus)
        comp = drt.namespace("dyn").component("worker")
        router = await KvRouter(drt, comp, block_size=4).start()
        prompt = list(range(300, 324))  # 6 blocks
        pairs = sequence_block_hashes(prompt, 4)
        blocks = [StoredBlock(block_hash=s, tokens_hash=l) for l, s in pairs]
        # worker 2 holds the chain but is loaded: routing picks idle worker 1
        router.indexer.apply_event(RouterEvent(2, KvCacheEvent.stored(None, blocks)))
        router.metrics.endpoints = ProcessedEndpoints([
            WorkerLoad(worker_id=1, kv_active_blocks=5, kv_total_blocks=100,
                       active_requests=0, total_slots=8),
            WorkerLoad(worker_id=2, kv_active_blocks=95, kv_total_blocks=100,
                       active_requests=7, total_slots=8),
        ])
        sub = bus.subscribe(comp.event_subject(KV_PREFETCH_SUBJECT))
        wid, _overlap = await router.schedule(prompt)
        assert wid == 1
        msg = await sub.next(1.0)
        hint = KvPrefetchHint.from_bytes(msg.payload)
        assert (hint.worker_id, hint.peer_worker_id, hint.peer_blocks) == (1, 2, 5)
        await drt.shutdown()

    run(main())


# ---------------- the offload manager's peer side ----------------


def _blk(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, 2, 4, 8), generator=g), torch.randn((2, 2, 4, 8), generator=g)


def test_export_chain_serves_longest_run_nondestructively():
    om = OffloadManager(8)
    (k0, v0), (k1, v1) = _blk(0), _blk(1)
    om.pool.put(10, k0, v0)
    om.pool.put(11, k1, v1)
    om.pool.put(13, *_blk(3))  # 12 missing: the run stops there
    hashes, k, v = om.export_chain([10, 11, 12, 13])
    assert hashes == [10, 11] and k.shape[2] == 2
    assert torch.equal(k[:, :, 0], k0) and torch.equal(k[:, :, 1], k1)
    assert len(om.pool) == 3  # non-destructive
    assert om.export_chain([10, 11])[0] == [10, 11]
    assert om.export_chain([99]) == ([], None, None)
    assert om.stats()["peer_serve_blocks_total"] == 4
    om.close()


def test_staging_cap_truncates_tail_never_evicts_chain_head():
    """A chain longer than the staging cap keeps its PREFIX (what a
    consecutive-match restore can use)."""
    om = OffloadManager(1)  # staging cap floor = 64
    n = 100
    k = torch.stack([torch.full((1, 1, 1, 1), float(i)) for i in range(n)], dim=2)
    hashes = list(range(1000, 1000 + n))
    assert om.land_peer_chain(hashes, k, k.clone()) == 64
    got, data = om.reserve_chain(hashes)
    assert got == hashes[:64]
    assert float(data[0][0][0, 0, 0, 0]) == 0.0  # the head block's value
    om.close()


def test_land_peer_chain_claim_accounting():
    om = OffloadManager(8)
    k = torch.stack([_blk(i)[0] for i in range(3)], dim=2)
    v = torch.stack([_blk(i)[1] for i in range(3)], dim=2)
    assert om.land_peer_chain([21, 22, 23], k, v) == 3
    assert om.peer_pull_blocks_total == 3
    assert om.stats()["peer_pull_hidden_frac"] == 0.0
    # a duplicate landing is skipped (content-addressed, already here)
    assert om.land_peer_chain([21], k[:, :, :1], v[:, :, :1]) == 0
    om.note_prefetch_hits(2, hashes=[21, 22])
    st = om.stats()
    assert (st["peer_pull_blocks_total"], st["peer_pull_blocks_claimed"],
            st["h2d_prefetch_hits"]) == (3, 2, 2)
    assert st["peer_pull_hidden_frac"] == pytest.approx(2 / 3)
    om.close()


# ---------------- the pull end to end ----------------


@pytest.mark.parametrize("tier", ["disk", "device"])
def test_peer_pull_lands_promotes_and_claims_bit_exact(run, tmp_path, tier):
    """The whole path over a bus and real TCP: the hint names a peer, the
    puller fetches the chain from the peer's disk (or device) tier, lands
    it in its host staging area, the prefetch promotes it to the device,
    and the request claims it: tokens equal the peer's own serve, and the
    claimed pulls count as hidden transfers."""
    peer_eng = torch_engine(_geometry(tmp_path / "peer") if tier == "disk"
                            else _peer_geometry())
    pull_eng = torch_engine(_peer_geometry())

    async def main():
        drt = await DistributedRuntime.from_settings(store=LocalStore(), bus=LocalBus())
        comp = drt.namespace("dyn").component("worker")
        server = await KvPeerServer(drt, comp, 1, peer_eng).start()
        listener = await KvPrefetchListener(drt, comp, 2, pull_eng).start()
        try:
            toks_ref = await _park(TORCH, peer_eng, PROMPT, tier)
            drt.bus.publish(comp.event_subject(KV_PREFETCH_SUBJECT), _hint().to_bytes())
            await _wait(lambda: listener.blocks_prefetched >= 5,
                        "pulled chain never promoted to the puller's device")
            assert listener.peer_pulls == 1 and listener.peer_pull_blocks >= 5
            assert server.blocks_served >= 5
            peer_m = peer_eng.load_metrics()
            if tier == "device":
                assert peer_m["peer_serve_d2h_blocks_total"] >= 5
            else:
                assert peer_m["peer_serve_blocks_total"] >= 5
            assert await TORCH.toks(pull_eng, PROMPT) == toks_ref
            m = pull_eng.load_metrics()
            assert m["peer_pull_blocks_total"] >= 5
            assert m["h2d_prefetch_hits"] >= 5 and m["peer_pull_hidden_frac"] > 0
            load = WorkerLoad.from_stats(2, m)
            assert load.peer_pull_blocks >= 5 and load.peer_pull_hidden_frac > 0
        finally:
            await listener.close()
            await server.close()
            await peer_eng.close()
            await pull_eng.close()
            await drt.shutdown()

    run(main())


@pytest.mark.faultinject
def test_worker_death_mid_peer_pull_degrades_to_recompute(run, tmp_path):
    """The mid_peer_serve kill: the peer dies before pushing. The puller
    times out, counts a failure and recomputes with equal tokens; the
    peer's tiers stay intact."""
    peer_eng = torch_engine(_peer_geometry(tmp_path / "peer"))
    pull_eng = torch_engine(_peer_geometry())

    async def main():
        drt = await DistributedRuntime.from_settings(store=LocalStore(), bus=LocalBus())
        comp = drt.namespace("dyn").component("worker")
        server = await KvPeerServer(drt, comp, 1, peer_eng).start()
        listener = await KvPrefetchListener(drt, comp, 2, pull_eng,
                                            pull_timeout=0.6).start()
        try:
            toks_ref = await _park(TORCH, peer_eng, PROMPT, "host")
            pool_before = len(peer_eng.offload.pool)
            faultpoints.arm("mid_peer_serve", "kill", after=1, times=1)
            drt.bus.publish(comp.event_subject(KV_PREFETCH_SUBJECT), _hint().to_bytes())
            await _wait(lambda: listener.peer_pull_failures >= 1, "no failure")
            assert listener.peer_pull_blocks == 0
            assert len(faultpoints.FAULTS.history) == 1, "kill never fired"
            assert await TORCH.toks(pull_eng, PROMPT) == toks_ref
            assert pull_eng.offload.stats()["peer_pull_blocks_total"] == 0
            assert len(peer_eng.offload.pool) == pool_before
            served, _k, _v = peer_eng.offload.export_chain(_hashes(PROMPT)[:5])
            assert len(served) == 5
        finally:
            faultpoints.reset()
            await listener.close()
            await server.close()
            await peer_eng.close()
            await pull_eng.close()
            await drt.shutdown()

    run(main())


def test_peer_miss_answers_immediately_not_timeout(run):
    """A peer whose tiers miss answers with an error delivery: the puller
    fails fast instead of waiting out its timeout."""
    peer_eng, pull_eng = torch_engine(_peer_geometry()), torch_engine(_peer_geometry())

    async def main():
        drt = await DistributedRuntime.from_settings(store=LocalStore(), bus=LocalBus())
        comp = drt.namespace("dyn").component("worker")
        server = await KvPeerServer(drt, comp, 1, peer_eng).start()
        listener = await KvPrefetchListener(drt, comp, 2, pull_eng,
                                            pull_timeout=30.0).start()
        try:
            t0 = time.monotonic()
            drt.bus.publish(comp.event_subject(KV_PREFETCH_SUBJECT), _hint().to_bytes())
            await _wait(lambda: listener.peer_pull_failures >= 1, "no failure")
            assert time.monotonic() - t0 < 10.0 and server.misses == 1
        finally:
            await listener.close()
            await server.close()
            await peer_eng.close()
            await pull_eng.close()
            await drt.shutdown()

    run(main())


def test_hinted_prefetch_beats_cold_restore_ttft(run, monkeypatch):
    """A router hint restores the chain BEFORE the request arrives, so the
    request's TTFT skips the (slow) h2d copy a cold restore pays, and the
    upload counts as hidden."""
    real_put = offload_mod._device_put

    def slow_put(tensors, xfer):
        time.sleep(0.3)
        return real_put(tensors, xfer)

    monkeypatch.setattr(offload_mod, "_device_put", slow_put)
    geometry = _geometry(host_cache_blocks=64)

    async def ttft(engine):
        t0 = time.monotonic()
        agen = engine.generate(Context(PreprocessedRequest(
            token_ids=PROMPT, stop_conditions=StopConditions(max_tokens=2,
                                                             ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0, seed=0),
            eos_token_ids=[511])))
        async for _o in agen:
            break
        dt = time.monotonic() - t0
        async for _o in agen:
            pass
        return dt

    async def main():
        cold = torch_engine(geometry)
        toks_ref = await _park(TORCH, cold, PROMPT, "host")
        ttft_cold = await ttft(cold)
        assert cold.offload.stats()["h2d_prefetch_hits"] == 0
        await cold.close()
        assert ttft_cold >= 0.25, "a cold restore pays the h2d wait"

        hinted = torch_engine(geometry)
        assert await _park(TORCH, hinted, PROMPT, "host") == toks_ref
        assert await hinted.prefetch_hint(sequence_block_hashes(PROMPT, 4)) >= 5
        ttft_hinted = await ttft(hinted)
        st = hinted.offload.stats()
        await hinted.close()
        assert st["h2d_prefetch_blocks_total"] >= 5
        assert st["h2d_prefetch_hits"] >= 5, "the claim counts the hint's hits"
        assert st["restore_latency_hidden_frac"] > 0
        assert ttft_hinted < ttft_cold * 0.75, (ttft_hinted, ttft_cold)

    run(main())


# ---------------- the two packages through one hub ----------------


@pytest.mark.parametrize("puller", ["torch", "jax"],
                         ids=["torch pulls from jax", "jax pulls from torch"])
def test_peer_pull_interoperates_with_the_reference(run, tmp_path, puller):
    """A port worker pulls a prefix from a JAX peer's disk tier, and a JAX
    worker pulls one from a port peer's, through one hub (hint, fetch
    negotiation and transfer frames the reference's): the pulled chain
    lands, is claimed, and the tokens equal the peer's own serve."""

    async def main():
        hub = port_hub.HubServer(host="127.0.0.1", port=0)
        await hub.start()
        runtimes = []
        for hub_mod, rt in ((port_hub, DistributedRuntime),
                            (ref_hub, ref_rt.DistributedRuntime)):
            store, bus, conn = await hub_mod.connect_hub(hub.address)
            runtimes.append((await rt.from_settings(store=store, bus=bus), conn))
        (port_drt, _pc), (jax_drt, _jc) = runtimes
        peer_geo, pull_geo = _geometry(tmp_path / "peer"), _peer_geometry()
        if puller == "torch":
            peer_eng, pull_eng = jax_engine(peer_geo), torch_engine(pull_geo)
            peer_api, pull_api = JAX, TORCH
            server = await ref_kv.KvPeerServer(
                jax_drt, jax_drt.namespace("dyn").component("worker"), 1,
                peer_eng).start()
            listener = await KvPrefetchListener(
                port_drt, port_drt.namespace("dyn").component("worker"), 2,
                pull_eng).start()
        else:
            peer_eng, pull_eng = torch_engine(peer_geo), jax_engine(pull_geo)
            peer_api, pull_api = TORCH, JAX
            server = await KvPeerServer(
                port_drt, port_drt.namespace("dyn").component("worker"), 1,
                peer_eng).start()
            listener = await ref_kv.KvPrefetchListener(
                jax_drt, jax_drt.namespace("dyn").component("worker"), 2,
                pull_eng).start()
        try:
            toks_ref = await _park(peer_api, peer_eng, PROMPT, "disk")
            comp = port_drt.namespace("dyn").component("worker")
            port_drt.bus.publish(comp.event_subject(KV_PREFETCH_SUBJECT),
                                 _hint().to_bytes())
            await _wait(lambda: listener.blocks_prefetched >= 5,
                        "pulled chain never promoted")
            assert listener.peer_pulls == 1 and server.blocks_served >= 5
            assert await pull_api.toks(pull_eng, PROMPT) == toks_ref
            st = pull_eng.offload.stats()
            assert st["peer_pull_blocks_total"] >= 5 and st["h2d_prefetch_hits"] >= 5
        finally:
            await listener.close()
            await server.close()
            await peer_eng.close()
            await pull_eng.close()
            for d, conn in runtimes:
                await d.shutdown()
                await conn.close()
            await hub.close()

    run(main())


def test_int8_cache_peer_serves_full_width_dequantized_on_device(
        run, monkeypatch):
    """An int8-cache worker with a full-width host tier serves its device
    chain to a full-width puller: the gathered codes are dequantized by the
    engine's dequantizing scatter before the d2h (counted in
    ``kv_device_export_requant_total``), never by the host codec. Each
    peer's frames carry exactly its own codes times their scales (the
    port's bit-exact, the JAX peer's within f32 tolerance), and the two
    peers' codes for the chain are at most one apart (their f32 KV can
    round to neighbouring codes), with scales within 1%; both pulls are
    claimed with tokens equal to the peers' own serves."""
    from dynamo_tpu_torch.engine import kvquant

    host_dequant = kvquant.dequantize_stack

    def no_host_dequant(*a, **kw):
        raise AssertionError("peer serve dequantized on the host")

    monkeypatch.setattr(kvquant, "dequantize_stack", no_host_dequant)
    landed: dict = {}
    port_land = OffloadManager.land_peer_chain

    def record_land(self, hashes, k, v, k_scales=None, v_scales=None):
        landed[id(self)] = (list(hashes), k.clone(), v.clone(), k_scales)
        return port_land(self, hashes, k, v, k_scales, v_scales)

    monkeypatch.setattr(OffloadManager, "land_peer_chain", record_land)

    async def main():
        hub = port_hub.HubServer(host="127.0.0.1", port=0)
        await hub.start()
        runtimes = []
        for hub_mod, rt in ((port_hub, DistributedRuntime),
                            (ref_hub, ref_rt.DistributedRuntime)):
            store, bus, conn = await hub_mod.connect_hub(hub.address)
            runtimes.append((await rt.from_settings(store=store, bus=bus), conn))
        (port_drt, _pc), (jax_drt, _jc) = runtimes
        port_comp = port_drt.namespace("dyn").component("worker")
        jax_comp = jax_drt.namespace("dyn").component("worker")
        peer_geo = _peer_geometry(kv_cache_dtype="int8")
        port_peer, jax_peer = torch_engine(peer_geo), jax_engine(peer_geo)
        pullers = {2: torch_engine(_peer_geometry()),
                   4: torch_engine(_peer_geometry())}
        servers = [await KvPeerServer(port_drt, port_comp, 1, port_peer).start(),
                   await ref_kv.KvPeerServer(jax_drt, jax_comp, 3,
                                             jax_peer).start()]
        listeners = {w: await KvPrefetchListener(port_drt, port_comp, w,
                                                 e).start()
                     for w, e in pullers.items()}
        try:
            toks_ref = await _park(TORCH, port_peer, PROMPT, "device")
            assert await _park(JAX, jax_peer, PROMPT, "device") == toks_ref
            for worker, peer in ((2, 1), (4, 3)):
                port_drt.bus.publish(port_comp.event_subject(KV_PREFETCH_SUBJECT),
                                     _hint(worker=worker, peer=peer).to_bytes())
                await _wait(lambda: listeners[worker].blocks_prefetched >= 5,
                            f"worker {worker}'s pulled chain never promoted")
            m = port_peer.load_metrics()
            assert m["peer_serve_d2h_blocks_total"] >= 5
            assert m["kv_device_export_requant_total"] == m[
                "peer_serve_d2h_blocks_total"]
            hashes, k, v, ks = landed[id(pullers[2].offload)]
            assert ks is None and k.dtype == torch.float32
            idxs = [port_peer.allocator.match_prefix((), hashes=[(0, h)])[0]
                    for h in hashes]
            codes = port_peer._gather_device([b.idx for b in idxs], False, True)
            port_peer.allocator.free(idxs)
            want_k, want_v = host_dequant(*codes, torch.float32)
            torch.testing.assert_close(k, want_k, rtol=0, atol=0)
            torch.testing.assert_close(v, want_v, rtol=0, atol=0)
            jhashes, jk, jv, jks = landed[id(pullers[4].offload)]
            assert jhashes == hashes and jks is None
            jidx = jax_peer.allocator.match_prefix(
                (), hashes=[(0, h) for h in hashes])
            jcodes = [torch.from_numpy(np.array(a)) for a in
                      jax_peer._gather_device([b.idx for b in jidx], False, True)]
            jax_peer.allocator.free(jidx)
            jwant_k, jwant_v = host_dequant(*jcodes, torch.float32)
            torch.testing.assert_close(jk, jwant_k)
            torch.testing.assert_close(jv, jwant_v)
            for port_c, jax_c in zip(codes, jcodes):
                if port_c.dtype == torch.int8:
                    diff = (port_c.int() - jax_c.int()).abs()
                    assert int(diff.max()) <= 1
                else:
                    torch.testing.assert_close(port_c, jax_c, rtol=1e-2, atol=0)
            for eng in pullers.values():
                assert await TORCH.toks(eng, PROMPT) == toks_ref
                assert eng.load_metrics()["h2d_prefetch_hits"] >= 5
        finally:
            for lis in listeners.values():
                await lis.close()
            for srv in servers:
                await srv.close()
            for eng in (port_peer, jax_peer, *pullers.values()):
                await eng.close()
            for d, conn in runtimes:
                await d.shutdown()
                await conn.close()
            await hub.close()

    run(main())
