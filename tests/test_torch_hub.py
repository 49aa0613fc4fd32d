"""The port's TCP hub (``dynamo_tpu_torch.runtime.hub``) on the CPU: copies
of the fast cases of ``tests/test_hub.py``, each run with the port's and
the reference's hub and clients in every pairing (the port's
``connect_hub`` against the reference's ``HubServer`` and the other way
round), and discovery across the two: the model entries and deployment
cards one side registers, byte for byte, and what the other side's
``ModelWatcher`` makes of them."""

import asyncio
import types

import pytest

import dynamo_tpu.http.discovery as ref_discovery
import dynamo_tpu.http.service as ref_service
import dynamo_tpu.llm.model_card as ref_card
import dynamo_tpu.runtime as ref_runtime
import dynamo_tpu.runtime.hub as ref_hub
import dynamo_tpu.runtime.store as ref_store
import dynamo_tpu_torch.http.discovery as port_discovery
import dynamo_tpu_torch.http.service as port_service
import dynamo_tpu_torch.llm.model_card as port_card
import dynamo_tpu_torch.runtime as port_runtime
import dynamo_tpu_torch.runtime.hub as port_hub
import dynamo_tpu_torch.runtime.store as port_store

IMPL = {
    "port": types.SimpleNamespace(rt=port_runtime, hub=port_hub, store=port_store,
                                  discovery=port_discovery, card=port_card,
                                  service=port_service),
    "ref": types.SimpleNamespace(rt=ref_runtime, hub=ref_hub, store=ref_store,
                                 discovery=ref_discovery, card=ref_card,
                                 service=ref_service),
}
PAIRS = [("port", "port"), ("ref", "port"), ("port", "ref")]
PAIR_IDS = [f"{h} hub, {c} clients" for h, c in PAIRS]
T = 5.0  # bound on every network wait


def echo_engine(impl):
    rt = impl.rt

    class EchoEngine(rt.AsyncEngine):
        async def generate(self, request):
            for ch in request.data["text"]:
                yield rt.Annotated.from_data({"token": ch})

    return EchoEngine()


@pytest.mark.parametrize("hub_impl,client_impl", PAIRS, ids=PAIR_IDS)
def test_remote_store_ops(run, hub_impl, client_impl):
    H, C = IMPL[hub_impl], IMPL[client_impl]

    async def main():
        hub = H.hub.HubServer()
        await hub.start()
        store, bus, conn = await asyncio.wait_for(C.hub.connect_hub(hub.address), T)

        lease = await asyncio.wait_for(store.grant_lease(5.0), T)
        await asyncio.wait_for(store.kv_create("a/b", b"v1", lease_id=lease), T)
        with pytest.raises(C.store.KeyExists):
            await asyncio.wait_for(store.kv_create("a/b", b"v2"), T)
        entry = await asyncio.wait_for(store.kv_get("a/b"), T)
        assert entry.value == b"v1" and entry.lease_id == lease

        w = await asyncio.wait_for(store.watch_prefix("a/"), T)
        assert [e.key for e in w.snapshot] == ["a/b"]
        await asyncio.wait_for(store.kv_put("a/c", b"v3"), T)
        ev = await asyncio.wait_for(w.__anext__(), T)
        assert (ev.key, ev.value) == ("a/c", b"v3")

        got = await asyncio.wait_for(store.kv_get_prefix("a/"), T)
        assert [e.key for e in got] == ["a/b", "a/c"]
        # revoking the lease deletes its key, and the watch sees it
        await asyncio.wait_for(store.revoke_lease(lease), T)
        ev = await asyncio.wait_for(w.__anext__(), T)
        assert (ev.kind.value, ev.key) == ("delete", "a/b")
        assert not await asyncio.wait_for(store.keep_alive(lease), T)
        await conn.close()
        await hub.close()

    run(main())


@pytest.mark.parametrize("hub_impl,client_impl", PAIRS, ids=PAIR_IDS)
def test_remote_bus_pubsub_request_queue_objects(run, hub_impl, client_impl):
    H, C = IMPL[hub_impl], IMPL[client_impl]

    async def main():
        hub = H.hub.HubServer()
        await hub.start()
        store_a, bus_a, conn_a = await asyncio.wait_for(C.hub.connect_hub(hub.address), T)
        store_b, bus_b, conn_b = await asyncio.wait_for(C.hub.connect_hub(hub.address), T)

        # pub/sub across connections
        sub = bus_b.subscribe("events.kv")
        await asyncio.wait_for(sub.ready, T)
        bus_a.publish("events.kv", b"stored")
        msg = await sub.next(T)
        assert msg.payload == b"stored"

        # request/reply across connections
        svc = bus_b.subscribe("svc.gen", group="workers")
        await asyncio.wait_for(svc.ready, T)

        async def server():
            m = await svc.next(T)
            bus_b.respond(m, b"pong:" + m.payload)

        t = asyncio.get_running_loop().create_task(server())
        reply = await asyncio.wait_for(bus_a.request("svc.gen", b"ping", timeout=T), T)
        assert reply == b"pong:ping"
        await asyncio.wait_for(t, T)
        with pytest.raises(C.rt.NoResponders):
            await asyncio.wait_for(bus_a.request("svc.none", b"x", timeout=1), T)

        # work queue across connections
        qa = bus_a.work_queue("prefill")
        qb = bus_b.work_queue("prefill")
        await asyncio.wait_for(qa.push(b"job"), T)
        item = await asyncio.wait_for(qb.pop(timeout=T), T + 1)
        assert item.payload == b"job"
        assert await asyncio.wait_for(qb.ack(item.id), T)

        # object store
        await asyncio.wait_for(bus_a.object_put("mdc", "m1", b"card"), T)
        assert await asyncio.wait_for(bus_b.object_get("mdc", "m1"), T) == b"card"
        assert await asyncio.wait_for(bus_b.object_list("mdc"), T) == ["m1"]

        await conn_a.close()
        await conn_b.close()
        await hub.close()

    run(main())


SERVING = [("port", "port", "port"), ("port", "ref", "port"), ("port", "port", "ref"),
           ("ref", "port", "ref"), ("ref", "ref", "port"), ("ref", "port", "port")]


@pytest.mark.parametrize("hub_impl,worker_impl,front_impl", SERVING,
                         ids=[f"{h} hub, {w} worker, {f} caller"
                              for h, w, f in SERVING])
def test_full_serving_over_hub(run, hub_impl, worker_impl, front_impl):
    """A worker runtime serves an endpoint through the hub and a caller
    runtime discovers and streams from it (request envelope on the bus,
    response frames on the TCP connect-back), in every mix of the two
    implementations; a clean worker shutdown revokes its lease and the
    caller's discovery drops the instance at once."""
    H, W, F = IMPL[hub_impl], IMPL[worker_impl], IMPL[front_impl]

    async def main():
        hub = H.hub.HubServer()
        await hub.start()
        ws, wb, wconn = await asyncio.wait_for(W.hub.connect_hub(hub.address), T)
        fs, fb, fconn = await asyncio.wait_for(F.hub.connect_hub(hub.address), T)

        worker = await W.rt.DistributedRuntime.from_settings(store=ws, bus=wb)
        front = await F.rt.DistributedRuntime.from_settings(store=fs, bus=fb)

        await worker.namespace("ns").component("gen").endpoint("g").serve(
            echo_engine(W), stats_handler=lambda: {"kv_active_blocks": 3})
        client = await front.namespace("ns").component("gen").endpoint("g").client().start()
        assert await client.wait_for_instances(T) == [worker.worker_id]

        out = await asyncio.wait_for(F.rt.collect(
            await client.round_robin(F.rt.Context({"text": "gpu"}))), T)
        assert [a.data["token"] for a in out] == ["g", "p", "u"]
        out = await asyncio.wait_for(F.rt.collect(await client.direct(
            F.rt.Context({"text": "ok"}), worker.worker_id)), T)
        assert [a.data["token"] for a in out] == ["o", "k"]
        stats = await front.namespace("ns").component("gen").scrape_stats(timeout=T)
        assert stats == [{"endpoint": "g", "instance_id": worker.worker_id,
                          "data": {"kv_active_blocks": 3}}]

        await worker.shutdown()
        await wconn.close()
        for _ in range(200):
            if not client.instance_ids():
                break
            await asyncio.sleep(0.01)
        assert client.instance_ids() == []

        await front.shutdown()
        await fconn.close()
        await hub.close()

    run(main())


def test_model_entry_and_card_bytes():
    """``ModelEntry`` (discovery's record) and ``ModelDeploymentCard`` (the
    object-store card) serialize to the reference's bytes, under the
    reference's keys, and decode each other's."""
    kw = dict(name="llama3-8b-sim", namespace="dynamo", component="backend",
              endpoint="generate", model_type="both", instance=0x2A)
    got, ref = port_discovery.ModelEntry(**kw), ref_discovery.ModelEntry(**kw)
    assert got.key() == ref.key() == "public/models/both/llama3-8b-sim/2a"
    assert got.to_json() == ref.to_json()
    assert port_discovery.ModelEntry.from_json(ref.to_json()) == got
    card = dict(display_name="m", service_name="m", model_path="llama3-8b-sim",
                context_length=8192, kv_block_size=16, extra={"a": 1})
    got, ref = port_card.ModelDeploymentCard(**card), ref_card.ModelDeploymentCard(**card)
    assert got.to_json() == ref.to_json()
    assert port_card.ModelDeploymentCard.from_json(ref.to_json()) == got
    assert (port_card.MDC_BUCKET, port_card.MDC_TTL_SECONDS) == (
        ref_card.MDC_BUCKET, ref_card.MDC_TTL_SECONDS)


@pytest.mark.parametrize("worker_impl,front_impl", [("port", "ref"), ("ref", "port")],
                         ids=["port worker, reference frontend",
                              "reference worker, port frontend"])
def test_model_discovery_across_implementations(run, worker_impl, front_impl):
    """A worker registers its model under its lease and publishes its card;
    the other implementation's ``ModelWatcher`` serves the model through the
    worker's endpoint, loads the card, and drops the model when the worker's
    lease goes."""
    W, F = IMPL[worker_impl], IMPL[front_impl]

    async def main():
        hub = port_hub.HubServer()
        await hub.start()
        ws, wb, wconn = await asyncio.wait_for(W.hub.connect_hub(hub.address), T)
        fs, fb, fconn = await asyncio.wait_for(F.hub.connect_hub(hub.address), T)
        worker = await W.rt.DistributedRuntime.from_settings(store=ws, bus=wb)
        front = await F.rt.DistributedRuntime.from_settings(store=fs, bus=fb)
        await worker.namespace("dyn").component("backend").endpoint("gen").serve(
            echo_engine(W))
        await W.discovery.register_model(worker, W.discovery.ModelEntry(
            name="echo", namespace="dyn", component="backend", endpoint="gen",
            model_type="both"))
        await W.card.ModelDeploymentCard(display_name="echo", service_name="echo",
                                         kv_block_size=4).publish(worker.bus)

        manager = F.service.ModelManager()
        await asyncio.wait_for(F.discovery.ModelWatcher(front, manager).start(), T)
        assert manager.model_names() == ["echo"]
        card = await asyncio.wait_for(
            F.card.ModelDeploymentCard.load(front.bus, "echo"), T)
        assert card.kv_block_size == 4
        entries = await asyncio.wait_for(F.discovery.list_models(front), T)
        assert [(e.name, e.instance) for e in entries] == [("echo", worker.worker_id)]
        engine = manager.completion_engine("echo")
        out = await asyncio.wait_for(F.rt.collect(
            engine.generate(F.rt.Context({"text": "hi"}))), T)
        assert [a.data["token"] for a in out] == ["h", "i"]

        await worker.shutdown()
        await wconn.close()
        for _ in range(200):
            if not manager.model_names():
                break
            await asyncio.sleep(0.01)
        assert manager.model_names() == []
        await front.shutdown()
        await fconn.close()
        await hub.close()

    run(main())
