"""The port's runtime core (``dynamo_tpu_torch.runtime``) on the CPU: copies
of the in-process cases of ``tests/test_runtime_core.py`` pointed at the
port (codec, store, bus, cancellation, pipeline), and the wire held to the
reference's: codec frames, request envelopes and discovery records byte
for byte, and the TCP response plane streaming between a port process and
a reference process in both directions."""

import asyncio
import json
import os
import signal

import pytest

from dynamo_tpu.runtime import Annotated as RefAnnotated
from dynamo_tpu.runtime import AsyncEngineContext as RefContext
from dynamo_tpu.runtime import codec as ref_codec
from dynamo_tpu.runtime import component as ref_component
from dynamo_tpu.runtime import tcp as ref_tcp
from dynamo_tpu_torch.runtime import (
    Annotated,
    AsyncEngine,
    AsyncEngineContext,
    Context,
    DistributedRuntime,
    EngineFn,
    KeyExists,
    LocalBus,
    LocalStore,
    MapOperator,
    NoResponders,
    Operator,
    TwoPartMessage,
    ValidationFailed,
    Worker,
    collect,
    decode_buffer,
    encode,
    link,
)
from dynamo_tpu_torch.runtime import codec as port_codec
from dynamo_tpu_torch.runtime import component as port_component
from dynamo_tpu_torch.runtime import tcp as port_tcp
from dynamo_tpu_torch.runtime.bus import _subject_matches
from dynamo_tpu_torch.runtime.engine import CancellationToken

# ---------------- codec ----------------


def test_codec_roundtrip():
    msg = TwoPartMessage.from_json({"a": 1}, data=b"\x00\x01payload")
    decoded, rest = decode_buffer(encode(msg))
    assert rest == b""
    assert decoded.header_json() == {"a": 1}
    assert decoded.data == b"\x00\x01payload"


def test_codec_multiple_frames():
    buf = encode(TwoPartMessage(b"h1", b"d1")) + encode(TwoPartMessage(b"h2", b""))
    m1, rest = decode_buffer(buf)
    m2, rest = decode_buffer(rest)
    assert (m1.header, m1.data) == (b"h1", b"d1")
    assert (m2.header, m2.data) == (b"h2", b"")
    assert rest == b""


FRAMES = [
    ({"op": "kv_put", "key": "ns/components/w/ep:1", "lease": 7, "id": 3}, b"v"),
    ({"type": "prologue", "stream_id": "ab" * 16}, b""),
    ({"type": "data"}, json.dumps({"data": {"token_ids": [1, 2]}}).encode()),
    ({}, bytes(range(256)) * 3),
    (None, b""),
]


@pytest.mark.parametrize("head,data", FRAMES, ids=["store-op", "prologue", "data",
                                                   "binary", "empty"])
def test_codec_frames_are_the_references_bytes(head, data):
    """The same (header, data) encodes to the same bytes in both codecs,
    and each decodes the other's."""
    def make(mod):
        if head is None:
            return mod.TwoPartMessage(b"", data)
        return mod.TwoPartMessage.from_json(head, data)

    got = port_codec.encode(make(port_codec))
    ref = ref_codec.encode(make(ref_codec))
    assert got == ref
    back, rest = ref_codec.decode_buffer(got)
    assert (back.header, back.data, rest) == (make(ref_codec).header, data, b"")
    back, rest = port_codec.decode_buffer(ref)
    assert (back.header, back.data, rest) == (make(port_codec).header, data, b"")


@pytest.mark.parametrize("trace", [None, "00-" + "1" * 32 + "-" + "2" * 16 + "-01"],
                         ids=["tracing off", "with a traceparent"])
def test_request_envelope_and_endpoint_info_bytes(trace):
    """``RequestEnvelope`` and ``EndpointInfo`` (what rides the bus and what
    discovery stores) serialize to the reference's bytes; the port decodes
    the reference's and the reference the port's."""
    kw = dict(request_id="req-1",
              connection_info={"address": "127.0.0.1:4000", "stream_id": "s"},
              payload={"token_ids": [1, 2, 3], "stop_conditions": {"max_tokens": 4}},
              annotations={"routed_worker_id": 5}, trace=trace)
    got = port_component.RequestEnvelope(**kw).to_bytes()
    ref = ref_component.RequestEnvelope(**kw).to_bytes()
    assert got == ref
    assert (trace is None) == (b'"trace"' not in got)
    assert port_component.RequestEnvelope.from_bytes(ref) == (
        port_component.RequestEnvelope(**kw))
    info = dict(namespace="dynamo", component="backend", endpoint="generate",
                lease_id=0x1F, subject="dynamo.backend.generate-1f")
    assert (port_component.EndpointInfo(**info).to_json()
            == ref_component.EndpointInfo(**info).to_json())
    assert port_component.slug("a.b c/d") == ref_component.slug("a.b c/d")


# ---------------- store ----------------


def test_store_create_and_validate(run):
    async def main():
        s = LocalStore()
        s.kv_create("k", b"v")
        with pytest.raises(KeyExists):
            s.kv_create("k", b"v2")
        s.kv_create_or_validate("k", b"v")
        with pytest.raises(ValidationFailed):
            s.kv_create_or_validate("k", b"other")
        assert s.kv_get("k").value == b"v"

    run(main())


def test_store_lease_expiry_deletes_keys_and_notifies(run):
    async def main():
        now = [0.0]
        s = LocalStore(clock=lambda: now[0])
        lease = s.grant_lease(ttl=5.0)
        s.kv_put("ns/components/w/ep:1", b"info", lease_id=lease)
        w = s.watch_prefix("ns/components/")
        assert len(w.snapshot) == 1
        now[0] = 6.0
        s.expire_leases()
        ev = await asyncio.wait_for(w.__anext__(), 1)
        assert ev.kind.value == "delete"
        assert s.kv_get_prefix("ns/") == []

    run(main())


def test_store_keepalive_extends_lease(run):
    async def main():
        now = [0.0]
        s = LocalStore(clock=lambda: now[0])
        lease = s.grant_lease(ttl=5.0)
        s.kv_put("k", b"v", lease_id=lease)
        now[0] = 4.0
        assert s.keep_alive(lease)
        now[0] = 8.0
        s.expire_leases()
        assert s.kv_get("k") is not None
        now[0] = 10.0
        s.expire_leases()
        assert s.kv_get("k") is None
        assert not s.keep_alive(lease)

    run(main())


def test_store_watch_sees_puts(run):
    async def main():
        s = LocalStore()
        w = s.watch_prefix("pre/")
        s.kv_put("pre/a", b"1")
        s.kv_put("other/b", b"2")
        ev = await asyncio.wait_for(w.__anext__(), 1)
        assert (ev.key, ev.value) == ("pre/a", b"1")

    run(main())


def test_store_persistence_roundtrip(tmp_path, run):
    """Snapshot + WAL: keys and leases survive a store restart (the fast
    half of the reference's persistence case: no hub restart)."""
    async def main():
        s = LocalStore(data_dir=str(tmp_path))
        lease = s.grant_lease(ttl=30.0)
        s.kv_put("a", b"1", lease_id=lease)
        s.kv_put("b", b"2")
        s.kv_delete("b")
        await s.close()
        s2 = LocalStore(data_dir=str(tmp_path))
        assert s2.kv_get("a").value == b"1" and s2.kv_get("a").lease_id == lease
        assert s2.kv_get("b") is None
        assert s2.keep_alive(lease)
        assert s2.grant_lease(ttl=1.0) > lease  # ids never reissued
        await s2.close()

    run(main())


# ---------------- bus ----------------


def test_subject_matching():
    assert _subject_matches("a.b.c", "a.b.c")
    assert _subject_matches("a.*.c", "a.b.c")
    assert _subject_matches("a.>", "a.b.c.d")
    assert not _subject_matches("a.b", "a.b.c")
    assert not _subject_matches("a.*.c", "a.b.d")


def test_bus_pubsub_and_queue_group(run):
    async def main():
        bus = LocalBus()
        plain = bus.subscribe("ev.x")
        g1 = bus.subscribe("ev.x", group="g")
        g2 = bus.subscribe("ev.x", group="g")
        bus.publish("ev.x", b"m1")
        bus.publish("ev.x", b"m2")
        assert (await plain.next(1)).payload == b"m1"
        assert (await plain.next(1)).payload == b"m2"
        # queue group: one member each, round-robin
        got = [(await g1.next(0.2)), (await g2.next(0.2))]
        payloads = sorted(m.payload for m in got if m)
        assert payloads == [b"m1", b"m2"]

    run(main())


def test_bus_request_reply_and_no_responders(run):
    async def main():
        bus = LocalBus()
        with pytest.raises(NoResponders):
            await bus.request("svc.a", b"req", timeout=0.5)
        sub = bus.subscribe("svc.a", group="workers")

        async def server():
            msg = await sub.next(1)
            bus.respond(msg, b"reply:" + msg.payload)

        t = asyncio.get_running_loop().create_task(server())
        reply = await bus.request("svc.a", b"req", timeout=1)
        assert reply == b"reply:req"
        await asyncio.wait_for(t, 2)

    run(main())


def test_bus_work_queue_ack_redelivery(run):
    async def main():
        bus = LocalBus()
        q = bus.work_queue("prefill", redeliver_after=0.0)
        q.push(b"job1")
        item = await q.pop(0.5)
        assert item.payload == b"job1"
        # not acked and visibility timeout 0 -> redelivered
        item2 = await q.pop(0.5)
        assert item2.payload == b"job1"
        assert item2.deliveries == 2
        q.ack(item2.id)
        assert await q.pop(0.05) is None
        assert q.depth == 0

    run(main())


def test_bus_work_queue_wal_replays_unacked(tmp_path, run):
    async def main():
        bus = LocalBus(data_dir=str(tmp_path))
        q = bus.work_queue("prefill")
        q.push(b"a")
        q.push(b"b")
        item = await q.pop(0.5)
        q.ack(item.id)
        q2 = LocalBus(data_dir=str(tmp_path)).work_queue("prefill")
        assert (await q2.pop(0.5)).payload == b"b"
        assert await q2.pop(0.05) is None

    run(main())


def test_bus_object_store_ttl(run):
    async def main():
        bus = LocalBus()
        bus.object_put("mdc", "model-a", b"card", ttl=None)
        assert bus.object_get("mdc", "model-a") == b"card"
        bus.object_put("mdc", "model-b", b"x", ttl=-1.0)  # already expired
        assert bus.object_get("mdc", "model-b") is None
        assert bus.object_list("mdc") == ["model-a"]

    run(main())


# ---------------- cancellation ----------------


def test_cancellation_tree(run):
    async def main():
        root = CancellationToken()
        child = root.child_token()
        grand = child.child_token()
        fired = []
        grand.on_cancel(lambda: fired.append("g"))
        child.cancel()
        assert not root.is_cancelled()
        assert child.is_cancelled() and grand.is_cancelled()
        assert fired == ["g"]

    run(main())


# ---------------- the Worker main() wrapper ----------------


def test_worker_sigterm_cancels_main_then_revokes_the_lease():
    """SIGTERM reaches the worker's loop: its main is cancelled and runs its
    cleanup inside the grace deadline, then the runtime (built by the async
    factory, in the worker's own loop) revokes its lease, which deletes the
    lease's keys, and ``execute`` returns."""
    store = LocalStore()
    seen = {}

    async def runtime():
        seen["factory_loop"] = asyncio.get_running_loop()
        return DistributedRuntime(store=store)

    async def main(drt):
        assert asyncio.get_running_loop() is seen["factory_loop"]
        seen["lease"] = drt.primary_lease_id
        store.kv_put("instances/w", b"x", lease_id=drt.primary_lease_id)
        os.kill(os.getpid(), signal.SIGTERM)
        try:
            await asyncio.wait_for(asyncio.Event().wait(), 30)
        finally:
            await asyncio.sleep(0.01)
            seen["cleaned"] = store.kv_get("instances/w") is not None

    Worker(runtime).execute(main)
    assert seen["cleaned"]
    assert not store.keep_alive(seen["lease"])
    assert store.kv_get("instances/w") is None


def test_worker_overrunning_its_grace_deadline_exits_911(monkeypatch):
    """A main that ignores its cancellation past
    ``DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT`` ends the process with 911."""
    monkeypatch.setenv("DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT", "0.2")

    async def main(drt):
        drt.runtime.shutdown()
        try:
            await asyncio.Event().wait()
        except asyncio.CancelledError:
            await asyncio.sleep(30)

    with pytest.raises(SystemExit) as exited:
        Worker(DistributedRuntime(store=LocalStore())).execute(main)
    assert exited.value.code == 911


# ---------------- pipeline ----------------


class DoubleEcho(AsyncEngine):
    """Fake backend: yields each input token id twice."""

    async def generate(self, request: Context):
        for tok in request.data:
            yield tok
            yield tok


class PrePost(Operator):
    """Bidirectional stage: +1 on the way in, *10 on the way out."""

    async def generate(self, request: Context, next_engine: AsyncEngine):
        mapped = request.map(lambda toks: [t + 1 for t in toks])
        async for resp in next_engine.generate(mapped):
            yield resp * 10


def test_pipeline_link_forward_and_backward(run):
    async def main():
        engine = link(PrePost(), DoubleEcho())
        out = await collect(engine.generate(Context([1, 2])))
        assert out == [20, 20, 30, 30]

    run(main())


def test_map_operator_and_engine_fn(run):
    async def main():
        async def gen(req: Context):
            yield sum(req.data)

        engine = link(MapOperator(fwd=lambda x: x + [10], bwd=lambda r: -r), EngineFn(gen))
        out = await collect(engine.generate(Context([1, 2])))
        assert out == [-13]

    run(main())


# ---------------- TCP response plane across implementations ----------------

SIDES = {"port": (port_tcp, Annotated, AsyncEngineContext),
         "reference": (ref_tcp, RefAnnotated, RefContext)}


@pytest.mark.parametrize("caller,worker", [("port", "reference"),
                                           ("reference", "port"),
                                           ("port", "port")])
def test_response_stream_between_implementations(run, caller, worker):
    """A caller's ``TcpStreamServer`` takes a worker's connect-back from the
    other implementation: the items arrive in order, a worker-side error
    frame surfaces as an error item, and the caller's stop reaches the
    worker's context."""
    c_tcp, c_ann, c_ctx = SIDES[caller]
    w_tcp, w_ann, w_ctx = SIDES[worker]

    async def main():
        srv = c_tcp.TcpStreamServer()
        await srv.start()
        try:
            ctx = c_ctx("r1")
            info = srv.register(ctx)
            wctx = w_ctx("r1")
            writer = await asyncio.wait_for(w_tcp.connect_response_stream(
                w_tcp.ConnectionInfo(info.address, info.stream_id), wctx), 5)
            stream = srv.stream(info)
            for i in range(3):
                await writer.send(w_ann.from_data({"token_ids": [i]}))
            got = [await asyncio.wait_for(stream.__anext__(), 5) for _ in range(3)]
            assert [a.data["token_ids"] for a in got] == [[0], [1], [2]]
            ctx.stop_generating()
            for _ in range(200):
                if wctx.is_stopped():
                    break
                await asyncio.sleep(0.01)
            assert wctx.is_stopped() and not wctx.is_killed()
            await writer.error("boom")
            last = await asyncio.wait_for(stream.__anext__(), 5)
            assert last.is_error() and "boom" in str(last.error)
            await writer.close()
            with pytest.raises(StopAsyncIteration):
                await asyncio.wait_for(stream.__anext__(), 5)
        finally:
            await srv.close()

    run(main())
