"""Disaggregated prefill/decode in the port (``dynamo_tpu_torch.disagg``) on
the CPU, against the reference package (``dynamo_tpu.disagg``).

Copies of ``tests/test_disagg.py`` pointed at the port (policy, queue,
the transfer plane's bulk and streamed round trips and its malformed
streams, the handoff matrix against an aggregated engine, MLA, first-token
logprobs, the in-process pipe, a prefill worker killed mid-stream, the
timeout) and of ``tests/test_kv_rearrange.py``'s head regroups; the
transfer plane's frames held byte for byte to the reference's for the same
blocks (bulk, streamed, int8 and fp8 wire with scale frames, an error);
and the two packages interoperating through one hub: a port prefill worker
feeding a JAX ``DisaggEngine`` and the reverse, streamed and bulk, over a
bf16 and an int8 wire. Tiny f32 models share the JAX package's weights
(``models/weights.py from_jax_params``), so greedy tokens are equal
exactly; logprobs agree to 1e-4 within the port, to 1e-3 across the
packages over bf16 pages.
"""

import asyncio
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamo_tpu.disagg as ref_disagg
import dynamo_tpu.disagg.transfer as ref_transfer
import dynamo_tpu.kv_router.protocols as ref_kvp
import dynamo_tpu.ops.kv_rearrange as ref_rearrange
import dynamo_tpu.runtime as ref_rt
import dynamo_tpu.runtime.hub as ref_hub
import dynamo_tpu_torch.runtime.hub as port_hub
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStops
from dynamo_tpu_torch.disagg import (
    ConditionalDisaggRouter,
    DisaggConfig,
    DisaggEngine,
    KvTransferServer,
    LocalKvPipe,
    PrefillQueue,
    PrefillWorker,
    RemotePrefillRequest,
    disagg_config_key,
)
from dynamo_tpu_torch.disagg.transfer import KvStreamSender, send_kv_blocks
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.kvquant import quantize_stack
from dynamo_tpu_torch.kv_router.protocols import KvPeerFetchRequest
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops.kv_rearrange import (
    expand_kv_heads,
    layout_mismatched,
    rearrange_for_decode,
    regroup_heads,
)
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context, DistributedRuntime, collect

GEOMETRY = dict(num_blocks=64, block_size=4, max_batch_size=4, max_context=128,
                prefill_chunk=32)
PROMPT = list(range(10, 34))  # 24 tokens >> max_local 8 -> remote
#: logprob tolerance where the KV crossed packages as bf16 pages: an f32
#: value the two packages compute a few ulps apart may round to bf16 one
#: step apart, which moves a later logprob by ~2e-4 on the tiny model
LP_ATOL = 1e-3

_MODELS: dict = {}


def _models(family: str = "tiny"):
    """(JAX config, JAX params, port config, port params) of one tiny f32
    model, made once per module (the reference's programs compile once
    per config object)."""
    if family not in _MODELS:
        jcfg = getattr(JaxModelConfig, family)(dtype="float32")
        jparams = JaxEngine(JaxEngineConfig(model=jcfg, **GEOMETRY), seed=7).params
        tcfg = getattr(ModelConfig, family)(dtype="float32")
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
        _MODELS[family] = (jcfg, jparams, tcfg, tparams)
    return _MODELS[family]


def torch_engine(family="tiny", **kw) -> TorchEngine:
    _j, _jp, tcfg, tparams = _models(family)
    return TorchEngine(EngineConfig(model=tcfg, **{**GEOMETRY, **kw}),
                       params=tparams, device="cpu")


def jax_engine(family="tiny", **kw) -> JaxEngine:
    jcfg, jparams, _t, _tp = _models(family)
    return JaxEngine(JaxEngineConfig(model=jcfg, **{**GEOMETRY, **kw}),
                     params=jparams)


def make_req(tokens, max_tokens=6, logprobs=None, api="torch"):
    req, stops, samp = ((PreprocessedRequest, StopConditions, SamplingOptions)
                        if api == "torch" else (JaxRequest, JaxStops, JaxSampling))
    return req(token_ids=list(tokens),
               stop_conditions=stops(max_tokens=max_tokens),
               sampling_options=samp(temperature=0.0, seed=0, logprobs=logprobs),
               eos_token_ids=[511])


def tokens_of(outs) -> list:
    return [t for o in outs for t in o.token_ids]


async def disagg_stack(router_len=8, **router_kw):
    """An in-process runtime with a disagg router and a prefill queue."""
    drt = await DistributedRuntime.from_settings()
    router = ConditionalDisaggRouter(
        drt, "dynamo", "tiny",
        DisaggConfig(max_local_prefill_length=router_len, **router_kw))
    await router.start()
    return drt, router


# ---------------- policy and wire types ----------------


def test_disagg_config_roundtrip():
    cfg = DisaggConfig(max_local_prefill_length=100, max_prefill_queue_size=4)
    assert DisaggConfig.from_json(cfg.to_json()) == cfg


@pytest.mark.parametrize("kind", ["config", "remote prefill", "peer fetch", "key"])
def test_wire_types_are_the_references_bytes(kind):
    """The same JSON bytes as the reference's, each way."""
    if kind == "config":
        ours = DisaggConfig(max_local_prefill_length=77, max_prefill_queue_size=3)
        theirs = ref_disagg.DisaggConfig(max_local_prefill_length=77,
                                         max_prefill_queue_size=3)
        assert ours.to_json() == theirs.to_json()
        assert ref_disagg.DisaggConfig.from_json(ours.to_json()) == theirs
    elif kind == "remote prefill":
        fields = dict(request_id="r1", request=make_req([1, 2, 3]).to_dict(),
                      skip_blocks=2, connection={"address": "h:1", "kv_stream": 2},
                      engine_id=5, enqueue_ts=12.5)
        ours = RemotePrefillRequest(**fields).to_bytes()
        assert ours == ref_disagg.RemotePrefillRequest(**fields).to_bytes()
        assert RemotePrefillRequest.from_bytes(ours).skip_blocks == 2
    elif kind == "peer fetch":
        fields = dict(peer_worker_id=1, src_worker_id=2, request_id="p",
                      hashes=[3, 4], connection={"address": "h:1"}, accept_quant=1)
        ours = KvPeerFetchRequest(**fields).to_bytes()
        assert ours == ref_kvp.KvPeerFetchRequest(**fields).to_bytes()
        assert KvPeerFetchRequest.from_bytes(ours) == KvPeerFetchRequest(**fields)
    else:
        assert disagg_config_key("ns", "m") == ref_disagg.protocols.disagg_config_key(
            "ns", "m")


def test_disagg_decision_logic(run):
    async def main():
        drt, r = await disagg_stack(router_len=512)
        # short prompt local; long remote; cached prefix subtracts
        assert not r.prefill_remote(100, 0, 0)
        assert r.prefill_remote(1000, 0, 0)
        assert not r.prefill_remote(1000, 600, 0)
        # queue-depth cutoff
        await r.update(DisaggConfig(max_local_prefill_length=512,
                                    max_prefill_queue_size=2))
        assert not r.prefill_remote(1000, 0, 5)
        assert r.prefill_remote(1000, 0, 1)
        await r.stop()
        await drt.shutdown()

    run(main())


def test_disagg_config_hot_reload(run):
    async def main():
        drt = await DistributedRuntime.from_settings()
        r = ConditionalDisaggRouter(drt, "dynamo", "m")
        await r.start()
        # a second router (an ops CLI) updates the store; the first sees it
        r2 = ConditionalDisaggRouter(drt, "dynamo", "m")
        await r2.start()
        await r2.update(DisaggConfig(max_local_prefill_length=7777))
        for _ in range(50):
            if r.config.max_local_prefill_length == 7777:
                break
            await asyncio.sleep(0.01)
        assert r.config.max_local_prefill_length == 7777
        await r.stop()
        await r2.stop()
        await drt.shutdown()

    run(main())


def test_prefill_queue_ack_nack(run):
    async def main():
        drt = await DistributedRuntime.from_settings()
        q = PrefillQueue(drt.bus, redeliver_after=0.2)
        rpr = RemotePrefillRequest(
            request_id="r1", request=make_req([1, 2, 3]).to_dict(),
            skip_blocks=0, connection={"local": True})
        await q.enqueue(rpr)
        assert q.depth == 1
        item_id, got = await q.dequeue(timeout=1.0)
        assert got.request_id == "r1" and got.skip_blocks == 0
        # nack -> redelivered
        await q.nack(item_id)
        item_id2, got2 = await q.dequeue(timeout=1.0)
        assert got2.request_id == "r1"
        assert await q.ack(item_id2)
        assert q.depth == 0
        # visibility timeout redelivery without ack
        await q.enqueue(rpr)
        await q.dequeue(timeout=1.0)
        await asyncio.sleep(0.3)
        redelivered = await q.dequeue(timeout=1.0)
        assert redelivered is not None
        await q.ack(redelivered[0])
        await drt.shutdown()

    run(main())


# ---------------- the transfer plane ----------------


def _stack(shape, seed, dtype=torch.float32):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


def test_kv_transfer_tcp_roundtrip(run):
    async def main():
        srv = KvTransferServer(host="127.0.0.1")
        await srv.start()
        fut = srv.expect("req-9")
        k, v = _stack((4, 2, 3, 4, 8), 0), _stack((4, 2, 3, 4, 8), 1)
        await send_kv_blocks(srv.address, "req-9", 42, k, v, layer_chunk=3)
        d = await asyncio.wait_for(fut, 5)
        assert d.first_token == 42 and d.n_blocks == 3
        assert torch.equal(d.k_data, k) and torch.equal(d.v_data, v)
        # error notification path
        fut2 = srv.expect("req-10")
        await send_kv_blocks(srv.address, "req-10", -1, None, None, error="boom")
        d2 = await asyncio.wait_for(fut2, 5)
        assert d2.error == "boom" and d2.n_blocks == 0
        await srv.close()

    run(main())


def test_kv_stream_tcp_roundtrip(run):
    """Streamed protocol with NO registered sink: segments buffer on the
    receiver and the delivery equals the bulk path's full stack. Headers
    carry an unknown key (it must be ignored)."""

    async def main():
        srv = KvTransferServer(host="127.0.0.1")
        await srv.start()
        fut = srv.expect("req-s1")
        k = _stack((4, 2, 5, 4, 8), 2, torch.bfloat16)
        v = _stack((4, 2, 5, 4, 8), 3, torch.bfloat16)
        head = {
            "request_id": "req-s1", "stream": 1, "n_blocks": 5,
            "shape": [4, 2, 5, 4, 8], "v_shape": [4, 2, 5, 4, 8],
            "dtype": "bfloat16", "layer_chunk": 3,
            "head_layout": "blocked", "src_tp": 1,
            "future_knob": {"x": 1},  # unknown key: must be ignored
        }
        sender = await KvStreamSender.open(srv.address, "req-s1", head)
        await sender.send_segment(0, k[:, :, :2], v[:, :, :2])
        await sender.send_segment(2, k[:, :, 2:], v[:, :, 2:])
        await sender.finish(77, {"logprob": -0.5})
        d = await asyncio.wait_for(fut, 5)
        assert d.first_token == 77 and d.n_blocks == 5 and not d.streamed
        assert d.first_lp == {"logprob": -0.5}
        assert torch.equal(d.k_data.view(torch.int16), k.view(torch.int16))
        assert torch.equal(d.v_data.view(torch.int16), v.view(torch.int16))
        # zero-block stream: header + fin only
        fut0 = srv.expect("req-s0")
        head0 = dict(head, request_id="req-s0", n_blocks=0,
                     shape=[4, 2, 0, 4, 8], v_shape=[4, 2, 0, 4, 8])
        sender0 = await KvStreamSender.open(srv.address, "req-s0", head0)
        await sender0.finish(12)
        d0 = await asyncio.wait_for(fut0, 5)
        assert d0.first_token == 12 and d0.n_blocks == 0
        assert d0.k_data is None and d0.error is None
        await srv.close()

    run(main())


def test_kv_stream_truncation_leaves_future_pending(run):
    """A sender dying mid-stream must NOT resolve the delivery future: the
    redelivered attempt completes the same future."""

    async def main():
        srv = KvTransferServer(host="127.0.0.1")
        await srv.start()
        fut = srv.expect("req-t1")
        k = torch.zeros((2, 2, 4, 4, 8))
        head = {
            "request_id": "req-t1", "stream": 1, "n_blocks": 4,
            "shape": [2, 2, 4, 4, 8], "v_shape": [2, 2, 4, 4, 8],
            "dtype": "float32", "layer_chunk": 1,
            "head_layout": "blocked", "src_tp": 1,
        }
        sender = await KvStreamSender.open(srv.address, "req-t1", head)
        await sender.send_segment(0, k[:, :, :2], k[:, :, :2])
        await sender.aclose()  # dies before fin
        await asyncio.sleep(0.1)
        assert not fut.done()
        sender2 = await KvStreamSender.open(srv.address, "req-t1", head)
        await sender2.send_segment(0, k[:, :, :2], k[:, :, :2])
        await sender2.send_segment(2, k[:, :, 2:], k[:, :, 2:])
        await sender2.finish(5)
        d = await asyncio.wait_for(fut, 5)
        assert d.first_token == 5 and d.n_blocks == 4
        await srv.close()

    run(main())


def test_kv_bulk_zero_block_delivery(run):
    """A bulk zero-block delivery (the decode side's prefix cache covered
    every block) ships dtype "": the receiver acks and resolves cleanly."""

    async def main():
        srv = KvTransferServer(host="127.0.0.1")
        await srv.start()
        fut = srv.expect("req-b0")
        await send_kv_blocks(srv.address, "req-b0", 42, None, None)
        d = await asyncio.wait_for(fut, 5)
        assert d.first_token == 42 and d.n_blocks == 0
        assert d.k_data is None and d.error is None
        await srv.close()

    run(main())


def test_kv_bulk_drifted_header_forces_redelivery(run):
    """A header whose n_blocks went missing while its shape declares real
    blocks is not acked as a zero-block delivery: no ack, the future
    stays pending for the redelivery."""
    from dynamo_tpu_torch.runtime.codec import TwoPartMessage, write_frame

    async def main():
        srv = KvTransferServer(host="127.0.0.1")
        await srv.start()
        fut = srv.expect("req-drift")
        host, port = srv.address.address.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        head = {"request_id": "req-drift", "shape": [2, 2, 3, 4, 8],
                "v_shape": [2, 2, 3, 4, 8], "dtype": "float32", "layer_chunk": 1}
        await write_frame(writer, TwoPartMessage(json.dumps(head).encode(), b""))
        assert await asyncio.wait_for(reader.read(2), 5) == b""  # EOF, no ack
        assert not fut.done()
        writer.close()
        await writer.wait_closed()
        srv.abandon("req-drift")
        await srv.close()

    run(main())


# ---------------- frames byte for byte ----------------


async def _capture(send) -> bytes:
    """Every byte one transfer writes: a raw receiver that parses only the
    frame lengths (bulk: the header's layer chunks; streamed: up to the fin
    frame), then acks."""
    got = bytearray()
    done = asyncio.get_running_loop().create_future()

    async def frame(reader):
        prefix = await reader.readexactly(15)
        _m, _f, hl, dl = struct.unpack(">2sBIQ", prefix)
        body = await reader.readexactly(hl + dl)
        got.extend(prefix + body)
        return json.loads(body[:hl]) if hl else {}

    async def handle(reader, writer):
        try:
            head = await frame(reader)
            if head.get("stream"):
                while not (await frame(reader)).get("fin"):
                    pass
            elif not head.get("error") and head.get("n_blocks"):
                L, c = head["shape"][0], head["layer_chunk"]
                for _ in range(-(-L // c)):
                    await frame(reader)
            writer.write(b"ok")
            await writer.drain()
            done.set_result(None)
        finally:
            writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    conn = {"address": f"127.0.0.1:{server.sockets[0].getsockname()[1]}",
            "stream_id": "kv"}
    await send(conn)
    await asyncio.wait_for(done, 5)
    server.close()
    await server.wait_closed()
    return bytes(got)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """The reference's host array of a CPU tensor (bf16 / e4m3 through
    ml_dtypes, which the JAX package uses)."""
    views = {torch.bfloat16: (torch.int16, jnp.bfloat16),
             torch.float8_e4m3fn: (torch.uint8, jnp.float8_e4m3fn)}
    if t.dtype in views:
        raw, dt = views[t.dtype]
        return t.view(raw).numpy().view(dt)
    return t.numpy()


@pytest.mark.parametrize("case", ["bulk f32", "bulk bf16", "stream bf16",
                                  "bulk int8 wire", "stream int8 wire",
                                  "stream fp8 wire", "error"])
def test_frames_are_the_references_bytes(run, case):
    """The port's sender writes exactly the reference's bytes for the same
    blocks: headers, layer-chunked payloads, scale frames, fin."""
    dtype = torch.float32 if "f32" in case else torch.bfloat16
    k, v = _stack((5, 2, 6, 4, 8), 4, dtype), _stack((5, 2, 6, 4, 8), 5, dtype)
    ks = vs = None
    quant = "int8" if "int8" in case else "fp8" if "fp8" in case else "none"
    if quant != "none":
        k, v, ks, vs = quantize_stack(k, v, quant)
    args = dict(first_lp={"logprob": -0.25, "top": [[3, -0.25]]})

    def ours(conn):
        if case == "error":
            return send_kv_blocks(conn, "rq", -1, None, None, error="boom")
        if case.startswith("bulk"):
            return send_kv_blocks(conn, "rq", 7, k, v, layer_chunk=2, kv_quant=quant,
                                  k_scales=ks, v_scales=vs, **args)
        return stream(KvStreamSender, conn, k, v, ks, vs)

    def theirs(conn):
        if case == "error":
            return ref_transfer.send_kv_blocks(conn, "rq", -1, None, None,
                                               error="boom")
        nk, nv = _as_numpy(k), _as_numpy(v)
        nks = None if ks is None else ks.numpy()
        nvs = None if vs is None else vs.numpy()
        if case.startswith("bulk"):
            return ref_transfer.send_kv_blocks(
                conn, "rq", 7, nk, nv, layer_chunk=2, kv_quant=quant,
                k_scales=nks, v_scales=nvs, **args)
        return stream(ref_transfer.KvStreamSender, conn, nk, nv, nks, nvs)

    async def stream(cls, conn, k, v, ks, vs):
        head = {"request_id": "rq", "stream": 2, "n_blocks": 6,
                "shape": list(k.shape), "v_shape": list(v.shape),
                "dtype": str(k.dtype).removeprefix("torch."),
                "layer_chunk": 2, "head_layout": "blocked", "src_tp": 1}
        if ks is not None:
            head["kv_quant"] = quant
        s = await cls.open(conn, "rq", head)
        for b0, b1 in ((0, 4), (4, 6)):
            sc = () if ks is None else (ks[:, b0:b1], vs[:, b0:b1])
            await s.send_segment(b0, k[:, :, b0:b1], v[:, :, b0:b1], *sc)
        await s.finish(7, args["first_lp"])

    async def main():
        a = await _capture(ours)
        b = await _capture(theirs)
        assert len(a) > 100 and a == b

    run(main())


# ---------------- end to end ----------------


@pytest.mark.parametrize("kv_stream", [True, False])
@pytest.mark.parametrize("mode", ["local_pipe", "tcp"])
def test_disagg_end_to_end_matches_aggregated(run, mode, kv_stream):
    """The handoff matrix: {local pipe, TCP} x {streamed, bulk} all land a
    first token and a decode continuation equal to aggregated serving (the
    port's engine and the reference's), each flavor asserted engaged; a
    short prompt stays local, and so does a repeat whose prefix the decode
    side now holds."""

    async def main():
        drt, router = await disagg_stack()
        queue = PrefillQueue(drt.bus)
        decode, prefill = torch_engine(), torch_engine()
        if mode == "local_pipe":
            transfer = LocalKvPipe()
            worker = PrefillWorker(prefill, queue, local_pipe=transfer,
                                   kv_stream=kv_stream)
        else:
            transfer = KvTransferServer(host="127.0.0.1")
            await transfer.start()
            worker = PrefillWorker(prefill, queue, layer_chunk=1, kv_stream=kv_stream)
        worker.start()
        eng = DisaggEngine(decode, router, queue, transfer, kv_stream=kv_stream)
        outs = await collect(eng.generate(Context(make_req(PROMPT))))
        toks = tokens_of(outs)
        assert outs[-1].finish_reason in (FinishReason.LENGTH, FinishReason.EOS)
        assert eng.stats["remote_prefills"] == 1
        assert worker.stats["prefills_total"] == 1
        if kv_stream:
            assert eng.stats["streamed_deliveries"] == 1
            assert worker.stats["kv_stream_sends"] == 1
            assert worker.stats["kv_stream_segments"] >= 1
        else:
            assert eng.stats["bulk_deliveries"] == 1
            assert worker.stats["kv_bulk_sends"] == 1
        rec = eng.handoffs[-1]
        assert rec["n_blocks"] == 6 and rec["handoff_ms"] > 0
        assert worker.handoffs[-1]["queue_wait_ms"] >= 0
        assert decode.load_metrics()["hist_handoff_ms"]["n"] == 1  # one observed

        ref = torch_engine()
        assert toks == tokens_of(await collect(ref.generate(Context(make_req(PROMPT)))))
        jref = jax_engine()
        jouts = await ref_rt.collect(jref.generate(
            ref_rt.Context(make_req(PROMPT, api="jax"))))
        assert toks == tokens_of(jouts)

        # short prompt stays local
        outs2 = await collect(eng.generate(Context(make_req([1, 2, 3], 3))))
        assert eng.stats["local_prefills"] == 1 and tokens_of(outs2)
        # the decode side's prefix cache now covers the prompt: local
        outs3 = await collect(eng.generate(Context(make_req(PROMPT))))
        assert tokens_of(outs3) == toks
        assert eng.stats["local_prefills"] == 2

        await worker.close()
        if mode == "tcp":
            await transfer.close()
        for e in (decode, prefill, ref, jref):
            await e.close()
        await router.stop()
        await drt.shutdown()

    run(main())


@pytest.mark.parametrize("kv_stream", [True, False])
def test_disagg_into_an_int8_cache_keeps_the_landed_scales(run, kv_stream):
    """Both workers over int8-with-scales pages: the prefill side's extract
    dequantizes (one dequantizing scatter into a fresh stack), the decode
    side requantizes on landing, its reservation's scale resets flushed
    BEFORE the landing; the tokens equal aggregated serving's over the
    same cache, the reference's included. (C.17: the reference's landing
    resets the landed scales at its next dispatch.)"""

    async def main():
        drt, router = await disagg_stack()
        queue = PrefillQueue(drt.bus)
        decode = torch_engine(kv_cache_dtype="int8")
        prefill = torch_engine(kv_cache_dtype="int8")
        transfer = KvTransferServer(host="127.0.0.1")
        await transfer.start()
        worker = PrefillWorker(prefill, queue, layer_chunk=1, kv_stream=kv_stream)
        worker.start()
        eng = DisaggEngine(decode, router, queue, transfer, kv_stream=kv_stream)
        toks = tokens_of(await collect(eng.generate(Context(make_req(PROMPT)))))
        assert eng.stats["remote_prefills"] == 1
        assert prefill.stats["kv_device_export_requant_total"] == 6
        jref = jax_engine(kv_cache_dtype="int8")
        jouts = await ref_rt.collect(jref.generate(
            ref_rt.Context(make_req(PROMPT, api="jax"))))
        assert toks == tokens_of(jouts)
        await worker.close()
        await transfer.close()
        for e in (decode, prefill, jref):
            await e.close()
        await router.stop()
        await drt.shutdown()

    run(main())


def test_disagg_mla_kv_transfer_matches_aggregated(run):
    """The MLA family: the transfer plane carries the latent cache's
    different k / v widths over TCP (streamed) and the decode stream equals
    aggregated serving."""

    async def main():
        drt, router = await disagg_stack()
        queue = PrefillQueue(drt.bus)
        decode, prefill = torch_engine("tiny_mla"), torch_engine("tiny_mla")
        assert decode.k_cache.shape[-1] != decode.v_cache.shape[-1]
        transfer = KvTransferServer(host="127.0.0.1")
        await transfer.start()
        worker = PrefillWorker(prefill, queue, layer_chunk=1)
        worker.start()
        eng = DisaggEngine(decode, router, queue, transfer)
        toks = tokens_of(await collect(eng.generate(Context(make_req(PROMPT)))))
        assert eng.stats["remote_prefills"] == 1
        assert eng.stats["streamed_deliveries"] == 1
        ref = torch_engine("tiny_mla")
        assert toks == tokens_of(await collect(ref.generate(Context(make_req(PROMPT)))))
        await worker.close()
        await transfer.close()
        for e in (decode, prefill, ref):
            await e.close()
        await router.stop()
        await drt.shutdown()

    run(main())


def test_disagg_first_token_carries_logprobs(run):
    """A logprobs request served by remote prefill emits an entry for the
    FIRST token too (computed on the prefill worker, carried with the KV),
    equal to aggregated serving's."""

    async def main():
        drt, router = await disagg_stack()
        queue = PrefillQueue(drt.bus)
        decode, prefill = torch_engine(), torch_engine()
        transfer = KvTransferServer(host="127.0.0.1")
        await transfer.start()
        worker = PrefillWorker(prefill, queue, layer_chunk=1)
        worker.start()
        eng = DisaggEngine(decode, router, queue, transfer)
        outs = await collect(eng.generate(Context(make_req(PROMPT, 5, logprobs=3))))
        assert eng.stats["remote_prefills"] == 1
        entries = [e for o in outs for e in (o.logprobs or [])]
        assert len(entries) == len(tokens_of(outs))
        assert all(len(e["top"]) == 3 for e in entries)
        ref = torch_engine()
        ref_outs = await collect(ref.generate(Context(make_req(PROMPT, 5, logprobs=3))))
        ref_entries = [e for o in ref_outs for e in (o.logprobs or [])]
        np.testing.assert_allclose([e["logprob"] for e in entries],
                                   [e["logprob"] for e in ref_entries],
                                   rtol=1e-4, atol=1e-4)
        assert [[t[0] for t in e["top"]] for e in entries] == [
            [t[0] for t in e["top"]] for e in ref_entries]
        await worker.close()
        await transfer.close()
        for e in (decode, prefill, ref):
            await e.close()
        await router.stop()
        await drt.shutdown()

    run(main())


@pytest.mark.parametrize("kv_stream", [True, False])
def test_disagg_local_pipe_hands_over_engine_tensors(run, kv_stream):
    """The in-process pipe hands the gather's own tensors, on the engine's
    device, straight to the decode landing: nothing serialized (on the
    card, CUDA tensors: no host hop). Both flavors: the bulk delivery's
    stack and every streamed segment through the scatter sink."""

    async def main():
        drt, router = await disagg_stack()
        queue = PrefillQueue(drt.bus)
        decode, prefill = torch_engine(), torch_engine()
        transfer = LocalKvPipe()
        seen = []
        orig_deliver = transfer.deliver
        orig_scatter = decode.scatter_remote_segment
        orig_gather = prefill._gather_device
        gathered = []

        def spy_gather(*a, **kw):
            out = orig_gather(*a, **kw)
            gathered.append(out)
            return out

        async def spy_deliver(request_id, first_token, k_data, v_data, **kw):
            seen.append((k_data, v_data))
            await orig_deliver(request_id, first_token, k_data, v_data, **kw)

        async def spy_scatter(handle, b0, k_data, v_data, *scales):
            seen.append((k_data, v_data))
            await orig_scatter(handle, b0, k_data, v_data, *scales)

        transfer.deliver = spy_deliver
        decode.scatter_remote_segment = spy_scatter
        prefill._gather_device = spy_gather
        worker = PrefillWorker(prefill, queue, local_pipe=transfer, kv_stream=kv_stream)
        worker.start()
        eng = DisaggEngine(decode, router, queue, transfer, kv_stream=kv_stream)
        outs = await collect(eng.generate(Context(make_req(list(range(50, 74)), 4))))
        assert tokens_of(outs)
        assert eng.stats["streamed_deliveries" if kv_stream else "bulk_deliveries"] == 1
        assert len(seen) == len(gathered) >= 1
        for (k, v), g in zip(seen, gathered):
            assert k is g[0] and v is g[1]  # the gather's tensors themselves
            assert k.device == decode.device
        await worker.close()
        for e in (decode, prefill):
            await e.close()
        await router.stop()
        await drt.shutdown()

    run(main())


@pytest.mark.faultinject
def test_disagg_streamed_kill_mid_stream_redelivers_once(run):
    """A prefill worker killed MID-STREAM (segments already landed) looks
    like a crash: no ack, the half-landed stream resolves nothing, and a
    survivor's redelivery re-streams over the SAME reserved pages; the
    decode side sees one delivery and tokens equal to aggregated serving."""
    from dynamo_tpu_torch.resilience import faultpoints

    async def main():
        drt, router = await disagg_stack()
        queue = PrefillQueue(drt.bus, redeliver_after=1.5)
        decode, prefill = torch_engine(), torch_engine()
        transfer = KvTransferServer(host="127.0.0.1")
        await transfer.start()
        # segment_blocks=2 splits the 6-block prompt into 3 segments
        worker_a = PrefillWorker(prefill, queue, layer_chunk=1, segment_blocks=2)
        worker_a.start()
        eng = DisaggEngine(decode, router, queue, transfer)
        try:
            # hit 1 = stream open, hits 2+ = one per segment: the 3rd hit
            # kills worker A after a segment scattered into the decode cache
            faultpoints.arm("mid_kv_transfer", "kill", after=3, times=1)
            gen = asyncio.ensure_future(collect(eng.generate(Context(make_req(PROMPT)))))
            for _ in range(100):
                if worker_a._stop.is_set():
                    break
                await asyncio.sleep(0.05)
            assert worker_a._stop.is_set(), "fault point never fired"
            assert worker_a.stats["kv_stream_sends"] == 0
            assert eng.stats["kv_stream_segments"] >= 1  # landed before the kill
            prefill_b = torch_engine()
            worker_b = PrefillWorker(prefill_b, queue, layer_chunk=1, segment_blocks=2)
            worker_b.start()
            outs = await asyncio.wait_for(gen, 30)
            toks = tokens_of(outs)
            assert outs[-1].finish_reason in (FinishReason.LENGTH, FinishReason.EOS)
            ref = torch_engine()
            assert toks == tokens_of(await collect(ref.generate(Context(make_req(PROMPT)))))
            assert eng.stats["streamed_deliveries"] == 1
            assert worker_b.stats["kv_stream_sends"] == 1
            assert await queue.get_depth() == 0
            await worker_b.close()
            for e in (prefill_b, ref):
                await e.close()
        finally:
            faultpoints.reset()
            await worker_a.close()
            await transfer.close()
            for e in (decode, prefill):
                await e.close()
            await router.stop()
            await drt.shutdown()

    run(main())


def test_disagg_timeout_fails_request(run):
    async def main():
        drt, router = await disagg_stack(router_len=4)
        queue = PrefillQueue(drt.bus)
        decode = torch_engine()
        # no prefill worker running -> the delivery never arrives
        eng = DisaggEngine(decode, router, queue, LocalKvPipe(), transfer_timeout=0.3)
        outs = await collect(eng.generate(Context(make_req(list(range(20))))))
        assert outs[-1].finish_reason == FinishReason.ERROR
        assert decode.allocator.used_count == 0  # the pages went back
        await decode.close()
        await router.stop()
        await drt.shutdown()

    run(main())


# ---------------- kv-head layouts ----------------


def _heads(heads=8, L=2, n=3, bs=4, D=5) -> torch.Tensor:
    # the value at [l, h, ...] is the head id, so permutations show
    x = torch.zeros((L, heads, n, bs, D))
    for h in range(heads):
        x[:, h] = h
    return x


@pytest.mark.parametrize("case", ["roundtrip", "shard contents", "identity",
                                  "expand", "never expands", "mismatch rule"])
def test_kv_rearrange(case):
    """The head regroups of ``tests/test_kv_rearrange.py`` on torch tensors,
    each against the reference's numpy result."""
    x = _heads()
    if case == "roundtrip":
        y = regroup_heads(x, tp=4, src_layout="blocked", dst_layout="interleaved")
        back = regroup_heads(y, tp=4, src_layout="interleaved", dst_layout="blocked")
        assert torch.equal(back, x) and not torch.equal(y, x)
        np.testing.assert_array_equal(
            y.numpy(), ref_rearrange.regroup_heads(x.numpy(), 4, "blocked",
                                                   "interleaved"))
    elif case == "shard contents":
        heads, tp = 8, 4
        y = regroup_heads(x, tp=tp, src_layout="blocked", dst_layout="interleaved")
        per = heads // tp
        for shard in range(tp):
            ids = y[0, shard * per:(shard + 1) * per, 0, 0, 0]
            assert ids.tolist() == [shard + j * tp for j in range(per)]
    elif case == "identity":
        assert regroup_heads(x, tp=2) is x
        assert expand_kv_heads(x, 1) is x
    elif case == "expand":
        y = expand_kv_heads(_heads(heads=4), 2)
        assert y[0, :, 0, 0, 0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
        np.testing.assert_array_equal(
            y.numpy(), ref_rearrange.expand_kv_heads(_heads(heads=4).numpy(), 2))
    elif case == "never expands":
        x4 = _heads(heads=4)
        assert rearrange_for_decode(x4, src_tp=2, dst_tp=8).shape[1] == 4
        y = rearrange_for_decode(x, 2, 1, "interleaved", "blocked")
        np.testing.assert_array_equal(
            y.numpy(), ref_rearrange.rearrange_for_decode(x.numpy(), 2, 1,
                                                         "interleaved", "blocked"))
    else:
        for args in [("blocked", 1, "blocked", 1), ("interleaved", 2, "blocked", 1),
                     ("interleaved", 2, "interleaved", 4),
                     ("interleaved", 2, "interleaved", 2)]:
            assert layout_mismatched(*args) == ref_rearrange.layout_mismatched(*args)


@pytest.mark.parametrize("kv_stream", [True, False])
def test_disagg_delivery_applies_regroup(run, kv_stream):
    """A prefill worker whose KV arrives in *interleaved* head order at tp=2
    (its gather output permuted, its headers declaring so) feeding the
    port's decode engine: the landing regroups (per segment on the
    streamed path, the whole stack on the bulk one) and the tokens equal
    aggregated serving's."""

    async def main():
        drt, router = await disagg_stack()
        queue = PrefillQueue(drt.bus)
        decode, prefill = torch_engine(), torch_engine()
        orig = prefill._gather_device

        def interleaved(*a, **kw):
            return tuple(regroup_heads(t, 2, "blocked", "interleaved")
                         for t in orig(*a, **kw))

        prefill._gather_device = interleaved
        transfer = KvTransferServer(host="127.0.0.1")
        await transfer.start()
        worker = PrefillWorker(prefill, queue, layer_chunk=1,
                               head_layout="interleaved", src_tp=2,
                               kv_stream=kv_stream)
        worker.start()
        eng = DisaggEngine(decode, router, queue, transfer, kv_stream=kv_stream)
        toks = tokens_of(await collect(eng.generate(Context(make_req(PROMPT)))))
        if kv_stream:
            assert eng.stats["kv_stream_regroups"] >= 1
        ref = torch_engine()
        assert toks == tokens_of(await collect(ref.generate(Context(make_req(PROMPT)))))
        await worker.close()
        await transfer.close()
        for e in (decode, prefill, ref):
            await e.close()
        await router.stop()
        await drt.shutdown()

    run(main())


# ---------------- the two packages through one hub ----------------

_EXPECTED: dict = {}


async def _expected(wire: str) -> tuple:
    """(tokens, logprobs) of the all-reference disaggregated run over
    ``wire`` (its codec is the port's byte for byte), which the mixed pairs
    must reproduce; over the bf16 wire it equals aggregated serving."""
    if wire not in _EXPECTED:
        eng = jax_engine(kv_cache_dtype="bfloat16")
        outs = await ref_rt.collect(eng.generate(ref_rt.Context(
            make_req(PROMPT, 6, logprobs=2, api="jax"))))
        await eng.close()
        _EXPECTED["bf16"] = (tokens_of(outs),
                             [e["logprob"] for o in outs for e in o.logprobs])
        if wire == "int8":
            _EXPECTED["int8"] = await _run_pair("jax", "jax", True, "int8")
    return _EXPECTED[wire]


async def _run_pair(prefill_side: str, decode_side: str, kv_stream: bool,
                    wire: str) -> tuple:
    """One remote request through a hub (the port's HubServer; the JAX side
    connects with its own client): the named package's prefill worker and
    decode engine, bf16 KV pages on both, the prefill side's --kv-quant
    ``wire``. Returns (tokens, logprobs)."""
    hub = port_hub.HubServer(host="127.0.0.1", port=0)
    await hub.start()
    sides = {}
    for name, pkg in (("port", (port_hub, DistributedRuntime)),
                      ("jax", (ref_hub, ref_rt.DistributedRuntime))):
        store, bus, conn = await pkg[0].connect_hub(hub.address)
        sides[name] = (await pkg[1].from_settings(store=store, bus=bus), conn)
    kv = dict(kv_cache_dtype="bfloat16")
    quant = {} if wire == "bf16" else dict(kv_quant=wire)
    dname = "port" if decode_side == "torch" else "jax"
    pname = "port" if prefill_side == "torch" else "jax"
    if prefill_side == "torch":
        pre = torch_engine(**kv, **quant)
        worker = PrefillWorker(pre, PrefillQueue(sides[pname][0].bus), layer_chunk=2,
                               kv_stream=kv_stream)
    else:
        pre = jax_engine(**kv, **quant)
        worker = ref_disagg.PrefillWorker(
            pre, ref_disagg.PrefillQueue(sides[pname][0].bus), layer_chunk=2,
            kv_stream=kv_stream, kv_ici=False)
    if decode_side == "torch":
        dec = torch_engine(**kv)
        router = ConditionalDisaggRouter(sides[dname][0], "dynamo", "tiny",
                                         DisaggConfig(max_local_prefill_length=8))
        transfer = KvTransferServer(host="127.0.0.1")
        eng_cls, queue = DisaggEngine, PrefillQueue(sides[dname][0].bus)
        req, ctx, coll = make_req(PROMPT, 6, logprobs=2), Context, collect
    else:
        dec = jax_engine(**kv)
        router = ref_disagg.ConditionalDisaggRouter(
            sides[dname][0], "dynamo", "tiny",
            ref_disagg.DisaggConfig(max_local_prefill_length=8))
        transfer = ref_disagg.KvTransferServer(host="127.0.0.1")
        eng_cls, queue = ref_disagg.DisaggEngine, ref_disagg.PrefillQueue(
            sides[dname][0].bus)
        req, ctx, coll = (make_req(PROMPT, 6, logprobs=2, api="jax"), ref_rt.Context,
                          ref_rt.collect)
    await router.start()
    await transfer.start()
    worker.start()
    # the reference's same-slice landing (disagg/ici.py) is not ported: the
    # all-reference pair runs without it, as the mixed pairs do
    eng = eng_cls(dec, router, queue, transfer, kv_stream=kv_stream,
                  **({} if decode_side == "torch" else dict(kv_ici=False)))
    try:
        outs = await asyncio.wait_for(coll(eng.generate(ctx(req))), 60)
        assert eng.stats["remote_prefills"] == 1
        flavor = "streamed_deliveries" if kv_stream else "bulk_deliveries"
        assert eng.stats[flavor] == 1, eng.stats
        assert worker.stats["kv_quant_sends"] == (wire != "bf16")
    finally:
        await worker.close()
        await router.stop()
        await transfer.close()
        await dec.close()
        await pre.close()
        for d, conn in sides.values():
            await d.shutdown()
            await conn.close()
        await hub.close()
    return tokens_of(outs), [e["logprob"] for o in outs for e in o.logprobs]


@pytest.mark.parametrize("wire", ["bf16", "int8"])
@pytest.mark.parametrize("kv_stream", [True, False])
@pytest.mark.parametrize("prefill_side,decode_side", [("torch", "jax"), ("jax", "torch")],
                         ids=["torch prefill, jax decode", "jax prefill, torch decode"])
def test_prefill_and_decode_interoperate_with_the_reference(run, prefill_side,
                                                            decode_side, kv_stream,
                                                            wire):
    """A port prefill worker feeds a JAX ``DisaggEngine`` and a JAX prefill
    worker feeds the port's, through one hub (queue, connection info and
    transfer frames all the reference's): greedy tokens exactly those of
    the all-reference run (= aggregated serving over the bf16 wire), the
    logprobs (the first one computed by the prefill side's package, the
    rest by the decode side's) within 1e-4."""
    async def main():
        want_toks, want_lps = await _expected(wire)
        toks, lps = await _run_pair(prefill_side, decode_side, kv_stream, wire)
        assert toks == want_toks
        np.testing.assert_allclose(lps, want_lps, rtol=0, atol=LP_ATOL)

    run(main())
