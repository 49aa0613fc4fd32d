"""TorchEngine.warmup, the program ledger and the graph runner's static
inputs, on the CPU.

  * warmup against ``tests/test_engine.py::test_warmup_compiles_buckets_
    and_serving_still_exact``: the bucket sizes, the window ladder,
    speculation held off, ``decode=False``; after warmup a request's stream
    equals a cold TorchEngine's and a JaxEngine's on the same weights, and
    the ledger's keys and the coverage gauges equal the reference's;
  * the decode window and the verify through the engine's static inputs
    (``engine/graphs.py``, the path a CUDA graph replays on the card)
    against direct calls of ``llama.decode_window`` / ``verify_window``
    with freshly uploaded host arrays, bit for bit;
  * ``make_keys`` on device tensors against the host hash and JAX's key
    data.
"""

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.ops import sampling as jsamp
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStops
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu.runtime import collect as jax_collect
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops import sampling
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context, collect
from tests.test_torch_cuda import fill_caches, set_batch

# tests/test_engine.py's engine geometry, at f32
GEOMETRY = dict(num_blocks=64, block_size=4, max_batch_size=4,
                max_context=128, prefill_chunk=32)
PROMPT = list(range(30, 44))


def _torch_req(tokens, n):
    return PreprocessedRequest(token_ids=list(tokens),
                               stop_conditions=StopConditions(max_tokens=n),
                               sampling_options=SamplingOptions(temperature=0.0))


def _jax_req(tokens, n):
    return JaxRequest(token_ids=list(tokens), stop_conditions=JaxStops(max_tokens=n),
                      sampling_options=JaxSampling(temperature=0.0))


def test_warmup_dispatches_buckets_and_serving_still_exact(run):
    """The reference's warmup test on TorchEngine, then the same warmup on
    both engines: equal coverage gauges and ledger keys."""
    jcfg = JaxModelConfig.tiny(dtype="float32")
    tcfg = ModelConfig.tiny(dtype="float32")
    jcold = JaxEngine(JaxEngineConfig(model=jcfg, **GEOMETRY), seed=0)
    params = from_jax_params(jax.tree.map(np.asarray, jcold.params), tcfg)

    def torch_engine(**kw):
        return TorchEngine(EngineConfig(model=tcfg, **{**GEOMETRY, **kw}),
                           params=params, device="cpu")

    async def stream(engine, req, ctx, collect_fn):
        return [t for o in await collect_fn(engine.generate(ctx(req)))
                for t in o.token_ids]

    async def main():
        ref_jax = await stream(jcold, _jax_req(PROMPT, 5), JaxContext, jax_collect)
        await jcold.close()
        cold = torch_engine()
        ref = await stream(cold, _torch_req(PROMPT, 5), Context, collect)
        await cold.close()

        # prefill_chunk=48 is not a bucket boundary: real 33..48-token
        # chunks round up to bucket 64, which the warm set must include
        warm_kw = dict(prefill_chunk=48, decode_window=4, spec_gamma=3)
        warm = torch_engine(**warm_kw)
        windows = []
        orig_pick = warm._pick_window
        warm._pick_window = lambda: windows.append(n := orig_pick()) or n
        sizes = await warm.warmup()
        warm._pick_window = orig_pick
        assert sizes == [16, 32, 64], sizes
        assert warm.stats["prefix_cache_hits_tokens"] == 0, warm.stats
        assert {4, 2, 1} <= set(windows), windows
        assert warm.stats["spec_proposed"] == 0, warm.stats
        assert warm.cfg.spec_gamma == 3  # restored after warmup

        # prefill only: no decode window
        pre = torch_engine(decode_window=4)
        base_steps = pre.stats["decode_steps"]
        assert await pre.warmup(decode=False) == [16, 32]
        assert pre.stats["decode_steps"] == base_steps, pre.stats
        assert pre.stats["decode_windows"] == 0
        assert {e["kind"] for e in pre.compile_ledger} == {"prefill"}
        await pre.close()

        got = await stream(warm, _torch_req(PROMPT, 5), Context, collect)
        assert got == ref == ref_jax, (got, ref, ref_jax)
        ledger = list(warm.compile_ledger)
        metrics = warm.load_metrics()
        await warm.close()

        jwarm = JaxEngine(JaxEngineConfig(model=jcfg, **{**GEOMETRY, **warm_kw}),
                          seed=0)
        assert await jwarm.warmup() == sizes
        jledger = [(e["kind"], tuple(e["key"])) for e in jwarm.compile_ledger]
        jmetrics = jwarm.load_metrics()
        await jwarm.close()
        return ledger, metrics, jledger, jmetrics

    ledger, metrics, jledger, jmetrics = run(main())
    keys = {(e["kind"], tuple(e["key"])) for e in ledger}
    assert keys == set(jledger), (keys, jledger)
    assert ("decode", (1, False, False)) in keys
    for k in ("xla_warm_buckets", "xla_reachable_buckets"):
        assert metrics[k] == jmetrics[k] == 6, (k, metrics[k], jmetrics[k])
    # each window size's three graphs (greedy, sampled, sampled and
    # filtered) were dispatched: one ledger entry each under the
    # reference's key; the request after warmup dispatched nothing new (its
    # 14-token prompt rides bucket 16 and its windows were warmed)
    graphs = {(e["key"][0], tuple(e["graph"])) for e in ledger
              if e["kind"] == "decode"}
    assert graphs == {(n, f) for n in (4, 2, 1) for f in
                      ((False, False), (True, False), (True, True))}, graphs
    assert metrics["xla_compiles_total"] == len(ledger) == 3 + 9
    assert metrics["xla_compile_ms_total"] == pytest.approx(
        sum(e["ms"] for e in ledger), abs=0.01)


# ---------------- the static inputs against direct calls ----------------


def _engine(kv="model", spec_gamma=0):
    cfg = ModelConfig.tiny(dtype="float32")
    return TorchEngine(EngineConfig(model=cfg, kv_cache_dtype=kv, num_blocks=48,
                                    block_size=4, max_batch_size=4,
                                    max_context=64, decode_window=4,
                                    spec_gamma=spec_gamma),
                       seed=3, device="cpu")


def _state(eng):
    t = [eng.k_cache, eng.v_cache]
    t += [x for x in (eng.k_scales, eng.v_scales, eng._pen_counts) if x is not None]
    return t


def _direct_kwargs(eng, penalized):
    """Freshly uploaded host arrays (no static input), host seeds and steps
    (the host-side key hash), no host flags (read from the tensors)."""
    t = torch.as_tensor
    pos = np.maximum(eng._seq_lens - 1, 0)
    args = (t(pos), t(eng._block_tables), t(eng._seq_lens))
    samp = (t(eng._temps), t(eng._top_ks), t(eng._top_ps))
    kw = {}
    if penalized:
        kw = dict(freq_pens=t(eng._freq_pens), pres_pens=t(eng._pres_pens),
                  rep_pens=t(eng._rep_pens))
    return args, samp, kw


def _assert_same(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (what, i)


def _flat(out):
    return [out] if torch.is_tensor(out) else [t for x in out for t in _flat(x)]


@pytest.mark.parametrize("kv", ["model", "int8"], ids=["f32 KV", "int8 KV"])
def test_static_inputs_decode_window_matches_direct_calls(kv):
    """A sequence of decode windows through the engine's static inputs
    against direct ``decode_window`` calls on copies of the same state:
    tokens, logprobs, the int8 cache's requant count, and the caches, scale
    planes and penalty counts after each, bit for bit. Across the
    sequence: the ladder's three sizes; greedy rows, seeded sampled rows
    and top-k / top-p rows; penalties and logprobs on and off; the tables
    changing, a slot freed (a preempted row) and refilled."""
    eng = _engine(kv)
    rng = np.random.RandomState(0)
    fill_caches(eng, torch.Generator().manual_seed(0))
    cases = [
        # (lens, n, sampling, penalties, logprobs, first page)
        ([13, 7, 0, 21], 4, {}, False, False, 1),
        ([14, 8, 0, 22], 2, dict(temps=[0.8, 0.0, 0.0, 1.1], seeds=[5, 0, 9, 77],
                                 top_ks=[0, 0, 0, 3], top_ps=[1.0, 1.0, 1.0, 0.9]),
         False, True, 1),
        ([15, 9, 0, 23], 1, dict(temps=[0.7, 0.0, 0.0, 1.0], seeds=[5, 0, 0, 77]),
         True, True, 1),
        # slot 1 preempted (free, table zero), slot 2 refilled on new pages
        ([16, 0, 11, 24], 4, dict(temps=[0.9, 0.0, 0.6, 0.0], seeds=[5, 0, 31, 0],
                                  top_ks=[2, 0, 0, 0], top_ps=[1.0, 1.0, 0.8, 1.0]),
         True, False, 20),
    ]
    for lens, n, samp, pen, lp, first in cases:
        steps = set_batch(eng, rng, lens, penalties=pen, first_page=first, **samp)
        state = _state(eng)
        copies = [t.clone() for t in state]
        args, samp_t, kw = _direct_kwargs(eng, pen)
        if pen:
            kw.update(counts=copies[-1], prompt_mask=eng._pen_mask.clone())
        if eng.k_scales is not None:
            kw.update(k_scales=copies[2], v_scales=copies[3])
        want = llama.decode_window(
            eng.params, eng.cfg.model, torch.as_tensor(eng._last_tokens), *args,
            eng._seeds.tolist(), steps.tolist(), *samp_t, copies[0], copies[1],
            n_steps=n, with_logprobs=lp, **kw)
        key, gkey, program, holds = eng._decode_program(steps, n, pen, lp)
        assert key == ("decode", n, pen, lp)
        got = eng._run_program(key, gkey, program, holds)
        _assert_same(_flat(got), _flat(want), (lens, n))
        _assert_same(state, copies, ("state", lens, n))
    assert {k for k, *_ in eng._compiled_keys} == {"decode"}
    assert len(eng.compile_ledger) == 4


def test_static_inputs_verify_matches_direct_calls():
    """Verifies (gamma 3) through the static inputs against direct
    ``verify_window`` calls: greedy rows, a seeded sampled row with top-k,
    proposals with -1 gaps, penalties and logprobs, then the tables
    changed with a slot freed."""
    eng = _engine(spec_gamma=3)
    rng = np.random.RandomState(1)
    fill_caches(eng, torch.Generator().manual_seed(1))
    g, V = 3, eng.cfg.model.vocab_size
    cases = [
        ([10, 6, 0, 17], {}, False, False, 1),
        ([11, 7, 0, 18], dict(temps=[0.0, 0.9, 0.0, 1.2], seeds=[0, 4, 0, 123],
                              top_ks=[0, 5, 0, 0]), True, True, 1),
        ([12, 0, 9, 19], dict(temps=[0.5, 0.0, 0.0, 0.0], seeds=[2, 0, 0, 0]),
         True, False, 30),
    ]
    for lens, samp, pen, lp, first in cases:
        steps = set_batch(eng, rng, lens, penalties=pen, first_page=first, **samp)
        proposals = rng.randint(0, V, (4, g)).astype(np.int32)
        proposals[0, 2] = proposals[2, :] = -1
        window = np.concatenate([eng._last_tokens[:, None],
                                 np.maximum(proposals, 0)], 1).astype(np.int32)
        state = _state(eng)
        copies = [t.clone() for t in state]
        args, samp_t, kw = _direct_kwargs(eng, pen)
        if pen:
            kw.update(counts=copies[-1], prompt_mask=eng._pen_mask.clone())
        want = llama.verify_window(
            eng.params, eng.cfg.model, torch.as_tensor(window),
            torch.as_tensor(proposals), *args, eng._seeds.tolist(),
            steps.tolist(), *samp_t, copies[0], copies[1], n_spec=g,
            with_logprobs=lp, **kw)
        key, gkey, program, holds = eng._verify_program(window, proposals, steps,
                                                        pen, lp)
        assert key == ("verify", g, pen, lp)
        got = eng._run_program(key, gkey, program, holds)
        _assert_same(_flat(got), _flat(want), lens)
        _assert_same(state, copies, ("state", lens))


def test_make_keys_on_the_device_equals_host_and_jax():
    """Key data hashed from tensors (what a captured window computes each
    replay) equals the host hash and JAX's ``key_data(fold_in(key(seed),
    step))``, for the decode window's [B, n] steps and the verify's
    ``seed ^ 0x5EC`` accept stream."""
    seeds = np.asarray([0, 1, 7, 12345, 2**31 - 1, 99], np.int64)
    steps = np.asarray([0, 3, 31, 100000, 5, 2**20], np.int64)
    n = 4
    got = sampling.make_keys(torch.as_tensor(seeds)[:, None],
                             torch.as_tensor(steps)[:, None] + torch.arange(n))
    assert got.shape == (6, n, 2)
    for i in range(n):
        host = sampling.make_keys(seeds.tolist(), (steps + i).tolist())
        ref = jsamp.make_keys(jax.numpy.asarray(seeds.astype(np.int32)),
                              jax.numpy.asarray((steps + i).astype(np.int32)))
        assert torch.equal(got[:, i], host)
        np.testing.assert_array_equal(got[:, i].numpy(),
                                      np.asarray(ref).astype(np.int64))
    acc = sampling.make_keys(torch.as_tensor(seeds) ^ 0x5EC, torch.as_tensor(steps))
    assert torch.equal(acc, sampling.make_keys([int(s) ^ 0x5EC for s in seeds],
                                               steps.tolist()))


def test_ledger_without_warmup_records_what_traffic_dispatched(run):
    """Without warmup the ledger fills as traffic reaches each program key
    (warmup only moves those first dispatches ahead of traffic), and the
    coverage gauges stay 0 until a warmup sets them."""
    cfg = ModelConfig.tiny(dtype="float32")

    async def main():
        eng = TorchEngine(EngineConfig(model=cfg, **GEOMETRY), seed=0, device="cpu")
        try:
            await collect(eng.generate(Context(_torch_req(PROMPT, 8))))
            return ({(e["kind"], tuple(e["key"])) for e in eng.compile_ledger},
                    eng.load_metrics())
        finally:
            await eng.close()

    keys, metrics = run(main())
    assert keys == {("prefill", (16, False)), ("decode", (4, False, False)),
                    ("decode", (2, False, False)), ("decode", (1, False, False))}
    assert metrics["xla_compiles_total"] == 4
    assert metrics["xla_warm_buckets"] == metrics["xla_reachable_buckets"] == 0


def test_every_kernel_wrapper_registers_its_launch_counters():
    """The graph runner moves launch counts from a capture to its replays
    for the wrappers registered in ``ops/_cuda.py``: every wrapper of the
    port's ops that counts its launches is registered, with each of its
    counters."""
    import importlib
    import pkgutil

    from dynamo_tpu_torch import ops
    from dynamo_tpu_torch.ops import _cuda

    found = {}
    for m in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"dynamo_tpu_torch.ops.{m.name}")
        for f in vars(mod).values():
            names = tuple(a for a in getattr(f, "__dict__", {})
                          if a.endswith("launches"))
            if callable(f) and names:
                found[f] = set(names)
    registered = {f: set(names) for f, names in _cuda.COUNTED}
    assert len(found) == 13 and found == registered


def test_dynamo_run_warmup_flag(run, capsys):
    """``dynamo_run --warmup`` warms the engine before serving and prints
    the warmed buckets, as the reference's ``maybe_warmup``; without the
    flag nothing is dispatched."""
    from dynamo_tpu_torch.launch import dynamo_run

    argv = ["in=http", "out=torch", "--model-path", "tiny", "--device", "cpu",
            "--max-context", "128", "--num-blocks", "64"]
    for flag in ([], ["--warmup"]):
        args = dynamo_run.parse_args(argv + flag)
        assert args.warmup == bool(flag)
        _worker, core, _name = dynamo_run.build_engine(args)
        run(dynamo_run.maybe_warmup(args, core))
        run(core.close())
        out = capsys.readouterr().out
        if flag:
            # max_context 128: the top bucket is 128 (127-token prompts)
            assert "warmup: compiled prefill buckets [16, 32, 64, 128] " \
                   "+ decode window ladder" in out, out
            assert core.load_metrics()["xla_warm_buckets"] == 7
        else:
            assert out == "" and core.compile_ledger == []
