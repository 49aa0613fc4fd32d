"""TorchEngine vs JaxEngine on the CPU: same weights, same overlapping
greedy requests, identical token ids — through chunked prefill, fused
mixed steps and merged decode windows."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStops
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu.runtime import collect as jax_collect
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context, collect

# the tests/test_engine.py engine geometry, at f32
GEOMETRY = dict(num_blocks=64, block_size=4, max_batch_size=4,
                max_context=128, prefill_chunk=32)
# overlapping prompts: 70 tokens take three 32-token chunks; the later
# arrivals pack into mixed steps with the decoding ones
PROMPTS = [(list(range(10, 80)), 12), (list(range(100, 145)), 10),
           (list(range(200, 213)), 9), (list(range(300, 340)), 6)]


async def _serve(engine, make_req, make_ctx, collect_fn):
    async def one(i, toks, n):
        await asyncio.sleep(0.002 * i)  # staggered arrivals
        outs = await collect_fn(engine.generate(make_ctx(make_req(toks, n))))
        return [t for o in outs for t in o.token_ids]

    try:
        return await asyncio.gather(
            *[one(i, toks, n) for i, (toks, n) in enumerate(PROMPTS)]
        )
    finally:
        await engine.close()


def test_torch_engine_matches_jax_engine_greedy(run):
    jcfg = JaxModelConfig.tiny(dtype="float32")
    jeng = JaxEngine(JaxEngineConfig(model=jcfg, **GEOMETRY), seed=0)
    tree = jax.tree.map(np.asarray, jeng.params)
    teng = TorchEngine(
        EngineConfig(model=ModelConfig.tiny(dtype="float32"), **GEOMETRY),
        params=from_jax_params(tree, ModelConfig.tiny(dtype="float32")),
        device="cpu",
    )
    ref = run(_serve(
        jeng,
        lambda t, n: JaxRequest(
            token_ids=t, stop_conditions=JaxStops(max_tokens=n),
            sampling_options=JaxSampling(temperature=0.0)),
        JaxContext, jax_collect,
    ))
    got = run(_serve(
        teng,
        lambda t, n: PreprocessedRequest(
            token_ids=t, stop_conditions=StopConditions(max_tokens=n),
            sampling_options=SamplingOptions(temperature=0.0)),
        Context, collect,
    ))
    assert [len(g) for g in got] == [n for _, n in PROMPTS]
    assert got == ref
    # the fused mixed step, the dedicated prefill and multi-step merged
    # decode windows all ran
    assert teng.stats["mixed_steps"] > 0
    assert teng.stats["prefill_chunks"] > 0
    assert teng.stats["decode_steps"] > teng.stats["decode_windows"] > 0
    assert teng.load_metrics()["mixed_prefill_segments"] > 0


def test_torch_engine_requires_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(model=ModelConfig.tiny(dtype="float32"), **GEOMETRY)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(cfg, device="cuda")


def _req(tokens, n, **so):
    return PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0, **so),
    )


def test_torch_engine_preempts_instead_of_truncating(run):
    """A starved pool preempts (evict + recompute) and every request still
    gets exactly the tokens an uncontended run gives (the reference's
    tests/test_engine.py preemption geometry)."""

    def engine(blocks):
        return TorchEngine(
            EngineConfig(model=ModelConfig.tiny(dtype="float32"),
                         **dict(GEOMETRY, num_blocks=blocks)),
            seed=0, device="cpu",
        )

    roomy, starved = engine(64), engine(14)
    prompts = [range(10 + 7 * i, 22 + 7 * i) for i in range(3)]

    async def main():
        want = [[t for o in await collect(roomy.generate(Context(_req(p, 24))))
                 for t in o.token_ids] for p in prompts]
        outs = await asyncio.gather(*[
            collect(starved.generate(Context(_req(p, 24)))) for p in prompts])
        await roomy.close()
        await starved.close()
        return want, [[t for o in out for t in o.token_ids] for out in outs]

    want, got = run(main())
    assert got == want and all(len(g) == 24 for g in got)
    assert starved.stats["preemptions"] > 0


def test_torch_engine_logprobs_penalties_and_cancel(run):
    eng = TorchEngine(
        EngineConfig(model=ModelConfig.tiny(dtype="float32"), **GEOMETRY),
        seed=0, device="cpu",
    )

    async def main():
        lp, pen = await asyncio.gather(
            collect(eng.generate(Context(_req(range(5, 30), 6, logprobs=2)))),
            collect(eng.generate(Context(
                _req(range(40, 52), 8, repetition_penalty=1.5,
                     frequency_penalty=0.5)))),
        )
        ctx = Context(_req(range(60, 70), 50))
        outs = []
        async for o in eng.generate(ctx):
            outs.append(o)
            if len(outs) == 3:
                ctx.context.stop_generating()
        await eng.close()
        return lp, pen, outs

    lp, pen, cancelled = run(main())
    entries = [e for o in lp for e in (o.logprobs or [])]
    assert len(entries) == 6 and all(len(e["top"]) == 2 for e in entries)
    assert all(e["logprob"] <= 0.0 for e in entries)
    assert sum(len(o.token_ids) for o in pen) == 8
    assert cancelled[-1].finish_reason == FinishReason.CANCELLED
    assert sum(len(o.token_ids) for o in cancelled) < 50
