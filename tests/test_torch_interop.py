"""The interop contracts a torch worker owes the reference's control plane.

A ``TorchEngine`` is to sit behind the JAX package's router and frontend,
which address KV blocks by their chained hashes and scrape each worker's
``load_metrics``. Both are held here to the reference on the CPU: the
block hashes (salted and unsalted) bit for bit, and the ``load_metrics``
keys as a set, including every key ``WorkerLoad.from_stats`` reads.
"""

import inspect
import re

import pytest

from dynamo_tpu import native
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.engine import allocator as jalloc
from dynamo_tpu.kv_router.scheduler import WorkerLoad
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStops
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu.runtime import collect as jax_collect
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine import allocator as talloc
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context, collect

GEOMETRY = dict(num_blocks=64, block_size=4, max_batch_size=4,
                max_context=128, prefill_chunk=32)
#: keys ``WorkerLoad.from_stats`` reads that only the disaggregated worker
#: (``disagg/worker.py``) adds to a scrape: the port does not have it yet
#: (ROADMAP A.8)
DISAGG_KEYS = {"streamed_deliveries", "bulk_deliveries", "kv_stream_segments",
               "ici_handoffs"}
#: with them, the keys only the host/disk KV tiers (``engine/offload.py``'s
#: ``stats()``) add: an engine without tiers emits none of these
TIER_AND_DISAGG_KEYS = DISAGG_KEYS | {
    "offload_blocks_resident", "d2h_flush_async", "h2d_prefetch_hits",
    "restore_latency_hidden_frac", "disk_blocks_resident",
    "disk_hit_blocks_total", "peer_pull_blocks_total", "peer_pull_hidden_frac",
    "disk_corrupt_discards", "disk_demotions_total", "peer_serve_blocks_total",
    "kv_quant_blocks_total", "kv_quant_bytes_saved_total",
}
#: the host and disk tiers with the int8 tier codec (tempdirs of their own)
TIERS = dict(host_cache_blocks=16, disk_cache_blocks=32, kv_quant="int8")


def test_block_hashes_match_the_reference(record_property):
    """Block hashes of a few token sequences (one full block, several, a
    partial last block, and an empty one) at block_size 16, unsalted and
    salted with ``model_hash_salt("some-adapter")``: the port's
    pure-Python walk equals the reference's hasher, whichever path the
    reference takes here (its native C++ batch hasher when built)."""
    salted_native = native.available() and native.salted_available()
    path = "native" if native.available() else "pure-python"
    record_property("reference_hasher",
                    f"{path} (salted: {'native' if salted_native else 'pure-python'})")
    assert talloc.model_hash_salt("some-adapter") == jalloc.model_hash_salt(
        "some-adapter")
    assert talloc.model_hash_salt(None) is None and jalloc.model_hash_salt("") is None
    seqs = [list(range(16)), list(range(100, 150)), [7, 8, 9, 10] * 13 + [3],
            list(range(5)), []]
    for salt in (None, jalloc.model_hash_salt("some-adapter")):
        for toks in seqs:
            got = talloc.sequence_block_hashes(toks, 16, salt=salt)
            ref = jalloc.sequence_block_hashes(toks, 16, salt=salt)
            assert got == ref, (path, salt, len(toks))
            assert len(got) == len(toks) // 16


def _from_stats_keys() -> set[str]:
    """Every key ``WorkerLoad.from_stats`` reads from the scrape."""
    src = inspect.getsource(WorkerLoad.from_stats)
    keys = set(re.findall(r'd\.get\(\s*"([a-z0-9_]+)"', src))
    assert len(keys) > 40  # the reader's whole schema, not a stray match
    return keys


@pytest.mark.parametrize("kv", ["model", "int8", "tiers"],
                         ids=["bf16 KV", "int8 KV", "bf16 KV + host and disk tiers"])
def test_load_metrics_keys_match_the_reference(run, kv):
    """The same tiny bf16 model in both engines, with the same features
    (bf16 KV, the int8-with-scales KV cache, or bf16 KV with the host and
    disk tiers and the int8 tier codec), each after serving one request:
    the keys of ``load_metrics()`` are equal, and every key
    ``WorkerLoad.from_stats`` reads is in the port's, except the keys that
    only the disaggregated worker adds and, without tiers, those only the
    tiers add (absent from the reference's scrape too, so they cannot also
    be in an equal key set)."""
    extra = TIERS if kv == "tiers" else {"kv_cache_dtype": kv}
    jeng = JaxEngine(JaxEngineConfig(model=JaxModelConfig.tiny(), **extra,
                                     **GEOMETRY), seed=0)
    teng = TorchEngine(EngineConfig(model=ModelConfig.tiny(), **extra,
                                    **GEOMETRY), device="cpu")

    async def serve(engine, req, ctx, collect_fn):
        try:
            return await collect_fn(engine.generate(ctx(req)))
        finally:
            await engine.close()

    toks = list(range(10, 30))
    run(serve(jeng, JaxRequest(token_ids=toks, stop_conditions=JaxStops(max_tokens=4),
                               sampling_options=JaxSampling(temperature=0.0)),
              JaxContext, jax_collect))
    run(serve(teng, PreprocessedRequest(
        token_ids=toks, stop_conditions=StopConditions(max_tokens=4),
        sampling_options=SamplingOptions(temperature=0.0)), Context, collect))
    ref, got = jeng.load_metrics(), teng.load_metrics()
    assert set(got) == set(ref), (sorted(set(ref) - set(got)),
                                  sorted(set(got) - set(ref)))
    read = _from_stats_keys()
    missing = DISAGG_KEYS if kv == "tiers" else TIER_AND_DISAGG_KEYS
    assert read - set(got) == missing == read - set(ref)
    # the histograms speak the reference's wire form and saw the request
    for key in ("hist_queue_wait_ms", "hist_prefill_ms"):
        assert set(got[key]) == set(ref[key]) and got[key]["b"] == ref[key]["b"]
        assert got[key]["n"] == ref[key]["n"] == 1
    assert set(got["hist_ttft_ms"]) == set(ref["hist_ttft_ms"]) == {""}
    assert got["requests_total"] == ref["requests_total"] == 1
    assert got["tokens_generated"] == ref["tokens_generated"] == 4
    if kv == "int8":
        assert got["kv_device_requants_total"] > 0 and got["kv_device_quant_pages"] > 0
    load = WorkerLoad.from_stats(1, got)
    assert load.block_size == 4 and load.total_slots == 4 and load.models == ("",)
