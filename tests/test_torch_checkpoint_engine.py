"""Loaded Qwen checkpoints through the port's paged paths and engine, and
the launcher's checkpoint branch, on the CPU.

Two tiny checkpoints, written by the port's saver from seeded weights
(random q/k/v biases, random per-head q/k norm weights) beside a
``config.json`` of the family, loaded by each package's own loader:

* Qwen2 with G = 7 query heads per KV head (14 over 2);
* Qwen3 (per-head q/k RMS norms).

The port's paged ``prefill`` is held to the JAX package's at 1e-4 (the
tests/test_torch_model.py tolerance), and ``TorchEngine``'s greedy streams
to ``JaxEngine``'s, token for token, through chunked prefill, fused mixed
steps, merged decode windows and (``spec_gamma=3``) the speculative
verify. Then ``dynamo_run``'s ``parse_args`` + ``build_engine`` serve a
saved tiny Qwen3 directory with its SentencePiece tokenizer over HTTP.
"""

import asyncio
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.weights import load_llama_params as jax_load
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStops
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu.runtime import collect as jax_collect
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import load_llama_params, save_llama_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context, collect

DATA = Path(__file__).resolve().parent / "data"
BASE = dict(vocab_size=256, intermediate_size=112, num_hidden_layers=2,
            max_position_embeddings=128, rms_norm_eps=1e-6, rope_theta=10000.0,
            tie_word_embeddings=False, torch_dtype="float32")
CONFIGS = {
    # G = 7: 14 query heads over 2 KV heads
    "qwen2_g7": dict(BASE, architectures=["Qwen2ForCausalLM"], hidden_size=224,
                     num_attention_heads=14, num_key_value_heads=2, head_dim=16),
    "qwen3": dict(BASE, architectures=["Qwen3ForCausalLM"], hidden_size=64,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16),
}


def write_checkpoint(path: Path, hf_config: dict, seed: int = 0) -> ModelConfig:
    """Seeded weights in ``path`` (``config.json`` + ``model.safetensors``):
    the port's random init, with the q/k/v biases drawn N(0, 0.1) and the
    q/k norm weights N(1, 0.3) (zeros and ones would make them vacuous)."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf_config))
    cfg = ModelConfig.from_local_path(str(path))
    gen = torch.Generator().manual_seed(seed)
    params = llama.init_params(cfg, gen, "cpu")
    layers = params["layers"]
    for key, (mean, std) in (("bq", (0.0, 0.1)), ("bk", (0.0, 0.1)),
                             ("bv", (0.0, 0.1)), ("q_norm", (1.0, 0.3)),
                             ("k_norm", (1.0, 0.3))):
        if key in layers:
            layers[key] = torch.randn(layers[key].shape, generator=gen) * std + mean
    save_llama_params(str(path), params, cfg)
    return cfg


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """label -> (port config, port params, JAX config, JAX params), each
    loaded by its own package from one saved checkpoint."""
    out = {}
    for label, hf in CONFIGS.items():
        path = tmp_path_factory.mktemp(label)
        cfg = write_checkpoint(path, hf)
        jcfg = JaxModelConfig.from_local_path(str(path))
        out[label] = (cfg, load_llama_params(str(path), cfg, device="cpu"), jcfg,
                      jax_load(str(path), jcfg))
    g7 = out["qwen2_g7"][0]
    assert g7.attention_bias and g7.num_heads == 7 * g7.num_kv_heads
    assert out["qwen3"][0].qk_norm
    return out


N_BLOCKS, BS = 40, 4


@pytest.mark.parametrize("label", list(CONFIGS))
def test_paged_prefill_matches_jax(label, models):
    cfg, params, jcfg, jparams = models[label]
    rng = np.random.default_rng(0)
    shape = llama.kv_cache_shapes(cfg, N_BLOCKS, BS)[0]
    kc = rng.standard_normal(shape).astype(np.float32) * 0.5
    vc = rng.standard_normal(shape).astype(np.float32) * 0.5
    T, hist, valid = 16, 8, 11
    table = np.asarray(rng.permutation(np.arange(1, N_BLOCKS))[:8], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    jl = jllama.prefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(table),
                        jnp.int32(hist), jnp.int32(valid), jnp.asarray(kc),
                        jnp.asarray(vc), use_pallas=False)[0]
    tl = llama.prefill(params, cfg, torch.from_numpy(tokens),
                       torch.from_numpy(table), hist, valid,
                       torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert int(torch.argmax(tl)) == int(np.argmax(np.asarray(jl)))


GEOMETRY = dict(num_blocks=64, block_size=4, max_batch_size=4, max_context=128,
                prefill_chunk=32)
# overlapping prompts (tests/test_torch_engine.py): a 70-token prompt takes
# three chunks, the later arrivals pack into mixed steps beside it
PROMPTS = [(list(range(10, 80)), 10), (list(range(100, 145)), 8),
           (list(range(200, 213)), 8), ([7, 8, 9, 10] * 6, 12)]


async def _serve(engine, make_req, make_ctx, collect_fn):
    async def one(i, toks, n):
        await asyncio.sleep(0.002 * i)  # staggered arrivals
        outs = await collect_fn(engine.generate(make_ctx(make_req(toks, n))))
        return [t for o in outs for t in o.token_ids]

    try:
        return await asyncio.gather(
            *[one(i, toks, n) for i, (toks, n) in enumerate(PROMPTS)])
    finally:
        await engine.close()


def _propose_reference(engine, streams: dict, gamma: int):
    """Propose each live sequence's continuation in the JAX engine's stream
    (tests/test_torch_spec.py's device): the verify runs on every decode
    dispatch, and accepts a proposal only where its own argmax agrees."""

    def forced():
        prop = np.full((engine.cfg.max_batch_size, gamma), -1, np.int64)
        for i, seq in enumerate(engine._active):
            if seq is not None and not seq.finished:
                ref = streams[tuple(seq.tokens[:seq.prompt_len])]
                nxt = ref[seq.generated: seq.generated + gamma]
                prop[i, : len(nxt)] = nxt
        return prop if (prop >= 0).any() else None

    engine._propose_ngram = forced


@pytest.mark.parametrize("label", list(CONFIGS))
def test_torch_engine_matches_jax_engine(label, models, run):
    cfg, params, jcfg, jparams = models[label]
    ref = run(_serve(
        JaxEngine(JaxEngineConfig(model=jcfg, **GEOMETRY), params=jparams),
        lambda t, n: JaxRequest(token_ids=t, stop_conditions=JaxStops(max_tokens=n),
                                sampling_options=JaxSampling(temperature=0.0),
                                eos_token_ids=[]),
        JaxContext, jax_collect))
    assert [len(r) for r in ref] == [n for _, n in PROMPTS]

    def req(t, n):
        return PreprocessedRequest(
            token_ids=t, stop_conditions=StopConditions(max_tokens=n),
            sampling_options=SamplingOptions(temperature=0.0), eos_token_ids=[])

    for gamma in (0, 3):
        eng = TorchEngine(EngineConfig(model=cfg, spec_gamma=gamma, **GEOMETRY),
                          params=params, device="cpu")
        if gamma:
            _propose_reference(eng, {tuple(p): r for (p, _), r in zip(PROMPTS, ref)},
                               gamma)
        got = run(_serve(eng, req, Context, collect))
        assert got == ref, f"spec_gamma={gamma}"
        st = eng.stats
        assert st["mixed_steps"] > 0 and st["prefill_chunks"] > 0
        if gamma:  # verifies ran and took proposals
            assert st["spec_accepted"] > 0
            assert st["decode_steps"] < sum(n for _, n in PROMPTS)
        else:
            assert st["decode_steps"] > st["decode_windows"] > 0


# ---------------- the launcher's checkpoint branch ----------------


async def _post(port: int, path: str, body: dict):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode()
    writer.write(f"POST {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), payload


def test_dynamo_run_serves_a_qwen3_checkpoint_directory(tmp_path, run):
    """``--model-path <dir>`` with a saved tiny Qwen3 and a SentencePiece
    ``tokenizer.model``: ``build_engine`` loads the weights (bit for bit)
    and the tokenizer, and the HTTP service answers one completion."""
    from dynamo_tpu_torch.http import HttpService, ModelManager
    from dynamo_tpu_torch.launch import dynamo_run
    from dynamo_tpu_torch.llm.tokenizer import SPTokenizer

    ckpt = tmp_path / "tiny-qwen3"
    cfg = write_checkpoint(ckpt, dict(CONFIGS["qwen3"], vocab_size=305))
    for f in ("tokenizer.model", "tokenizer_config.json"):
        shutil.copy(DATA / "tiny_sp" / f, ckpt / f)
    args = dynamo_run.parse_args(
        ["in=http", "out=torch", "--model-path", str(ckpt), "--device", "cpu",
         "--num-blocks", "64", "--max-context", "128"])
    _cfg, tok, _name, weights = dynamo_run.build_model(args)
    assert isinstance(tok, SPTokenizer) and weights == str(ckpt)
    worker, core, name = dynamo_run.build_engine(args)
    assert name == "tiny-qwen3" and core.cfg.model.qk_norm
    saved = load_llama_params(str(ckpt), cfg, device="cpu")
    for k, v in saved["layers"].items():
        assert torch.equal(core.params["layers"][k], v), k
    manager = ModelManager()
    manager.add_completion_model(name, worker)
    svc = HttpService(manager, host="127.0.0.1", port=0)

    async def main():
        await svc.start()
        try:
            return await _post(svc.port, "/v1/completions", {
                "model": name, "prompt": "hello world", "max_tokens": 5,
                "temperature": 0.0, "nvext": {"ignore_eos": True}})
        finally:
            await svc.close()
            await core.close()

    status, body = run(main())
    assert status == 200
    out = json.loads(body)
    assert out["usage"]["completion_tokens"] == 5
    # the SentencePiece ids, BOS first
    assert out["usage"]["prompt_tokens"] == len(tok.encode("hello world", True))
    assert out["choices"][0]["text"]


def test_resolve_model_path_matches_the_reference(tmp_path, monkeypatch):
    """A local directory as is; an ``org/name`` id to its cached snapshot
    (the one ``refs/main`` pins); a cached snapshot without weights and an
    unknown id refuse offline, as the reference does."""
    from dynamo_tpu.llm.hub import resolve_model_path as jax_resolve
    from dynamo_tpu_torch.llm.hub import resolve_model_path

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    cache = tmp_path / "hub"
    repo = cache / "models--org--tiny"
    for snap in ("old", "pinned"):
        (repo / "snapshots" / snap).mkdir(parents=True)
        (repo / "snapshots" / snap / "model.safetensors").write_bytes(b"")
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("pinned")
    (cache / "models--org--empty" / "snapshots" / "s").mkdir(parents=True)
    for fn in (resolve_model_path, jax_resolve):
        assert fn(str(tmp_path)) == str(tmp_path)
        assert fn("org/tiny", str(cache)) == str(repo / "snapshots" / "pinned")
        for missing in ("org/empty", "org/absent", "not-a-dir"):
            with pytest.raises(FileNotFoundError):
                fn(missing, str(cache))
