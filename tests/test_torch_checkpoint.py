"""The port's checkpoint path against HuggingFace and the JAX package.

Each case builds a tiny random HF model (the families of
tests/test_hf_parity.py), saves it in ``tmp_path`` and holds the port to it:

(a) the port's loader + ``dense_forward`` against HF logits at the JAX
    package's own tolerance (atol 2e-4, rtol 2e-3), and every loaded leaf
    bit-equal (f32) to the JAX package's ``load_llama_params``;
(c) format round trips: a sharded checkpoint with its index, the port's
    saver read back by ``safetensors`` and by the JAX package's loader, the
    JAX package's saver read by the port; a gpt-oss checkpoint (fused
    interleaved experts, sinks, biases) served through ``dynamo_run``
    against HF's logits;
(d) C.9: a window at least ``max_context`` long serves as full attention
    (Qwen2.5's published ``sliding_window: 131072``); shorter and per-layer
    windows serve too, since the attention kernels take window floors.

(b), the paged paths and the engines on loaded Qwen checkpoints, is
tests/test_torch_checkpoint_engine.py (no ``transformers`` import there:
each file stays under a minute alone).
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch
import transformers

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.weights import load_llama_params as jax_load
from dynamo_tpu.models.weights import save_llama_params as jax_save
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import QWEN25_7B_HF, ModelConfig
from dynamo_tpu_torch.models.weights import (
    SafetensorsFile,
    load_llama_params,
    save_llama_params,
)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=112,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, torch_dtype="float32")
TOKENS = [3, 17, 92, 45, 200, 7, 7, 133]
HF_TOL = dict(atol=2e-4, rtol=2e-3)  # tests/test_hf_parity.py's


def _randomize(model, match, mean, std):
    """Draw the parameters whose name matches (zero-initialised biases,
    unit norms would make the check vacuous)."""
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if match(name):
                p.copy_(torch.randn(p.shape, generator=gen) * std + mean)
    return model


def _qwen2(**kw):
    m = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**{**TINY, **kw}))
    return _randomize(m, lambda n: n.endswith("bias"), 0.0, 0.1)


def _qwen3(**kw):
    m = transformers.Qwen3ForCausalLM(
        transformers.Qwen3Config(**{**TINY, "head_dim": 16, **kw}))
    return _randomize(m, lambda n: "q_norm" in n or "k_norm" in n, 1.0, 0.3)


def _deepseek_v2():
    from transformers.models.deepseek_v2 import DeepseekV2Config, DeepseekV2ForCausalLM

    return DeepseekV2ForCausalLM(DeepseekV2Config(
        vocab_size=256, hidden_size=64, intermediate_size=112,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=128, torch_dtype="float32",
        q_lora_rank=24, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=4,
        num_experts_per_tok=2, moe_intermediate_size=48, n_shared_experts=1,
        first_k_dense_replace=1, moe_layer_freq=1, routed_scaling_factor=1.0,
        scoring_func="softmax", norm_topk_prob=False, topk_method="greedy",
        n_group=1, topk_group=1, rope_theta=10000.0))


# the main path's families and their MoE, MLA and Phi-3 kin, each a
# tiny random HF model
FAMILIES = {
    "llama": lambda: transformers.LlamaForCausalLM(
        transformers.LlamaConfig(**TINY, rope_theta=10000.0)),
    "tied_embeddings": lambda: transformers.LlamaForCausalLM(
        transformers.LlamaConfig(**{**TINY, "tie_word_embeddings": True})),
    "llama31_rope": lambda: transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **TINY, rope_theta=500000.0, rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 64})),
    "qwen2": _qwen2,
    "qwen3": _qwen3,
    "mistral": lambda: transformers.MistralForCausalLM(
        transformers.MistralConfig(**TINY, sliding_window=None)),
    "mixtral": lambda: transformers.MixtralForCausalLM(transformers.MixtralConfig(
        **TINY, num_local_experts=4, num_experts_per_tok=2)),
    "qwen2_moe": lambda: _randomize(transformers.Qwen2MoeForCausalLM(
        transformers.Qwen2MoeConfig(
            **TINY, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
            shared_expert_intermediate_size=96)), lambda n: n.endswith("bias"),
        0.0, 0.1),
    "qwen3_moe": lambda: _randomize(transformers.Qwen3MoeForCausalLM(
        transformers.Qwen3MoeConfig(
            **TINY, head_dim=16, num_experts=4, num_experts_per_tok=2,
            moe_intermediate_size=48, norm_topk_prob=True)),
        lambda n: "q_norm" in n or "k_norm" in n, 1.0, 0.3),
    "deepseek_v2_mla": _deepseek_v2,
    # fused qkv_proj / gate_up_proj, split at load
    "phi3": lambda: transformers.Phi3ForCausalLM(
        transformers.Phi3Config(**TINY, pad_token_id=0)),
}


def _save(path, model, **save_kw):
    """save_pretrained into ``path`` with the dtype stated in config.json
    (the JAX package's tests do the same)."""
    model.eval().save_pretrained(path, safe_serialization=True, **save_kw)
    cfg_path = path / "config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["torch_dtype"] = "float32"
    cfg_path.write_text(json.dumps(cfg))
    return str(path)


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a parameter tree (JAX or port)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.float() if torch.is_tensor(v) else v,
                                         np.float32)
    return out


def _assert_same_leaves(params, jparams):
    got, ref = _flat(params), _flat(jax.tree.map(np.asarray, jparams))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------- (a) HF logits, the reference loader's leaves ----------------


def _build(family: str):
    """The family's tiny HF model, its weights drawn from seed 0."""
    torch.manual_seed(0)
    return FAMILIES[family]()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loader_and_dense_forward_match_hf_and_jax_loader(family, tmp_path):
    model = _build(family)
    path = _save(tmp_path, model)
    cfg = ModelConfig.from_local_path(path)
    assert cfg.dtype == "float32"
    params = load_llama_params(path, cfg, device="cpu")
    ours = llama.dense_forward(params, cfg, torch.tensor(TOKENS))
    with torch.no_grad():
        theirs = model(torch.tensor(TOKENS)[None]).logits[0]
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), **HF_TOL)
    _assert_same_leaves(params, jax_load(path, JaxModelConfig.from_local_path(path)))
    if family == "qwen2":
        assert cfg.attention_bias and float(params["layers"]["bq"].abs().max()) > 0
    if family == "qwen3":
        assert cfg.qk_norm and not cfg.attention_bias


# ---------------- (c) the format's round trips ----------------


def test_sharded_checkpoint_with_index(tmp_path):
    path = _save(tmp_path, _build("qwen2"), max_shard_size="40KB")
    assert (tmp_path / "model.safetensors.index.json").exists()
    assert len(list(tmp_path.glob("*.safetensors"))) > 2
    cfg = ModelConfig.from_local_path(path)
    params = load_llama_params(path, cfg, device="cpu")
    _assert_same_leaves(params, jax_load(path, JaxModelConfig.from_local_path(path)))


@pytest.mark.parametrize("family", ["qwen2", "qwen3", "qwen2_moe"])
def test_savers_round_trip(family, tmp_path):
    """The port's saver read back by ``safetensors`` (every tensor the JAX
    package's saver writes, bit for bit; plus Qwen2's biases, which it
    leaves out) and by both loaders; the JAX package's saver read by the
    port (biases apart)."""
    from safetensors.numpy import load_file

    src = _save(tmp_path / "hf", _build(family))
    cfg = ModelConfig.from_local_path(src)
    jcfg = JaxModelConfig.from_local_path(src)
    params = load_llama_params(src, cfg, device="cpu")
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    for d in (ours, theirs):
        d.mkdir()
        shutil.copy(tmp_path / "hf" / "config.json", d / "config.json")
    save_llama_params(str(ours), params, cfg)
    jax_save(str(theirs), jax_load(src, jcfg), jcfg)
    got = load_file(str(ours / "model.safetensors"))
    ref = load_file(str(theirs / "model.safetensors"))
    assert set(got) - set(ref) == ({k for k in got if k.endswith("_proj.bias")}
                                   if cfg.attention_bias else set())
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    _assert_same_leaves(load_llama_params(str(ours), cfg, device="cpu"),
                        jax_load(src, jcfg))
    _assert_same_leaves(load_llama_params(str(ours), cfg, device="cpu"),
                        jax_load(str(ours), jcfg))
    if not cfg.attention_bias:
        _assert_same_leaves(load_llama_params(str(theirs), cfg, device="cpu"),
                            jax_load(src, jcfg))


def test_safetensors_reader_dtypes(tmp_path):
    """bf16, f16, int8, uint8 and fp8 e4m3 tensors written by the port read
    back bit for bit, by the port and (where numpy has the type) by
    ``safetensors``; the header parses as the reference library's."""
    from safetensors import safe_open

    from dynamo_tpu_torch.models.weights import write_safetensors

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=gen)
    tensors = {"f32": x, "bf16": x.to(torch.bfloat16), "f16": x.half(),
               "i8": (x * 40).to(torch.int8), "u8": (x.abs() * 40).to(torch.uint8),
               "f8": x.to(torch.float8_e4m3fn), "empty": torch.zeros(0, 4)}
    write_safetensors(str(tmp_path / "t.safetensors"), tensors)
    st = SafetensorsFile(str(tmp_path / "t.safetensors"))
    for k, t in tensors.items():
        got = st.get(k)
        assert got.dtype == t.dtype and got.shape == t.shape, k
        assert torch.equal(got.view(torch.uint8) if t.numel() else got,
                           t.view(torch.uint8) if t.numel() else t), k
    with safe_open(str(tmp_path / "t.safetensors"), framework="pt") as f:
        assert sorted(f.keys()) == sorted(tensors)
        for k, t in tensors.items():
            assert torch.equal(f.get_tensor(k).view(torch.uint8) if t.numel()
                               else f.get_tensor(k), t.view(torch.uint8)
                               if t.numel() else t), k


# ---------------- gpt-oss checkpoints through dynamo_run ----------------


def test_gptoss_checkpoint_through_dynamo_run_matches_hf(tmp_path):
    """A tiny random transformers GptOss model (alternating sliding/full
    layers, sinks, biased router, fused interleaved clamped-SwiGLU experts
    with biases, biased attention projections, YaRN with truncate=False;
    tests/test_hf_parity.py's case), saved locally and served through
    dynamo_run's checkpoint path: the loaded engine's dense forward and its
    paged prefill give HF's logits (atol 5e-4, rtol 2e-3: the JAX
    package's tolerance for this family)."""
    from pathlib import Path

    if not hasattr(transformers, "GptOssConfig"):
        pytest.skip("transformers has no GptOssConfig")
    from dynamo_tpu_torch.launch import dynamo_run

    hf_cfg = transformers.GptOssConfig(
        vocab_size=305, hidden_size=64, intermediate_size=48,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=8, max_position_embeddings=128,
        layer_types=["sliding_attention", "full_attention"] * 2,
        rope_scaling={"rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0,
                      "beta_slow": 1.0, "truncate": False,
                      "original_max_position_embeddings": 32},
        torch_dtype="float32")
    torch.manual_seed(0)
    model = transformers.GptOssForCausalLM(hf_cfg).eval()
    with torch.no_grad():  # empty-initialised sinks and biases, drawn
        for name, p in model.named_parameters():
            if "sinks" in name or "bias" in name:
                p.normal_(0.0, 0.5)
    ckpt = tmp_path / "tiny-gptoss-ckpt"
    model.save_pretrained(ckpt, safe_serialization=True)
    # the declared dtype, as the loader reads it (newer transformers write
    # "dtype", older ones may omit it)
    meta = json.loads((ckpt / "config.json").read_text())
    (ckpt / "config.json").write_text(json.dumps({**meta,
                                                  "torch_dtype": "float32"}))
    data = Path(__file__).parent / "data" / "tiny_sp"
    for f in ("tokenizer.model", "tokenizer_config.json"):
        shutil.copy(data / f, ckpt / f)
    args = dynamo_run.parse_args(
        ["in=http", "out=torch", "--model-path", str(ckpt), "--device", "cpu",
         "--num-blocks", "32", "--max-context", "64"])
    _worker, core, name = dynamo_run.build_engine(args)
    cfg = core.cfg.model
    assert name == "tiny-gptoss-ckpt" and cfg.dtype == "float32"
    assert cfg.layer_windows == (8, 0, 8, 0) and cfg.attn_sinks and cfg.o_bias
    # every leaf as the JAX package's loader reads it
    jtree = jax_load(str(ckpt), JaxModelConfig.from_local_path(str(ckpt)))
    assert set(jtree["layers"]) == set(core.params["layers"])
    for k, v in jtree["layers"].items():
        np.testing.assert_array_equal(core.params["layers"][k].numpy(),
                                      np.asarray(v, np.float32), err_msg=k)
    toks = [(7 * i + 3) % 305 for i in range(24)]  # past the window
    with torch.no_grad():
        want = model(torch.tensor(toks)[None]).logits[0].numpy()
    tol = dict(atol=5e-4, rtol=2e-3)
    np.testing.assert_allclose(
        llama.dense_forward(core.params, cfg, torch.tensor(toks)).numpy(), want,
        **tol)
    kc, vc = llama.init_kv_cache(cfg, 16, 4)
    logits = llama.prefill(core.params, cfg, torch.tensor(toks),
                           torch.arange(1, 7, dtype=torch.int32), 0, 24,
                           kc, vc)[0]
    np.testing.assert_allclose(logits.numpy(), want[-1], **tol)


# ---------------- (d) C.9: a window that masks nothing ----------------

def test_c9_window_as_long_as_the_context_serves_as_full_attention():
    """Qwen2.5-7B-Instruct's published config.json (``sliding_window:
    131072, use_sliding_window: false``) passes the engine's gate at its
    default max_context (its 32768 positions); a window shorter than
    max_context and per-layer windows pass it too (the kernels take window
    floors); OLMo-2's full-width q/k norm still raises."""
    cfg = ModelConfig.from_hf_config(QWEN25_7B_HF)
    jcfg = JaxModelConfig.from_hf_config(QWEN25_7B_HF)
    # the port parses as the reference does, field for field
    assert vars(cfg) == vars(jcfg)
    assert cfg.sliding_window == 131072 and cfg.attention_bias
    assert cfg.num_heads // cfg.num_kv_heads == 7
    assert EngineConfig(model=cfg).max_context == 32768
    llama.check_supported(cfg)
    # the engine's gate: a window at, and now also below, max_context
    small = ModelConfig.tiny(dtype="float32", sliding_window=64,
                             max_position_embeddings=64)
    for ctx in (64, 65):
        TorchEngine(EngineConfig(model=small, num_blocks=16, block_size=4,
                                 max_context=ctx), device="cpu")
    llama.check_supported(ModelConfig.tiny(layer_windows=(64, 0)))
    with pytest.raises(NotImplementedError, match="full-width qk norm"):
        llama.check_supported(ModelConfig.tiny(qk_norm=True, qk_norm_full=True))


def test_c9_tiny_window_at_max_context_gives_the_reference_logits():
    """sliding_window = max_context = 64 on a tiny Qwen2-shaped model: the
    port's unwindowed prefill over a 60-token history equals the
    reference's windowed one."""
    import jax.numpy as jnp

    kw = dict(dtype="float32", sliding_window=64, max_position_embeddings=64,
              attention_bias=True)
    jcfg, cfg = JaxModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    # non-zero biases (init leaves them at 0)
    rng = np.random.default_rng(1)
    jparams["layers"] = {**jparams["layers"], **{
        k: jnp.asarray(rng.normal(0, 0.1, jparams["layers"][k].shape), jnp.float32)
        for k in ("bq", "bk", "bv")}}
    from dynamo_tpu_torch.models.weights import from_jax_params

    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    shape = llama.kv_cache_shapes(cfg, 20, 4)[0]
    table = np.arange(1, 17, dtype=np.int32)
    tokens = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    kc, vc = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    jk, jv, tk, tv = (jnp.asarray(kc), jnp.asarray(vc), torch.from_numpy(kc),
                      torch.from_numpy(vc))
    for hist, chunk in ((0, 32), (32, 28)):
        tok = np.zeros(32, np.int32)
        tok[:chunk] = tokens[hist:hist + chunk]
        jl, jk, jv = jllama.prefill(jparams, jcfg, jnp.asarray(tok),
                                    jnp.asarray(table), jnp.int32(hist),
                                    jnp.int32(chunk), jk, jv, use_pallas=False)
        tl, tk, tv = llama.prefill(params, cfg, torch.from_numpy(tok),
                                   torch.from_numpy(table), hist, chunk, tk, tv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    dense = llama.dense_forward(params, cfg, torch.from_numpy(tokens[:60]))
    np.testing.assert_allclose(dense[-1].numpy(), tl.numpy(), rtol=1e-4, atol=1e-4)
