"""``dynamo_run`` for the PyTorch port: ``in=http|text out=torch``.

The single-process subset of ``dynamo_tpu/launch/dynamo_run.py``:

  in=http   OpenAI frontend in this process (/v1/models, /v1/completions,
            /v1/chat/completions, /metrics)
  in=text   interactive prompt loop on stdin
  out=torch the PyTorch engine (TorchEngine), on ``--device`` (cuda)

Examples::

  python -m dynamo_tpu_torch.launch.dynamo_run in=http out=torch \\
      --model-path llama3-8b-sim
  python -m dynamo_tpu_torch.launch.dynamo_run in=http out=torch \\
      --model-path deepseek-v2-lite-sim
  python -m dynamo_tpu_torch.launch.dynamo_run in=http out=torch \\
      --model-path gptoss-20b-sim --warmup
  python -m dynamo_tpu_torch.launch.dynamo_run in=text out=torch \\
      --model-path tiny --device cpu
  python -m dynamo_tpu_torch.launch.dynamo_run in=http out=torch \\
      --model-path llama3-8b-sim --quantization fp8_e4m3 --kv-cache-dtype int8
  python -m dynamo_tpu_torch.launch.dynamo_run in=http out=torch \
      --model-path llama3-8b-sim --spec-gamma 3
  python -m dynamo_tpu_torch.launch.dynamo_run in=http out=torch \
      --model-path /path/to/checkpoint-dir
  python -m dynamo_tpu_torch.launch.dynamo_run in=http out=torch \
      --model-path llama3-8b-sim --tokenizer /path/to/tokenizer-dir
  python -m dynamo_tpu_torch.launch.dynamo_run in=http out=torch \
      --model-path llama3-8b-sim --warmup

``--model-path`` is a preset or a checkpoint: a local directory or an
``org/name`` already in the local HF cache (``llm/hub.py``) holding
``config.json`` (Llama, Mistral, Qwen2, Qwen3, Mixtral, Qwen2-MoE,
Qwen3-MoE, gpt-oss, DeepSeek-V2/V3), ``*.safetensors`` weights (loaded onto the
engine's device; without them the weights are drawn at random, as the
reference serves a config-only directory) and its tokenizer
(``tokenizer.json`` through ``transformers``, else ``tokenizer.model``
through the port's own SentencePiece reader). ``--tokenizer <dir>``
overrides the tokenizer, of a checkpoint or of a preset.

Model presets (random weights from seed 0, byte tokenizer): ``tiny``,
``llama3-8b-sim`` (the full Llama-3-8B architecture),
``deepseek-v2-lite-sim`` (DeepSeek-V2-Lite's published config: 27 layers,
MLA latent cache, 64 routed experts top-6 + 2 shared), ``gptoss-20b-sim``
(gpt-oss-20b's published shapes: 24 layers alternating a 128-token window
and full attention, sinks, 32 experts top-4 with biased clamped SwiGLU,
YaRN rope; context cut to 8192) and ``tiny-gptoss`` (its CPU-sized kin).
Engine flags and defaults match the reference's.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys
import time
from typing import Optional

import torch

from ..device import resolve_device
from ..engine.engine import EngineConfig, TorchEngine
from ..http.service import HttpService, ModelManager
from ..llm.openai_engine import OpenAIWorkerEngine
from ..llm.hub import resolve_model_path
from ..llm.tokenizer import ByteTokenizer, Tokenizer, load_tokenizer
from ..models.config import ModelConfig, deepseek_v2_lite, gemma3_12b
from ..models.quant import KV_CACHE_DTYPES, WEIGHT_MODES, kv_cache_dtype
from ..models.weights import init_random_params, load_llama_params
from ..runtime.engine import Context

PRESETS = {
    "tiny": ModelConfig.tiny,
    "llama3-8b-sim": ModelConfig.llama3_8b,
    "deepseek-v2-lite-sim": deepseek_v2_lite,
    # gpt-oss-20b's published shapes (20.9B params, 41.8 GB in bf16), the
    # context cut from 131072 to 8192 positions (the YaRN rope keeps its
    # published original 4096 and factor 32)
    "gptoss-20b-sim": lambda: ModelConfig.gptoss_20b(
        max_position_embeddings=8192),
    # Gemma-3-12B's published shapes (11.77B params, 23.5 GB in bf16; head
    # width 256, 1024-token windows on 40 of 48 layers, two ropes), the
    # context cut from 131072 to 8192 positions
    "gemma3-12b-sim": gemma3_12b,
    # gpt-oss-shaped smoke model: alternating sliding/full layers,
    # attention sinks, biased clamped-SwiGLU MoE (the JAX package's)
    "tiny-gptoss": lambda: ModelConfig.tiny(
        num_layers=4, layer_windows=(16, 0, 16, 0), attn_sinks=True,
        o_bias=True, attention_bias=True, num_experts=4,
        num_experts_per_tok=2, moe_intermediate_size=32,
        moe_act="gptoss_clamp"),
}


def build_model(args) -> tuple[ModelConfig, Tokenizer, str, Optional[str]]:
    """(model config, tokenizer, served name, checkpoint directory holding
    ``*.safetensors`` or None for random weights). A preset serves random
    weights through the byte tokenizer; anything else is a checkpoint
    (``resolve_model_path``: a local directory or a cached HF snapshot)
    with its own config and tokenizer. ``--tokenizer`` overrides the
    tokenizer."""
    path = args.model_path or "tiny"
    weights = None
    if path in PRESETS:
        cfg, tokenizer, name = PRESETS[path](), ByteTokenizer(), path
    else:
        # the served name is the user's id (org/name or dir), not the
        # snapshot path a cache hit resolves to
        name = os.path.basename(os.path.normpath(path))
        path = resolve_model_path(path)
        cfg = ModelConfig.from_local_path(path)
        tokenizer = load_tokenizer(path)
        if any(f.endswith(".safetensors") for f in os.listdir(path)):
            weights = path
    if args.tokenizer:
        tokenizer = load_tokenizer(args.tokenizer)
    return cfg, tokenizer, args.model_name or name, weights


def engine_config(args, cfg: ModelConfig) -> EngineConfig:
    # an unported KV dtype raises here, before any weights are drawn
    kv_cache_dtype(cfg, args.kv_cache_dtype)
    return EngineConfig(
        model=cfg,
        num_blocks=args.num_blocks,
        block_size=args.block_size,
        max_batch_size=args.max_batch,
        max_context=args.max_context,
        decode_window=args.decode_window,
        mixed_step_budget=args.mixed_step_budget,
        mixed_max_prefills=args.mixed_max_prefills,
        quantization=args.quantization,
        kv_cache_dtype=args.kv_cache_dtype,
        spec_gamma=args.spec_gamma,
        spec_ngram=args.spec_ngram,
    )


def build_engine(args) -> tuple[OpenAIWorkerEngine, TorchEngine, str]:
    """The engine behind the OpenAI surface: the checkpoint's weights
    loaded onto the device (quantized there by ``--quantization``), or
    random ones drawn on it."""
    cfg, tokenizer, name, weights = build_model(args)
    device = resolve_device(args.device)
    ecfg = engine_config(args, cfg)
    if weights is not None:
        params = load_llama_params(weights, cfg, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_random_params(cfg, gen, device)
    core = TorchEngine(ecfg, params=params, device=device)
    return OpenAIWorkerEngine(tokenizer, core), core, name


async def maybe_warmup(args, core: TorchEngine) -> None:
    """--warmup: dispatch the serving programs (kernel builds, the CUDA
    graph captures of the decode windows) before the HTTP port opens, so
    no request pays the first dispatch of a prefill bucket or of a decode
    window."""
    if args.warmup:
        t0 = time.monotonic()
        sizes = await core.warmup()
        print(f"warmup: compiled prefill buckets {sizes} + decode window "
              f"ladder in {time.monotonic() - t0:.1f}s", flush=True)


async def run_http(args) -> None:
    engine, core, name = build_engine(args)
    await maybe_warmup(args, core)
    manager = ModelManager()
    manager.add_chat_model(name, engine)
    manager.add_completion_model(name, engine)
    svc = HttpService(manager, host=args.host, port=args.http_port)
    await svc.start()
    print(f"OpenAI server on http://{args.host}:{svc.port} (models: {[name]})",
          flush=True)
    await svc.run()


async def run_text(args) -> None:
    engine, core, name = build_engine(args)
    await maybe_warmup(args, core)
    print(f"interactive mode — model {name!r}; ctrl-d to exit", flush=True)
    loop = asyncio.get_running_loop()
    while True:
        try:
            prompt = await loop.run_in_executor(None, lambda: input("> "))
        except EOFError:
            return
        req = {"model": name, "prompt": prompt, "max_tokens": args.max_tokens,
               "stream": True}
        async for item in engine.generate(Context(req)):
            for choice in (item.data or {}).get("choices", []):
                print(choice.get("text", ""), end="", flush=True)
        print(flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        "dynamo_run", description="dynamo run on PyTorch: in=<source> out=torch"
    )
    p.add_argument("in_out", nargs="*", help="in=http|text out=torch")
    p.add_argument("--model-path", default=None,
                   help=f"a preset ({' | '.join(PRESETS)}) or a checkpoint "
                        "directory / cached HF repo id")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer directory overriding the model's "
                        "(tokenizer.json or tokenizer.model)")
    p.add_argument("--model-name", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--max-tokens", type=int, default=128)
    p.add_argument("--num-blocks", type=int, default=512)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--spec-gamma", type=int, default=0,
                   help="speculative decoding: proposals per verify (0=off)")
    p.add_argument("--spec-ngram", type=int, default=3,
                   help="speculative decoding: lookup n-gram length")
    p.add_argument("--max-context", type=int, default=0)
    p.add_argument("--decode-window", type=int, default=4,
                   help="fused decode steps per device dispatch")
    p.add_argument("--mixed-step-budget", type=int, default=0,
                   help="prefill tokens per fused mixed step (0 = prefill_chunk)")
    p.add_argument("--mixed-max-prefills", type=int, default=4,
                   help="max concurrent prompts packed into one fused step")
    p.add_argument("--quantization", default="none", choices=list(WEIGHT_MODES),
                   help="weight quantization (per-channel; models/quant.py; "
                        "expert stacks through the ragged_int8_gmm kernel)")
    p.add_argument("--warmup", action="store_true",
                   help="compile every prefill bucket + the decode window "
                        "before serving (first-request TTFT skips the "
                        "per-bucket first dispatch: kernel builds and the "
                        "decode windows' CUDA graph captures)")
    p.add_argument("--kv-cache-dtype", default="model",
                   choices=list(KV_CACHE_DTYPES),
                   help="KV cache storage dtype (int8 = int8-with-scales "
                        "device cache, per-(layer, page) f32 scale planes; "
                        "float8_e4m3 = scale-free fp8 pages, GQA only)")
    args = p.parse_args(argv)
    kv = dict(a.split("=", 1) for a in args.in_out if "=" in a)
    args.in_ = kv.get("in", "http")
    args.out = kv.get("out", "torch")
    if args.out != "torch":
        p.error(f"out={args.out}: this launcher serves out=torch")
    if args.in_ not in ("http", "text"):
        p.error(f"in={args.in_}: this launcher serves in=http and in=text")
    return args


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = parse_args(argv)
    asyncio.run(run_http(args) if args.in_ == "http" else run_text(args))


if __name__ == "__main__":
    main(sys.argv[1:])
