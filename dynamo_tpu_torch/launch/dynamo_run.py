"""``dynamo_run`` for the PyTorch port: ``in=<source> out=<engine>``.

The subset of ``dynamo_tpu/launch/dynamo_run.py`` the port serves:

  hub       the control plane (store + bus over TCP, ``--hub-port``)
  in=http   OpenAI frontend in this process (/v1/models, /v1/completions,
            /v1/chat/completions, /metrics)
  in=text   interactive prompt loop on stdin
  in=dyn://ns.comp.ep   serve the engine as a distributed endpoint
            (worker), registered with the hub at ``--hub``; with
            ``--disagg decode`` prompts of more than ``--max-local-prefill``
            uncached tokens prefill on a prefill worker, whose KV lands here
            over the transfer plane; with a host tier the worker also pulls
            router-hinted prefixes from peers and serves theirs
  in=prefill  prefill worker: consumes the namespace's (``--namespace``)
            prefill queue, computes each prompt's KV and first token and
            pushes them to the decode worker that asked; its stats answer at
            ``dyn://<namespace>.prefill.status``
  out=torch the PyTorch engine (TorchEngine), on ``--device`` (cuda)
  out=dyn://ns.comp.ep  route to the workers discovered at ``--hub``
            (frontend): ``--router kv`` tokenizes here and sends each
            request to the worker holding most of its prefix, and resumes
            a stream cut by a worker's death or drain on another worker as
            prompt + tokens so far (``--no-migration`` turns that off;
            ``--max-migrations``, ``--migration-deadline``); otherwise the
            workers' registered models are served round robin or at random
            (``--router round_robin|random``). The frontend holds no model
            and touches no device.

SIGTERM on a worker role (``in=dyn://…``) is a graceful drain: the worker
leaves discovery, lets its in-flight streams finish within
``--drain-deadline`` seconds, hands the rest off to the frontend's
migration, and revokes its lease last, then exits 0. On the prefill role it
stops consuming the queue (an item in flight redelivers to another prefill
worker after the queue's visibility timeout) and exits 0. SIGINT, and
SIGTERM on the hub and the frontend, stop the process at once.

Examples::

  python -m dynamo_tpu_torch.launch.dynamo_run hub --hub-port 18500
  python -m dynamo_tpu_torch.launch.dynamo_run in=dyn://dynamo.backend.generate \
      out=torch --hub 127.0.0.1:18500 --model-path llama3-8b-sim --warmup
  CUDA_VISIBLE_DEVICES= python -m dynamo_tpu_torch.launch.dynamo_run in=http \
      out=dyn://dynamo.backend.generate --hub 127.0.0.1:18500 --router kv \
      --model-path llama3-8b-sim

  # disaggregated: a prefill worker and a decode worker behind the frontend
  python -m dynamo_tpu_torch.launch.dynamo_run in=prefill out=torch \
      --hub 127.0.0.1:18500 --model-path llama3-8b-sim --warmup
  python -m dynamo_tpu_torch.launch.dynamo_run in=dyn://dynamo.backend.generate \
      out=torch --hub 127.0.0.1:18500 --model-path llama3-8b-sim --warmup \
      --disagg decode --max-local-prefill 512

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
from ..disagg import (
    ConditionalDisaggRouter,
    DisaggConfig,
    DisaggEngine,
    KvTransferServer,
    PrefillQueue,
    PrefillWorker,
)
from ..engine.engine import EngineConfig, TorchEngine
from ..http.discovery import ModelEntry, ModelWatcher, register_model
from ..http.service import HttpService, ModelManager
from ..kv_router import (
    KvEventPublisher,
    KvPeerServer,
    KvPrefetchListener,
    KvRoutedEngine,
    KvRouter,
)
from ..llm.backend import Backend
from ..llm.hub import resolve_model_path
from ..llm.model_card import MdcRefresher, ModelDeploymentCard
from ..llm.openai_engine import OpenAIWorkerEngine
from ..llm.preprocessor import OpenAIPreprocessor
from ..llm.tokenizer import ByteTokenizer, Tokenizer, load_tokenizer
from ..models.config import ModelConfig, deepseek_v2_lite, gemma3_12b
from ..models.quant import KV_CACHE_DTYPES, WEIGHT_MODES, kv_cache_dtype
from ..models.weights import init_random_params, load_llama_params
from ..ops._cuda import launch_counts
from ..resilience import DrainCoordinator, MigratingEngine, MigrationPolicy
from ..runtime import DistributedRuntime, Worker, link
from ..runtime.engine import AsyncEngine, Context
from ..runtime.hub import HubServer
from ..runtime.loopwatch import LoopStallMonitor

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
        host_cache_blocks=args.host_cache_blocks,
        disk_cache_blocks=args.disk_blocks,
        disk_cache_path=args.disk_path,
        kv_tier_ttl_s=args.kv_tier_ttl_s,
        kv_quant=args.kv_quant,
        kv_cost_model=args.kv_cost_model,
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


async def maybe_warmup(args, core: TorchEngine, decode: bool = True) -> None:
    """--warmup: dispatch the serving programs (kernel builds, the CUDA
    graph captures of the decode windows) before the HTTP port opens, so
    no request pays the first dispatch of a prefill bucket or of a decode
    window. A prefill worker (``decode=False``) warms the prefill buckets
    only."""
    if args.warmup:
        t0 = time.monotonic()
        sizes = await core.warmup(decode=decode)
        ladder = " + decode window ladder" if decode else ""
        print(f"warmup: compiled prefill buckets {sizes}{ladder} in "
              f"{time.monotonic() - t0:.1f}s", flush=True)


async def connect_runtime(args) -> DistributedRuntime:
    """The process's runtime: over the TCP hub at ``--hub``, else the
    layered config's (``DYN_RUNTIME_HUB_URL``, or an in-process store and
    bus). The runtime owns its hub connection and closes it on shutdown."""
    return await DistributedRuntime.from_settings(hub_url=args.hub)


def dyn_target(address: str) -> tuple[str, str, str]:
    """``dyn://ns.comp.ep`` -> (namespace, component, endpoint)."""
    ns, comp, ep = address.removeprefix("dyn://").split(".")
    return ns, comp, ep


async def run_http(args) -> None:
    manager = ModelManager()
    sources = []  # metric sources beside the service's own
    if args.out.startswith("dyn://"):
        ns, comp_name, ep = dyn_target(args.out)
        drt = await connect_runtime(args)
        if args.router == "kv":
            # KV-aware frontend: tokenize here (for prefix hashing) and
            # route each request to the worker with the best cache overlap;
            # the model's config and tokenizer only, no weights, no device
            _cfg, tokenizer, name, _weights = build_model(args)
            comp = drt.namespace(ns).component(comp_name)
            client = await comp.endpoint(ep).client().start()
            # the reference's scheduler defaults: cost-aware routing with
            # the overlap score as its cold-start fallback, tail-aware on
            router = await KvRouter(
                drt, comp, block_size=args.block_size, model_name=name,
            ).start()
            dispatch = KvRoutedEngine(router, client)
            if not args.no_migration:
                # in-flight migration: a stream cut by a worker's death or
                # drain re-dispatches as prompt + tokens so far through the
                # same router; its counters join /metrics
                dispatch = MigratingEngine(
                    dispatch,
                    MigrationPolicy(max_migrations=args.max_migrations,
                                    deadline_s=args.migration_deadline),
                    client=client,
                )
                sources.append(lambda s=dispatch.stats: dict(s))
            engine = link(OpenAIPreprocessor(tokenizer), Backend(tokenizer),
                          dispatch)
            manager.add_chat_model(name, engine)
            manager.add_completion_model(name, engine)
        else:
            await ModelWatcher(drt, manager, policy=args.router).start()
    else:
        engine, core, name = build_engine(args)
        await maybe_warmup(args, core)
        manager.add_chat_model(name, engine)
        manager.add_completion_model(name, engine)
    svc = HttpService(manager, host=args.host, port=args.http_port)
    for source in sources:
        svc.metrics.register_source(source)
    await svc.start()
    print(f"OpenAI server on http://{args.host}:{svc.port} "
          f"(models: {manager.model_names() or 'discovered dynamically'})",
          flush=True)
    await svc.run()


def run_endpoint(args) -> None:
    """Worker: serve the engine at ``in=dyn://ns.comp.ep``, under
    ``runtime.Worker``. The engine is built and warmed BEFORE the runtime
    takes its lease, so keepalives are never starved by weight loading or
    kernel builds. SIGTERM drains (:func:`serve_endpoint`); SIGINT or a lost
    lease cancel serving, which then has
    ``WorkerConfig.graceful_shutdown_timeout`` (30 s;
    ``DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT``) to unregister and close the
    engine before the lease is revoked (discovery drops the worker at once)
    and the process exits 0; an overrun exits 911."""
    built = []

    async def runtime() -> DistributedRuntime:
        built.extend(build_engine(args))
        await maybe_warmup(args, built[1])
        return await connect_runtime(args)

    Worker(runtime).execute(lambda drt: serve_endpoint(args, drt, *built))


async def serve_endpoint(args, drt: DistributedRuntime, engine, core: TorchEngine,
                         name: str) -> None:
    """The worker's main: its allocator publishes KV events, its stats
    endpoint answers with ``load_metrics() | stats``, the loop monitor's
    counters and the kernel wrappers' launch counts (``kernel_launches``),
    and its model and card are published; it serves until cancelled or
    drained. ``--disagg decode`` puts a ``DisaggEngine`` in front of the
    engine (its counters and ``handoffs`` records join the stats); a host
    tier starts the prefetch-hint listener (which pulls from peers) and the
    peer server. SIGTERM runs a ``DrainCoordinator``: leave discovery, stop
    the card refresher and the listeners, drain the engine with handoff
    within ``--drain-deadline``, flush the response plane, revoke the lease
    last."""
    target = args.in_.removeprefix("dyn://")
    ns, comp, ep = dyn_target(target)
    component = drt.namespace(ns).component(comp)
    # with KV tiers, demotions keep their radix residency and last-tier
    # drops publish the real removals
    KvEventPublisher(drt, component, drt.primary_lease_id).attach(
        core.allocator, offload=core.offload)
    stalls = LoopStallMonitor().start()
    closers = []  # after serving ends
    aux = []  # auxiliary consumers, stopped first by a drain
    transfer = disagg = None
    if args.disagg == "decode":
        transfer = KvTransferServer(host=args.host, advertise_host=args.advertise_host)
        await transfer.start()
        closers.append(transfer.close)
        router = ConditionalDisaggRouter(
            drt, ns, name,
            DisaggConfig(max_local_prefill_length=args.max_local_prefill))
        await router.start()
        closers.append(router.stop)
        # the queue is named by the endpoint's namespace: prefill workers
        # run with --namespace <the same>
        queue = PrefillQueue(drt.bus, ns)
        disagg = DisaggEngine(core, router, queue, transfer,
                              engine_id=drt.primary_lease_id,
                              kv_stream=args.kv_stream)
        engine = OpenAIWorkerEngine(engine.tokenizer, disagg)
    if core.offload is not None:
        # the router-hinted prefetch (pulling from the hinted peer first)
        # and the serve side of peers' pulls; the decode role shares its
        # transfer server for the connect-back
        listener = await KvPrefetchListener(
            drt, component, drt.primary_lease_id, core, transfer=transfer).start()
        peers = await KvPeerServer(drt, component, drt.primary_lease_id, core).start()
        aux += [listener.close, peers.close]

    def stats() -> dict:
        out = core.load_metrics() | core.stats | stalls.counters()
        if disagg is not None:
            out |= disagg.stats | {"handoffs": list(disagg.handoffs)}
        return out | {"kernel_launches": launch_counts()}

    handle = await component.endpoint(ep).serve(engine, stats_handler=stats)
    await register_model(
        drt, ModelEntry(name=name, namespace=ns, component=comp, endpoint=ep,
                        model_type="both"),
    )
    card = ModelDeploymentCard(
        display_name=name, service_name=name, model_path=args.model_path or "",
        context_length=core.cfg.model.max_position_embeddings,
        kv_block_size=args.block_size,
    )
    await card.publish(drt.bus)
    refresher = MdcRefresher(drt.bus, card)
    refresher.start()
    aux.insert(0, refresher.stop)
    drain = DrainCoordinator(drt, engines=[core], handles=[handle], closers=aux,
                             deadline_s=args.drain_deadline)
    print(f"worker {drt.worker_id:x} serving {name!r} at dyn://{target}",
          flush=True)
    try:
        await _serve_until_stopped(drain, handle, aux)
    finally:
        stalls.stop()
        for close in closers:
            await close()
        await core.close()
        print(f"worker {drt.worker_id:x} stopped", flush=True)


async def _serve_until_stopped(drain: DrainCoordinator, handle, aux) -> None:
    """Serve until SIGTERM's drain ends (``drain`` deregisters, runs
    ``aux``, drains its engines, stops ``handle`` and revokes the lease) or
    serving is cancelled (SIGINT, a lost lease), which stops ``handle`` and
    runs ``aux`` here before the cancellation goes on. The drain's lease
    revocation also cancels serving (the runtime's shutdown): the drain is
    then awaited, not repeated."""
    done = asyncio.Event()
    drain.on_done = done.set
    drain.install_signal_handlers()
    try:
        await done.wait()
    except asyncio.CancelledError:
        if drain.task is not None:
            await drain.task
        else:
            await handle.stop()
            for close in aux:
                r = close()
                if asyncio.iscoroutine(r):
                    await r
        raise


class _StatusOnly(AsyncEngine):
    """The prefill role's endpoint: it takes no requests (work arrives on
    the prefill queue); it exists so the role's stats can be scraped."""

    async def generate(self, request):
        return
        yield  # an async generator that yields nothing


def run_prefill(args) -> None:
    """Prefill worker (``in=prefill``), under ``runtime.Worker``: the engine
    is built and its prefill buckets warmed before the lease is taken; then
    it consumes the namespace's prefill queue until SIGTERM (a drain: leave
    discovery, stop consuming, revoke the lease last) or SIGINT; either
    stops consumption (an in-flight item that does not finish redelivers to
    another prefill worker after the queue's visibility timeout) and exits
    0."""
    built = []

    async def runtime() -> DistributedRuntime:
        built.extend(build_engine(args))
        await maybe_warmup(args, built[1], decode=False)
        return await connect_runtime(args)

    Worker(runtime).execute(lambda drt: serve_prefill(args, drt, built[1], built[2]))


async def serve_prefill(args, drt: DistributedRuntime, core: TorchEngine,
                        name: str) -> None:
    ns = args.namespace
    queue = PrefillQueue(drt.bus, ns)
    worker = PrefillWorker(core, queue, kv_stream=args.kv_stream,
                           segment_blocks=args.kv_segment_blocks,
                           concurrency=args.prefill_concurrency)
    handle = await drt.namespace(ns).component("prefill").endpoint("status").serve(
        _StatusOnly(),
        stats_handler=lambda: (core.load_metrics() | core.stats | worker.stats
                               | {"handoffs": list(worker.handoffs),
                                  "kernel_launches": launch_counts()}))
    worker.start()
    drain = DrainCoordinator(drt, handles=[handle], closers=[worker.close],
                             deadline_s=args.drain_deadline)
    print(f"prefill worker {drt.worker_id:x} serving {name!r} on queue "
          f"{queue.name}", flush=True)
    try:
        await _serve_until_stopped(drain, handle, [worker.close])
    finally:
        await core.close()
        print(f"prefill worker {drt.worker_id:x} stopped", flush=True)


async def run_hub(args) -> None:
    hub = HubServer(host=args.host, port=args.hub_port, data_dir=args.data_dir)
    await hub.start()
    print(f"hub listening on {hub.address}", flush=True)
    await asyncio.Event().wait()


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
        "dynamo_run", description="dynamo run on PyTorch: in=<source> out=<engine>"
    )
    p.add_argument("in_out", nargs="*",
                   help="hub | in=http|text|dyn://ns.comp.ep "
                        "out=torch|dyn://ns.comp.ep")
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
    p.add_argument("--hub", default=None, help="hub address host:port")
    p.add_argument("--hub-port", type=int, default=18500)
    p.add_argument("--data-dir", default=None,
                   help="hub durability dir (hub role): the store "
                        "snapshots+WALs its KV/leases and work queues WAL "
                        "here — a restarted hub keeps discovery state and "
                        "queued work")
    p.add_argument("--router", default="round_robin",
                   choices=["round_robin", "random", "kv"])
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
    p.add_argument("--host-cache-blocks", type=int, default=0,
                   help="host-DRAM KV tier capacity (blocks; 0 = off)")
    p.add_argument("--disk-blocks", type=int, default=0,
                   help="disk KV tier capacity (blocks; 0 = off; requires "
                        "--host-cache-blocks: host LRU overflow demotes "
                        "here, restores promote back through host DRAM)")
    p.add_argument("--disk-path", default=None,
                   help="disk-tier directory (default: a fresh tempdir, "
                        "removed at exit; a restarted worker pointed at the "
                        "same path keeps its disk tier)")
    p.add_argument("--kv-tier-ttl-s", type=float, default=0.0,
                   help="disk-tier entry TTL in seconds (0 = LRU only)")
    p.add_argument("--kv-quant", default="none", choices=["none", "int8", "fp8"],
                   help="per-block KV codec of the host and disk tiers "
                        "(engine/kvquant.py): int8 | scaled fp8 payloads + "
                        "per-layer f32 scales, dequantized by the restore's "
                        "scatter; an int8 device cache adopts int8 blocks "
                        "verbatim")
    p.add_argument("--kv-cost-model", dest="kv_cost_model",
                   action="store_true", default=True,
                   help="transfer-cost model (default on): observe restore "
                        "and prefill timings and advertise them to the KV "
                        "router")
    p.add_argument("--no-kv-cost-model", dest="kv_cost_model",
                   action="store_false",
                   help="no cost observation or advertisement (the router "
                        "keeps this worker on overlap scoring)")
    p.add_argument("--namespace", default="dynamo",
                   help="in=prefill: the prefill queue's namespace (the decode "
                        "workers' dyn:// namespace)")
    p.add_argument("--advertise-host", default=None,
                   help="routable address advertised for the KV transfer "
                        "plane's connect-back (default: this host's address)")
    p.add_argument("--disagg", default=None, choices=[None, "decode"],
                   help="decode: prompts above --max-local-prefill uncached "
                        "tokens prefill on in=prefill workers")
    p.add_argument("--max-local-prefill", type=int, default=512,
                   help="uncached prompt tokens above this go remote")
    p.add_argument("--kv-stream", dest="kv_stream", action="store_true",
                   default=True,
                   help="streamed KV handoff: the transfer opens at prefill "
                        "start and each chunk's blocks ship as its compute "
                        "finishes (default)")
    p.add_argument("--no-kv-stream", dest="kv_stream", action="store_false",
                   help="the bulk KV handoff after prefill (the decode role "
                        "stops advertising the stream, the prefill role stops "
                        "using it)")
    p.add_argument("--kv-segment-blocks", type=int, default=0,
                   help="cap a streamed segment's blocks (0 = one segment per "
                        "prefill chunk)")
    p.add_argument("--prefill-concurrency", type=int, default=1,
                   help="in=prefill: prompts advancing chunk-wise together on "
                        "one engine (1 = whole prompts in turn)")
    p.add_argument("--no-migration", action="store_true",
                   help="frontend (--router kv): no in-flight migration; a "
                        "worker's death or drain then errors its streams "
                        "instead of resuming them on another worker")
    p.add_argument("--max-migrations", type=int, default=3,
                   help="re-dispatch attempts per request before the "
                        "failure reaches the client")
    p.add_argument("--migration-deadline", type=float, default=30.0,
                   help="wall-clock budget (s) from a request's first "
                        "failure across all its re-dispatches")
    p.add_argument("--drain-deadline", type=float, default=15.0,
                   help="SIGTERM graceful-drain budget (s): in-flight "
                        "requests get this long to finish before being "
                        "handed off to surviving workers")
    p.add_argument("--kv-cache-dtype", default="model",
                   choices=list(KV_CACHE_DTYPES),
                   help="KV cache storage dtype (int8 = int8-with-scales "
                        "device cache, per-(layer, page) f32 scale planes; "
                        "float8_e4m3 = scale-free fp8 pages, GQA and MLA)")
    args = p.parse_args(argv)
    kv = dict(a.split("=", 1) for a in args.in_out if "=" in a)
    args.in_ = "hub" if "hub" in args.in_out else kv.get("in", "http")
    args.out = kv.get("out", "torch")
    if args.in_ == "hub":
        return args
    if args.out != "torch" and not args.out.startswith("dyn://"):
        p.error(f"out={args.out}: this launcher serves out=torch and "
                "out=dyn://ns.comp.ep")
    if args.in_ not in ("http", "text", "prefill") and not args.in_.startswith("dyn://"):
        p.error(f"in={args.in_}: this launcher serves hub, in=http, in=text, "
                "in=prefill and in=dyn://ns.comp.ep")
    if args.out.startswith("dyn://") and args.in_ != "http":
        p.error("out=dyn://... is the frontend role: it takes in=http")
    if (args.in_.startswith("dyn://") or args.in_ == "prefill") and args.out != "torch":
        p.error(f"in={args.in_} is a worker role: it takes out=torch")
    if args.disagg and not args.in_.startswith("dyn://"):
        p.error("--disagg decode is the worker role's: it takes in=dyn://...")
    for addr in (args.in_, args.out):
        if addr.startswith("dyn://") and addr.count(".") != 2:
            p.error(f"{addr}: want dyn://namespace.component.endpoint")
    return args


ROLES = {"hub": run_hub, "http": run_http, "text": run_text}


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = parse_args(argv)
    if args.in_.startswith("dyn://"):
        return run_endpoint(args)  # its own loop and signal handling
    if args.in_ == "prefill":
        return run_prefill(args)
    try:
        asyncio.run(ROLES[args.in_](args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])
