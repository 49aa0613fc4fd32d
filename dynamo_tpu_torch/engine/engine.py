"""The PyTorch engine: continuous batching over a paged KV cache.

``TorchEngine`` is the main-path subset of ``dynamo_tpu/engine/engine.py``
(``JaxEngine``): one background scheduler task owns the device state
(params, KV cache, block tables) and interleaves

  * **admission**: prefix-cache matching, block allocation, chunked
    prefill (``prefill_chunk``); a lone prompt with nothing decoding runs
    the dedicated prefill program,
  * **mixed steps**: while prompts are in flight AND sequences decode (or
    two or more prompts pack together), ONE fused step runs a budgeted
    chunk of up to ``mixed_max_prefills`` prompts plus one decode token
    for every active sequence (``llama.mixed_step``),
  * **decode windows**: otherwise ``decode_window`` merged decode steps per
    dispatch (``llama.decode_window``), clamped to every sequence's
    stop/context headroom and to one step while admission work is
    actionable,
  * **speculative verifies** (``spec_gamma`` > 0): where a multi-step window
    would run and prompt lookup finds an n-gram match, ONE fused forward
    verifies ``spec_gamma`` proposals per sequence
    (``llama.verify_window``) and emits the accepted run plus one token,
  * **emission**: sampled tokens stream into per-request asyncio queues,
    with stop conditions, cancellation, penalties, logprobs and
    preemption by recompute under pool pressure.

Models: dense GQA decoders and the DeepSeek MLA + MoE family (the latent
cache is two single-"head" paged arrays of different widths, from
``llama.kv_cache_shapes``; MLA mixed steps take the per-part flavor inside
``llama.mixed_step``). Quantized serving (``EngineConfig.quantization``,
``kv_cache_dtype``; models/quant.py): weights quantize before they
serve, and the int8-with-scales KV cache keeps ``[L, N]`` f32
scale planes beside the caches — recycled pages get their scales reset by
one scatter on the next dispatch, prefix-cache claims keep theirs, and the
device count of requantized pages folds into the stats only when
``load_metrics`` is scraped. The scale-free ``float8_e4m3`` cache (GQA,
and MLA's latent pages) holds half the bytes of bf16 pages and no
planes; speculation runs over it as over bf16. Device work
runs in the loop's executor under one lock, so the event loop stays live
while the card computes.

Programs (the reference's XLA program buckets): prompt chunks pad to the
reference's buckets, so both engines run the same shapes. On the card the
decode window and the verify replay one CUDA graph per key
(``engine/graphs.py``); prefill and the fused mixed step run eagerly. The
first dispatch of every program key (``(kind, *bucket shape)``, the
reference's tuples) lands in ``compile_ledger`` with its wall time (for a
graph: the eager run plus the capture; a key's graphs differ by two host
flags, and each one's first dispatch is ledgered under the key), and
``warmup`` dispatches every reachable key before traffic, as the
reference's does, with every graph of the decode-window ladder.

KV tiers (``host_cache_blocks``, ``disk_cache_blocks``; engine/offload.py):
pages the allocator evicts from its reuse pool are gathered to host DRAM
(budgeted and double-buffered before decode windows and verifies, all of
them before a prefill chunk or a mixed step), the host pool's overflow
demotes to disk, and admission reserves a prompt's continuation past the
device match from host or disk and starts its h2d copy at once; the chunk
that needs the pages lands it with one scatter launch. With ``kv_quant``
the tiers hold int8 / scaled-fp8 blocks (engine/kvquant.py); an int8
device cache and an int8 tier exchange codes and scales verbatim. The
transfer-cost model (kv_router/costmodel.py) observes the host and disk
links and the dedicated prefill chunks, and ``load_metrics`` advertises
it.

Disaggregation (``disagg/``): a prefill worker's engine computes a
prompt's KV and first token (``prefill_extract`` / the chunk-streamed
``prefill_extract_stream``) and gathers the pages with the block-copy
kernel; a decode worker's engine reserves the request's pages up front
(``begin_remote``), lands the delivered KV into them with the block-copy
scatters (``scatter_remote_segment`` / ``complete_remote``, in place, the
int8 cache's scale resets flushed first) and joins the sequence to its
decode batch. The fleet tier: ``export_device_chain`` serves a peer's pull
from the device pages, and ``prefetch_hint`` lands a router-hinted chain
(host, disk or peer-pulled) into the reuse pool before its request
arrives.

Resilience (``resilience/``): ``drain`` stops admission (new requests
bounce with the migration signal), lets in-flight work finish within a
deadline and then hands the rest off with the signal, at an iteration
boundary of the loop; a request carrying the ``resume`` annotation (a
migrated stream: prompt + tokens delivered so far) restores its
prompt / generated split, so its seeded sampling and penalties continue at
the seam. Left out of this slice (ROADMAP queue A): adapters, live reshard,
the pipelined decode, multi-host mirrors, tracing / flight recorder, and
the capture of prefill and of the mixed step.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import AsyncIterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama
from ..models.config import ModelConfig
from ..models.mla import MLA_INT8_NATIVE
from ..models.quant import KV_SCALE_EPS, kv_cache_dtype, quantize_params
from ..ops import block_copy, mla_attention
from ..ops.paged_attention import check_head_dim
from ..ops.sampling import make_keys, sample_first_token, token_logprobs
from ..protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from ..resilience.migration import RESUME_KEY
from ..resilience.policy import MIGRATION_SIGNAL
from ..runtime.engine import AsyncEngine, Context
from .allocator import Block, BlockAllocator, sequence_block_hashes
from .graphs import GraphRunner, StaticInputs
from .hist import MS_BUCKETS, Histogram
from .kvquant import KV_QUANT_MODES, wire_block_bytes
from .offload import OffloadManager, RestoreUpload

#: the port's kv-head ordering and tensor-parallel degree, as the transfer
#: plane declares them (ops/kv_rearrange.py): one device, heads in order
KV_HEAD_LAYOUT = "blocked"
MESH_TP = 1

logger = logging.getLogger(__name__)

PREFILL_BUCKETS = [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192]


def _leaves(v):
    """The tensors of a parameter entry: a tensor, a layer group, or a
    quantized node inside one."""
    if isinstance(v, dict):
        for x in v.values():
            yield from _leaves(x)
    else:
        yield v


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return ((n + 8191) // 8192) * 8192


def _seg_bucket(n: int) -> int:
    """Segment-count bucket of the fused mixed step: the smallest power of
    two covering ``n`` in-flight prompts (dead pad segments fill it)."""
    b = 1
    while b < n:
        b *= 2
    return b


@dataclass
class EngineConfig:
    model: ModelConfig
    num_blocks: int = 256
    block_size: int = 16
    max_batch_size: int = 8
    max_context: int = 0  # 0 -> model.max_position_embeddings
    prefill_chunk: int = 2048
    max_queue: int = 1024
    # prefill tokens per fused mixed step; 0 = prefill_chunk
    mixed_step_budget: int = 0
    # max concurrent prompts whose chunks pack into one fused step
    mixed_max_prefills: int = 4
    # max fused decode steps per dispatch
    decode_window: int = 4
    # weight quantization: "none" | "int8" | "fp8_e4m3" | "int8_native"
    # (models/quant.py: per-output-channel scales; MoE expert stacks
    # quantize too and run the ragged_int8_gmm kernel)
    quantization: str = "none"
    # KV cache storage: "model" | "bfloat16" | "int8" (int8 with per-page
    # f32 scale planes) | "float8_e4m3" (scale-free float8_e4m3fn pages,
    # the reference's cast; GQA and MLA's latent pages)
    kv_cache_dtype: str = "model"
    # speculative decoding via prompt-lookup (n-gram) drafts: propose up to
    # spec_gamma continuation tokens from the sequence's own history (its
    # last spec_ngram tokens matched against an earlier occurrence) and
    # verify them in ONE fused forward (llama.verify_window). Greedy rows
    # accept argmax-matching proposals, sampled rows by rejection sampling
    # (lossless in distribution). Greedy streams equal plain decode's
    # except at exact logit ties. 0 = off.
    spec_gamma: int = 0
    spec_ngram: int = 3
    # host-DRAM KV tier capacity in blocks (0 = off): evicted device pages
    # park here and restore on prefix hits (engine/offload.py)
    host_cache_blocks: int = 0
    # disk KV tier capacity in blocks (0 = off; needs a host tier:
    # restores promote through host DRAM). Host-pool LRU overflow demotes
    # here; disk LRU/TTL overflow is the real drop
    disk_cache_blocks: int = 0
    # disk-tier directory (None = a fresh tempdir per engine, removed at
    # close); a restarted worker pointed at the same path keeps its tier
    disk_cache_path: Optional[str] = None
    # disk-tier entry TTL in seconds (0 = LRU only)
    kv_tier_ttl_s: float = 0.0
    # async tiers: d2h flushes land on background threads (double-buffered,
    # budgeted) and h2d restores copy from the moment admission reserves
    # the chain. False = synchronous transfers
    offload_async: bool = True
    # max OPTIONAL evicted blocks one decode dispatch gathers d2h;
    # evictions whose pages the dispatch writes always flush
    offload_flush_budget: int = 64
    # the transfer-cost model (kv_router/costmodel.py): observe restore and
    # dedicated-prefill timings and advertise them in load_metrics
    kv_cost_model: bool = True
    # tier codec (engine/kvquant.py): "none" | "int8" | "fp8"
    kv_quant: str = "none"

    def __post_init__(self):
        if self.spec_gamma > 0 and self.decode_window < 2:
            raise ValueError(
                "spec_gamma requires decode_window >= 2: the speculative "
                "path only engages when the scheduler picks multi-step "
                "windows (decode_window=1 would silently disable it)"
            )
        if self.max_context == 0:
            self.max_context = self.model.max_position_embeddings
        if self.mixed_step_budget < 0:
            raise ValueError(
                f"mixed_step_budget={self.mixed_step_budget} must be >= 0 "
                "(0 = prefill_chunk)"
            )
        if self.mixed_step_budget == 0:
            self.mixed_step_budget = self.prefill_chunk
        if self.mixed_max_prefills < 1:
            raise ValueError(
                f"mixed_max_prefills={self.mixed_max_prefills} must be >= 1"
            )
        if self.disk_cache_blocks > 0 and self.host_cache_blocks <= 0:
            raise ValueError(
                "disk_cache_blocks > 0 requires host_cache_blocks > 0 "
                "(disk restores promote through the host tier)"
            )
        if self.kv_quant not in KV_QUANT_MODES:
            raise ValueError(
                f"kv_quant must be one of {KV_QUANT_MODES}, "
                f"got {self.kv_quant!r}"
            )
        self.max_blocks_per_seq = (
            self.max_context + self.block_size - 1
        ) // self.block_size


@dataclass
class _Sequence:
    request: PreprocessedRequest
    context: object  # AsyncEngineContext
    out_queue: asyncio.Queue
    tokens: list[int] = field(default_factory=list)  # prompt + generated
    prompt_len: int = 0
    blocks: list[Block] = field(default_factory=list)
    committed: int = 0  # number of blocks committed (full + hashed)
    parent_hash: Optional[int] = None
    generated: int = 0
    cached_prefix: int = 0  # tokens served from the prefix cache
    slot: int = -1  # decode batch slot
    finished: bool = False
    arrival_t: float = field(default_factory=time.monotonic)

    @property
    def seq_len(self) -> int:
        return len(self.tokens)


class OutOfBlocks(RuntimeError):
    """The pool cannot cover a remote prefill's prompt (the prefill worker
    nacks the queue item for another worker)."""


@dataclass
class RemoteHandle:
    """A decode-side reservation for a remotely prefilled sequence: its
    pages are allocated and stay uncommitted until the KV lands, so a
    redelivered segment scatters again over the same pages."""

    seq: _Sequence
    skip_blocks: int
    n_prompt_blocks: int


@dataclass
class _PrefillState:
    """An in-flight chunked prefill (one chunk per scheduler iteration)."""

    seq: _Sequence
    pos: int  # next prompt index to prefill
    ms: float = 0.0  # wall time of the dispatches that carried its chunks
    # the reserved host chain's h2d stage, landed before the first chunk
    upload: Optional[RestoreUpload] = None
    restored: bool = False


class TorchEngine(AsyncEngine):
    """AsyncEngine over PreprocessedRequest -> LLMEngineOutput stream."""

    def __init__(
        self,
        cfg: EngineConfig,
        params: Optional[dict] = None,
        seed: int = 0,
        device=None,
    ):
        self.cfg = cfg
        mcfg = cfg.model
        self.device = resolve_device(device)
        llama.check_supported(mcfg)
        if self.device.type == "cuda" and mcfg.is_mla and not (
            mla_attention.takes_widths(mcfg.kv_lora_rank, mcfg.qk_rope_head_dim)
        ):
            # the JAX engine's MLA kernel gate (kv_lora_rank % 128 == 0);
            # where the JAX engine falls back to XLA, the card runs the
            # kernel or nothing
            raise ValueError(
                f"MLA latent widths C={mcfg.kv_lora_rank}, "
                f"R={mcfg.qk_rope_head_dim}: the CUDA latent kernels take "
                f"kv_lora_rank % 128 == 0 and rope widths >= 1"
            )
        if self.device.type == "cuda" and not mcfg.is_mla:
            # the GQA kernels' widths (64, 128, 192, 256); the JAX engine
            # falls back to XLA for the others, the card runs the kernels
            # or nothing
            check_head_dim("TorchEngine", mcfg.head_dim)
        if mcfg.is_mla and cfg.quantization == "int8_native":
            raise ValueError(MLA_INT8_NATIVE)
        # None, bf16, int8 or float8_e4m3fn
        cache_dt = kv_cache_dtype(mcfg, cfg.kv_cache_dtype)
        if (self.device.type == "cuda" and mcfg.is_mla
                and cache_dt == torch.float8_e4m3fn
                and llama._dtype(mcfg) != torch.bfloat16):
            # the latent kernels read fp8 pages under bf16 queries only
            raise ValueError(
                "kv_cache_dtype='float8_e4m3' on an MLA model takes a bf16 "
                f"model on the card (got {llama._dtype(mcfg)})"
            )
        if cache_dt == torch.int8 and mcfg.is_mla:
            # refused, not a silent fallback: the absorbed latent path dots
            # queries against the cache directly and has no per-page scale
            # stream
            raise ValueError(
                "kv_cache_dtype='int8' is not supported for MLA models: the "
                "absorbed-matmul latent path has no per-page scale stream"
            )
        if cache_dt == torch.int8 and cfg.spec_gamma > 0:
            logger.warning(
                "kv_cache_dtype='int8': speculative (prompt-lookup) decoding "
                "is disabled — the fused verify forward has no scale-plane "
                "stream; decode runs plain windows"
            )
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(mcfg, gen, self.device)
        # quantize before the weights serve: the codes replace the
        # full-width leaves (the caller's dictionary is not changed)
        self.params = quantize_params(params, mcfg, cfg.quantization)
        self.k_cache, self.v_cache = llama.init_kv_cache(
            mcfg, cfg.num_blocks, cfg.block_size, device=self.device,
            dtype=cache_dt,
        )
        # int8-with-scales cache: one f32 absmax scale per (layer, physical
        # page) for K and for V, updated in place by every write
        self.k_scales = self.v_scales = None
        if cache_dt == torch.int8:
            self.k_scales, self.v_scales = (
                torch.full((mcfg.num_layers, cfg.num_blocks), KV_SCALE_EPS,
                           dtype=torch.float32, device=self.device)
                for _ in range(2)
            )
        self.allocator = BlockAllocator(cfg.num_blocks, cfg.block_size)
        # recycled pages must not inherit a previous tenant's scale: every
        # fresh allocation queues a reset, flushed as ONE scatter on the
        # next dispatch (_flush_scale_resets); prefix claims keep theirs
        self._pending_scale_resets: list[int] = []
        # the device requant count, summed over dispatches (never a graph's
        # own output tensor: the next replay overwrites that)
        self._requants_dev: Optional[torch.Tensor] = None
        # the executor adds to the counter while a scrape folds it
        self._requants_lock = threading.Lock()
        self._lowprec_rate_t = 0.0
        self._weight_bytes: Optional[int] = None
        if self.k_scales is not None:
            self.allocator.on_allocated = self._pending_scale_resets.append
            # bytes one token's K+V rows save landing int8 instead of at
            # the model's width (the planes are counted in _hbm_stats)
            self._kv_saved_per_token = int(
                2 * mcfg.num_layers * mcfg.num_kv_heads * mcfg.head_dim
                * (llama._dtype(mcfg).itemsize - 1)
            )
        self.kv_block_bytes = int(
            (self.k_cache.nbytes + self.v_cache.nbytes) // max(cfg.num_blocks, 1)
        )
        # bytes one block costs on the tier planes (the full width, or the
        # tier codec's payload + per-layer scales)
        self.kv_wire_block_bytes = wire_block_bytes(
            self.kv_block_bytes, self.k_cache.element_size(), mcfg.num_layers,
            cfg.kv_quant)
        self.offload: Optional[OffloadManager] = None
        if cfg.host_cache_blocks > 0:
            self.offload = OffloadManager(
                cfg.host_cache_blocks,
                flush_budget=cfg.offload_flush_budget,
                async_tier=cfg.offload_async,
                disk_blocks=cfg.disk_cache_blocks,
                disk_path=cfg.disk_cache_path,
                tier_ttl_s=cfg.kv_tier_ttl_s,
                kv_quant=cfg.kv_quant,
                block_bytes=self.kv_block_bytes,
                # dequantized entries take the model's width (an int8
                # cache's own dtype is the code, not the width)
                full_dtype=(llama._dtype(mcfg) if self.k_scales is not None
                            else self.k_cache.dtype),
                device=self.device,
            )
            self.allocator.on_evict = lambda h, b: self.offload.on_evict(h, b.idx)
            # a lower tier's copy aging out must not un-index a block the
            # device still holds
            self.offload.device_has = self.allocator.has_hash
            if self.k_scales is not None:
                # tier traffic speaks the device codec: flushes gather codes
                # + scales, restores land them back into the planes in place
                self.offload.device_planes = lambda: (self.k_scales, self.v_scales)
        self.cost = None
        if cfg.kv_cost_model:
            # imported here: the kv_router package imports the engine's
            from ..kv_router.costmodel import TransferCostModel

            self.cost = TransferCostModel(block_bytes=self.kv_block_bytes)
            if self.offload is not None:
                self.offload.cost_model = self.cost
        # the card's dedicated chunks not yet folded into the cost model:
        # (tokens, start event, end event), read once they completed, at a
        # sync the engine makes anyway (executor thread only)
        self._chunk_events: deque = deque()
        # the offload manager's export-bounce count already folded
        self._offload_requants_seen = 0
        self._waiting: asyncio.Queue[_Sequence] = asyncio.Queue(cfg.max_queue)
        # re-admissions (preemption replay, backpressure put-back) jump the
        # line through this front buffer
        self._waiting_front: deque[_Sequence] = deque()
        # in-flight chunked prefills, admission order
        self._prefill_states: list[_PrefillState] = []
        # remotely prefilled sequences whose KV landed, waiting for a slot
        self._remote_ready: list[_Sequence] = []
        self._active: list[Optional[_Sequence]] = [None] * cfg.max_batch_size
        self._n_active = 0
        self._loop_task: Optional[asyncio.Task] = None
        # serializes device-state mutation (the caches are updated in place)
        self._device_lock = asyncio.Lock()
        self._wake = asyncio.Event()
        self._closed = False
        self._backpressured = False
        # graceful drain (resilience/drain.py): _draining stops admission
        # (generate() bounces new work with the migration signal); past
        # _drain_deadline the scheduler hands off in-flight streams too
        self._draining = False
        self._drain_handoff = True
        self._drain_deadline = 0.0
        self._dead: Optional[str] = None
        # host mirrors of the batch state, uploaded per dispatch
        B, M = cfg.max_batch_size, cfg.max_blocks_per_seq
        self._block_tables = np.zeros((B, M), np.int32)
        self._seq_lens = np.zeros(B, np.int32)
        self._last_tokens = np.zeros(B, np.int32)
        self._seeds = np.zeros(B, np.int64)
        self._temps = np.zeros(B, np.float32)
        self._top_ks = np.zeros(B, np.int32)
        self._top_ps = np.ones(B, np.float32)
        # sampling penalties (vLLM semantics): device [B, V] output-token
        # counts + prompt-membership mask, allocated on first use
        self._freq_pens = np.zeros(B, np.float32)
        self._pres_pens = np.zeros(B, np.float32)
        self._rep_pens = np.ones(B, np.float32)
        self._pen_counts: Optional[torch.Tensor] = None
        self._pen_mask: Optional[torch.Tensor] = None
        # requested top-logprob count per slot (-1 = off)
        self._logprob_ks = np.full(B, -1, np.int32)
        # the decode window's and the verify's device inputs: static, so a
        # captured graph reads each dispatch's state (engine/graphs.py)
        self._graphs = GraphRunner(self.device, capture=True)
        self._static = StaticInputs(self.device, {
            "last_tokens": ((B,), np.int32), "positions": ((B,), np.int32),
            "block_tables": ((B, M), np.int32), "seq_lens": ((B,), np.int32),
            "seeds": ((B,), np.int64), "steps": ((B,), np.int64),
            "temps": ((B,), np.float32), "top_ks": ((B,), np.int32),
            "top_ps": ((B,), np.float32), "freq_pens": ((B,), np.float32),
            "pres_pens": ((B,), np.float32), "rep_pens": ((B,), np.float32),
        })
        self._verify_static: Optional[StaticInputs] = None  # first verify's
        # (kind, *bucket shape) keys whose program has dispatched at least
        # once, and newest-last {kind, key, ms} entries of those first
        # dispatches (bounded), as the reference keeps them
        self._compiled_keys: set[tuple] = set()
        self.compile_ledger: list[dict] = []
        self.stats = {
            "requests_total": 0,
            "requests_active": 0,
            "requests_waiting": 0,
            "tokens_generated": 0,
            "prompt_tokens_total": 0,
            "prefix_cache_hits_tokens": 0,
            "prefill_chunks": 0,
            "decode_steps": 0,
            "decode_windows": 0,
            "mixed_steps": 0,
            "mixed_prefill_segments": 0,
            "preemptions": 0,
            "spec_proposed": 0,
            "spec_accepted": 0,
            "kv_device_quant_pages": 0,
            "kv_device_requants_total": 0,
            "kv_device_bytes_saved_total": 0,
            "kv_device_export_requant_total": 0,
            # device-tier blocks a peer's pull gathered d2h
            "peer_serve_d2h_blocks": 0,
            "lowprec_tok_s": 0.0,
            # the tier codec's worst measured logprob drift
            # (kvquant.measure_logprob_drift)
            "kv_quant_logprob_drift_max": 0.0,
            # first dispatches of program keys (the reference's XLA
            # compile ledger counters) and warmup's coverage
            "xla_compiles_total": 0,
            "xla_compile_ms_total": 0.0,
            "xla_warm_buckets": 0,
            "xla_reachable_buckets": 0,
            # the resilience surface: drains, the streams they handed off,
            # and resumed (migrated) requests this engine took
            "drains_total": 0,
            "drain_handoffs": 0,
            "migration_resumes": 0,
        }
        # the worker's latency distributions in the reference's wire form
        # (load_metrics' hist_* keys): admission wait, prefill wall and
        # host-chain landing per prompt, the disaggregated handoff's whole
        # remote leg (DisaggEngine), TTFT per served model ("" = the base
        # model)
        self.hist = {k: Histogram(MS_BUCKETS) for k in (
            "queue_wait_ms", "prefill_ms", "restore_ms", "handoff_ms")}
        self.hist_ttft: dict[str, Histogram] = {}

    # ---------------- public api ----------------

    def start(self) -> None:
        if self._loop_task is None:
            self._loop_task = asyncio.get_running_loop().create_task(self._loop())

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._loop_task:
            self._loop_task.cancel()
            self._loop_task = None
        if self.offload is not None:
            self.offload.close()

    async def warmup(self, decode: bool = True) -> list[int]:
        """Dispatch the serving programs BEFORE real traffic, as the
        reference's ``JaxEngine.warmup`` does: one request per reachable
        prefill bucket plus the whole decode-window ladder. On the card the
        first dispatch of a window size builds the kernels it has not run
        yet and captures its CUDA graph; without warmup the first real
        request at that shape pays it inside its stream.

        The reference's details, kept:
          * each bucket gets its own pseudo-random prompt
            (``RandomState(1000 + i)``): a repeated prompt would hit the
            prefix cache and prefill only a smaller tail bucket;
          * a prompt of ``min(prefill_chunk, max_context - 1)`` tokens
            warms the top bucket real chunks round up to, where that limit
            is not a bucket boundary;
          * the first request's ``max_tokens`` is ``2 * decode_window``:
            one token comes from the prefill, so decode has ``2W - 1`` and
            ``_pick_window`` walks the ladder W, W/2, ..., 1;
          * speculation is held off while warmup runs and restored after
            (repeated-token prompts would bait prompt lookup, and a verify
            would swallow the windows being warmed).

        Beyond the reference: a window size has up to three graphs (greedy,
        sampled, sampled with top-k / top-p; ``_host_flags``), so two more
        requests of the smallest bucket, one seeded sampled and one also
        filtered, walk the ladder again and capture the others. They open
        no new program key; their captures add ledger entries.

        ``decode=False`` dispatches no decode window (every request stops
        at its prefill-sampled token). Warmup blocks enter the prefix cache
        and age out like any other. Returns the warmed bucket sizes."""
        lim = min(self.cfg.prefill_chunk, self.cfg.max_context - 1)
        lengths = [b for b in PREFILL_BUCKETS if b <= lim]
        sizes = list(lengths)
        top = _bucket(lim)
        if top not in sizes:
            lengths.append(lim)
            sizes.append(top)
        W = self.cfg.decode_window
        V = self.cfg.model.vocab_size
        # (prompt length, max_tokens, sampling) per warmup request
        greedy = SamplingOptions(temperature=0.0)
        plan = [(n, 2 * W if (i == 0 and decode) else 1, greedy)
                for i, n in enumerate(lengths)]
        if decode:
            plan += [(lengths[0], 2 * W, SamplingOptions(temperature=1.0, seed=0)),
                     (lengths[0], 2 * W, SamplingOptions(
                         temperature=1.0, seed=0, top_k=8, top_p=0.9))]
        gamma, self.cfg.spec_gamma = self.cfg.spec_gamma, 0
        try:
            for i, (n_toks, max_tokens, so) in enumerate(plan):
                toks = np.random.RandomState(1000 + i).randint(
                    0, V, n_toks).tolist()
                req = PreprocessedRequest(
                    token_ids=toks,
                    stop_conditions=StopConditions(
                        max_tokens=max_tokens, ignore_eos=True,
                    ),
                    sampling_options=so,
                    eos_token_ids=[],
                )
                async for _ in self.generate(Context(req)):
                    pass
        finally:
            self.cfg.spec_gamma = gamma
        # coverage: program keys this warmup dispatched against what
        # traffic can reach through it (the reference's formula)
        warm = sum(1 for k in self._compiled_keys
                   if k[0] in ("prefill", "decode", "mixed"))
        reachable = len(sizes)
        if decode:
            w = W
            while w >= 1:  # the _pick_window power-of-two ladder
                reachable += 1
                w //= 2
        self.stats["xla_warm_buckets"] = warm
        self.stats["xla_reachable_buckets"] = reachable
        logger.info(
            "warmup coverage: %d/%d reachable program buckets dispatched "
            "(%d first dispatches, %.0f ms, %d CUDA graphs)", warm, reachable,
            self.stats["xla_compiles_total"], self.stats["xla_compile_ms_total"],
            len(self._graphs.graphs),
        )
        return sizes

    async def generate(self, request: Context) -> AsyncIterator[LLMEngineOutput]:
        if self._draining or self._dead is not None:
            # draining or dead: bounce at once with a worker-lost signature,
            # so a migration-aware frontend re-dispatches it elsewhere
            yield LLMEngineOutput(finish_reason=FinishReason.ERROR,
                                  text=self._dead or MIGRATION_SIGNAL)
            return
        self.start()
        req: PreprocessedRequest = request.data
        if isinstance(req, dict):
            req = PreprocessedRequest.from_dict(req)
        if not req.token_ids:
            yield LLMEngineOutput(finish_reason=FinishReason.ERROR, text="empty prompt")
            return
        if len(req.token_ids) >= self.cfg.max_context:
            yield LLMEngineOutput(finish_reason=FinishReason.ERROR)
            return
        V = self.cfg.model.vocab_size
        if not all(0 <= t < V for t in req.token_ids):
            yield LLMEngineOutput(
                finish_reason=FinishReason.ERROR,
                text=f"prompt token id out of range [0, {V})",
            )
            return
        seq = _Sequence(
            request=req,
            context=request.context,
            out_queue=asyncio.Queue(),
            tokens=list(req.token_ids),
            prompt_len=len(req.token_ids),
        )
        resume = (req.annotations.get(RESUME_KEY)
                  if isinstance(req.annotations, dict) else None)
        if isinstance(resume, dict):
            # a migrated request: token_ids = the original prompt + the
            # tokens already delivered. Restoring the split continues the
            # stream exactly: the sampling keys (seed, generated) pick up at
            # the seam, the penalties rebuild from the true output, and the
            # token limits and usage count from the original prompt
            try:
                plen = int(resume.get("prompt_len", 0))
            except (TypeError, ValueError):
                plen = 0
            if 0 < plen <= len(req.token_ids):
                seq.prompt_len = plen
                seq.generated = len(req.token_ids) - plen
                self.stats["migration_resumes"] += 1
        self.stats["requests_total"] += 1
        self.stats["prompt_tokens_total"] += seq.prompt_len
        await self._waiting.put(seq)
        self._wake.set()
        while True:
            out = await seq.out_queue.get()
            if out is None:
                return
            yield out
            if out.is_final():
                return

    def load_metrics(self) -> dict:
        """Worker stats under exactly the JAX engine's keys (the ones
        ``WorkerLoad.from_stats`` scrapes, and the rest of the reference's
        scrape schema). The ``xla_*`` keys count the first dispatches of
        program keys (on the card: kernel builds and CUDA graph captures)
        and warmup's coverage. With the KV tiers on, their keys join
        (queued last-tier drops are published first), and the transfer-cost
        model's counters close the scrape. Features this worker does not
        have report their idle values: no autopilot, reshard, weight
        prestaging or adapters; one device, one served name. The int8
        cache's device requant counter converts to a host number here, and
        only here."""
        self._fold_quant_counters()
        hbm = self._hbm_stats()
        out = {
            "hist_queue_wait_ms": self.hist["queue_wait_ms"].to_vec(),
            "hist_prefill_ms": self.hist["prefill_ms"].to_vec(),
            "hist_restore_ms": self.hist["restore_ms"].to_vec(),
            "hist_handoff_ms": self.hist["handoff_ms"].to_vec(),
            "hist_ttft_ms": {m: h.to_vec() for m, h in self.hist_ttft.items()},
            "xla_compiles_total": self.stats["xla_compiles_total"],
            "xla_compile_ms_total": round(self.stats["xla_compile_ms_total"], 3),
            "xla_warm_buckets": self.stats["xla_warm_buckets"],
            "xla_reachable_buckets": self.stats["xla_reachable_buckets"],
            "autopilot_warmups_applied": 0,
            "autopilot_warmup_ms_total": 0.0,
            "autopilot_quarantined": 0,
            "autopilot_quarantines_total": 0,
            "hbm_bytes_in_use": hbm["in_use"],
            "hbm_bytes_limit": hbm["limit"],
            "hbm_kv_pool_bytes": hbm["kv_pool"],
            "hbm_weights_bytes": hbm["weights"],
            # the reference's runtime-sanitizer counters: no sanitizer here
            "san_loop_stalls": 0,
            "san_loop_stall_max_ms": 0.0,
            "san_lock_holds": 0,
            "san_lock_hold_max_ms": 0.0,
            "san_writers_leaked": 0,
            "san_executor_pending_max": 0,
            "mixed_steps": self.stats["mixed_steps"],
            "mixed_prefill_segments": self.stats["mixed_prefill_segments"],
            "kv_active_blocks": self.allocator.used_count,
            "kv_total_blocks": self.allocator.num_blocks - 1,
            "gpu_cache_usage_perc": self.allocator.usage(),
            "request_active_slots": self._n_active,
            "request_total_slots": self.cfg.max_batch_size,
            "num_requests_waiting": self._waiting_size(),
            "requests_total": self.stats["requests_total"],
            "tokens_generated": self.stats["tokens_generated"],
            "prompt_tokens_total": self.stats["prompt_tokens_total"],
            # the router deprioritizes a draining worker
            "draining": int(self._draining),
            "drains_total": self.stats["drains_total"],
            "drain_handoffs": self.stats["drain_handoffs"],
            "migration_resumes": self.stats["migration_resumes"],
            "kv_block_bytes": self.kv_block_bytes,
            "kv_wire_block_bytes": self.kv_wire_block_bytes,
            "kv_quant_logprob_drift_max": self.stats["kv_quant_logprob_drift_max"],
            "kv_block_size": self.cfg.block_size,
            "kv_slice_fp": self._slice_fp(),
            "mesh_tp": 1,
            "resharding": 0,
            "resharded_total": 0,
            "reshard_hold_ms": 0.0,
            "reshard_kv_moved_blocks": 0,
            "peer_serve_d2h_blocks_total": self.stats["peer_serve_d2h_blocks"],
            "weight_prestage_requests": 0,
            "weight_prestage_bytes": 0,
            "weight_prestage_hits": 0,
            "served_models": [""],
            # int8-with-scales device-cache lane (zeros unless
            # kv_cache_dtype="int8")
            "kv_device_quant_pages": self.stats["kv_device_quant_pages"],
            "kv_device_requants_total": self.stats["kv_device_requants_total"],
            "kv_device_bytes_saved_total": self.stats[
                "kv_device_bytes_saved_total"],
            "kv_device_export_requant_total": self.stats[
                "kv_device_export_requant_total"],
            "lowprec_tok_s": self.stats["lowprec_tok_s"],
        }
        if self.offload is not None:
            # blocks that left the LAST local tier stop counting as this
            # worker's residency before the tier keys are read
            self.offload.flush_dropped()
            out.update(self.offload.stats())
        return out | (self.cost.counters() if self.cost is not None else {})

    def _slice_fp(self) -> str:
        """Which device this worker dispatches to, as the reference's
        slice fingerprint says it (host, process, device): equal values
        mean KV could move device to device."""
        h = hashlib.blake2b(digest_size=8)
        h.update(f"{socket.gethostname()}:{os.getpid()}|{self.device}".encode())
        return h.hexdigest()

    def _hbm_stats(self) -> dict:
        """Device-memory attribution: the KV pool (caches plus the int8
        cache's scale planes) and the weights, from the tensors themselves;
        the allocator's view on the card."""
        kv = self.k_cache.nbytes + self.v_cache.nbytes
        if self.k_scales is not None:
            kv += self.k_scales.nbytes + self.v_scales.nbytes
        if self._weight_bytes is None:
            self._weight_bytes = sum(
                t.nbytes for v in self.params.values()
                for t in _leaves(v)
            )
        in_use = limit = 0
        if self.device.type == "cuda":
            in_use = torch.cuda.memory_allocated(self.device)
            limit = torch.cuda.get_device_properties(self.device).total_memory
        return {"in_use": in_use or kv + self._weight_bytes, "limit": limit,
                "kv_pool": kv, "weights": self._weight_bytes}

    # ---- int8-with-scales device cache ----

    def _scale_kwargs(self) -> dict:
        """The planes for the next dispatch, with the recycled pages'
        entries reset first (_flush_scale_resets); empty without them."""
        if self.k_scales is None:
            return {}
        self._flush_scale_resets()
        return {"k_scales": self.k_scales, "v_scales": self.v_scales}

    def _flush_scale_resets(self) -> None:
        """Reset the plane entries of every page the allocator handed out
        since the last dispatch (queued by its ``on_allocated`` hook) to
        the floor, as ONE scatter per plane."""
        if self.k_scales is None or not self._pending_scale_resets:
            return
        idxs = self._dev(np.unique(np.asarray(self._pending_scale_resets,
                                              np.int64)))
        self._pending_scale_resets.clear()
        self.k_scales[:, idxs] = KV_SCALE_EPS
        self.v_scales[:, idxs] = KV_SCALE_EPS

    def _note_quant_step(self, n_requants, tokens_written: int,
                         gen_tokens: int = 0) -> None:
        """Fold one quantized dispatch into the lane's stats. ``n_requants``
        stays a DEVICE scalar (summed on the card; converted only by
        _fold_quant_counters at scrape time); ``gen_tokens`` > 0 (decode
        dispatches) feeds the lane's decode-throughput EMA. A decode
        window's ``n_requants`` is its graph's output, which the next
        replay overwrites: the sum starts from a copy."""
        if n_requants is not None:
            with self._requants_lock:
                self._requants_dev = (n_requants.clone() if self._requants_dev is None
                                      else self._requants_dev + n_requants)
        self.stats["kv_device_bytes_saved_total"] += (
            tokens_written * self._kv_saved_per_token)
        self.stats["kv_device_quant_pages"] = self.allocator.resident_count
        if gen_tokens > 0:
            now = time.perf_counter()
            dt = now - self._lowprec_rate_t
            if self._lowprec_rate_t and 0 < dt < 10.0:
                inst = gen_tokens / dt
                prev = self.stats["lowprec_tok_s"]
                self.stats["lowprec_tok_s"] = round(
                    inst if prev == 0.0 else 0.8 * prev + 0.2 * inst, 3)
            self._lowprec_rate_t = now

    def _fold_quant_counters(self) -> None:
        """The accumulated device requant count as a host number (one
        scalar read; load_metrics only), and the offload manager's count of
        blocks that left the device codec for a full-width or fp8 tier."""
        with self._requants_lock:
            folded, self._requants_dev = self._requants_dev, None
        if folded is not None:
            self.stats["kv_device_requants_total"] += int(folded)
        if self.offload is not None and self.k_scales is not None:
            cur = self.offload.device_requants_total
            self.stats["kv_device_export_requant_total"] += (
                cur - self._offload_requants_seen)
            self._offload_requants_seen = cur

    # ---------------- graceful drain (resilience/drain.py) ----------------

    async def drain(self, deadline_s: float = 10.0, handoff: bool = True) -> dict:
        """Stop admitting and retire in-flight work: requests get
        ``deadline_s`` to finish; with ``handoff=True`` the stragglers (and
        everything still queued) end with the migration signal, so a
        migration-aware frontend resumes them on another worker as prompt +
        tokens so far. ``handoff=False`` waits for every request to finish.
        Returns ``{"handed_off": n}``."""
        if not self._draining:
            self._draining = True
            self.stats["drains_total"] += 1
        self._drain_handoff = handoff
        self._drain_deadline = asyncio.get_running_loop().time() + deadline_s
        self._wake.set()
        handoffs_before = self.stats["drain_handoffs"]
        while (
            self._has_pending_work()
            and self._loop_task is not None
            and not self._closed
            and self._dead is None
        ):
            await asyncio.sleep(0.01)
        return {"handed_off": self.stats["drain_handoffs"] - handoffs_before}

    def _drain_tick(self) -> None:
        """One scheduler-loop pass of drain progress, at an iteration
        boundary (never beside a device dispatch): queued work is handed
        back at once (nothing of it is computed); past the deadline, the
        remotely prefilled sequences waiting for a slot, the in-flight
        prefills and the decoding streams too."""
        if not self._drain_handoff:
            return
        while not self._waiting_is_empty():
            self._handoff_seq(self._pop_waiting())
        if asyncio.get_running_loop().time() < self._drain_deadline:
            return
        while self._remote_ready:
            self._handoff_seq(self._remote_ready.pop())
        for st in list(self._prefill_states):
            self.stats["drain_handoffs"] += 1
            self._abort_prefill(st, FinishReason.ERROR, text=MIGRATION_SIGNAL)
        for seq in list(self._active):
            if seq is not None and not seq.finished:
                self._handoff_seq(seq)

    def _handoff_seq(self, seq: _Sequence) -> None:
        """End one stream with the migration signal (the tokens it already
        emitted stay valid: the frontend splices the continuation)."""
        if seq.finished:
            return
        self.stats["drain_handoffs"] += 1
        seq.out_queue.put_nowait(
            LLMEngineOutput(finish_reason=FinishReason.ERROR,
                            text=MIGRATION_SIGNAL))
        self._finish(seq, FinishReason.ERROR, emit=False)

    # ---------------- scheduler loop ----------------

    async def _loop(self) -> None:
        try:
            while not self._closed:
                if self._draining:
                    self._drain_tick()
                admitted = await self._admit()
                if (
                    self._n_active == 0
                    and not admitted
                    and not self._prefill_states
                ):
                    # re-check around the clear: a request that arrived
                    # after the check already set the event
                    if self._has_pending_work():
                        continue
                    self._wake.clear()
                    if self._has_pending_work():
                        continue
                    await self._wake.wait()
                    continue
                if self._n_active or self._mixed_fusable():
                    await self._decode_once()
                await asyncio.sleep(0)  # let emissions flush
        except asyncio.CancelledError:
            self._fail_all_owned()
        except Exception:  # noqa: BLE001
            logger.exception("engine loop crashed")
            # a dead scheduler must not park new requests: fail fast
            self._dead = "engine stopped: scheduler loop crashed"
            self._fail_all_owned(text=self._dead)

    def _has_pending_work(self) -> bool:
        return bool(
            self._waiting_front
            or not self._waiting.empty()
            or self._n_active
            or self._prefill_states
            or self._remote_ready
        )

    def _fail_all_owned(self, text: Optional[str] = None) -> None:
        """ERROR-terminate every request this engine owns."""
        in_prefill = [st.seq for st in self._prefill_states]
        for seq in self._active + self._remote_ready + in_prefill:
            if seq is not None:
                seq.out_queue.put_nowait(
                    LLMEngineOutput(finish_reason=FinishReason.ERROR, text=text)
                )
        self._prefill_states.clear()
        self._remote_ready.clear()
        while not self._waiting_is_empty():
            self._pop_waiting().out_queue.put_nowait(
                LLMEngineOutput(finish_reason=FinishReason.ERROR, text=text)
            )

    # ---- admission ----

    def _waiting_is_empty(self) -> bool:
        return not self._waiting_front and self._waiting.empty()

    def _waiting_size(self) -> int:
        return len(self._waiting_front) + self._waiting.qsize()

    def _pop_waiting(self) -> _Sequence:
        if self._waiting_front:
            return self._waiting_front.popleft()
        return self._waiting.get_nowait()

    async def _admit(self) -> bool:
        admitted = False
        self._backpressured = False
        # remotely prefilled sequences join the batch first (their prefill
        # and KV transfer already ran); in-flight prefills keep the slots
        # they were admitted against
        while self._remote_ready and (
            self._n_active + len(self._prefill_states) < self.cfg.max_batch_size
        ):
            seq = self._remote_ready.pop(0)
            if seq.finished:
                continue
            if seq.context.is_stopped():
                self._finish(seq, FinishReason.CANCELLED)
                continue
            self._place_in_batch(seq)
            admitted = True
        # advance an in-flight chunked prefill by one chunk per iteration
        # (dedicated dispatch) unless its chunks fuse into a mixed step
        if self._prefill_states and not self._mixed_fusable():
            admitted |= await self._prefill_step()
        while (
            len(self._prefill_states) < self.cfg.mixed_max_prefills
            and self._n_active + len(self._prefill_states) < self.cfg.max_batch_size
            and not self._waiting_is_empty()
        ):
            seq = self._pop_waiting()
            if seq.context.is_stopped():
                seq.out_queue.put_nowait(
                    LLMEngineOutput(finish_reason=FinishReason.CANCELLED)
                )
                continue
            prompt_hashes = None
            off = self.offload
            if off is not None and off.async_tier and (
                off.has_pending() or off.has_inflight_flushes()
                or off.disk is not None
            ):
                # land the in-flight d2h and promote the disk continuation
                # of this prompt's chain OFF the loop, so the host probe in
                # _begin_prefill neither waits on a copy nor reads a file;
                # the chain is hashed once and handed down
                prompt_hashes = sequence_block_hashes(
                    seq.tokens[: seq.seq_len - 1], self.cfg.block_size)
                await self._offload_prejoin([s for _l, s in prompt_hashes])
            ok = self._begin_prefill(seq, hashes=prompt_hashes)
            if ok and seq.generated == 0:
                # admission wait of a fresh prompt (a preemption replay is
                # post-first-token work)
                self.hist["queue_wait_ms"].observe(
                    (time.monotonic() - seq.arrival_t) * 1e3)
            if ok and self._mixed_fusable():
                continue  # rides the next fused step; keep packing
            if not ok:
                bs = self.cfg.block_size
                min_needed = min(
                    (seq.seq_len + bs) // bs + 1, self.cfg.max_blocks_per_seq
                )
                if min_needed > self.allocator.num_blocks - 1:
                    # can never fit: a fresh prompt is a capacity ERROR, a
                    # preempted one that outgrew the pool a LENGTH finish
                    reason = (
                        FinishReason.LENGTH if seq.generated
                        else FinishReason.ERROR
                    )
                    logger.warning(
                        "request %s needs %d blocks but the pool holds %d",
                        getattr(seq.context, "id", "?"), min_needed,
                        self.allocator.num_blocks - 1,
                    )
                    self._finish(seq, reason)
                    continue
                self._waiting_front.appendleft(seq)  # backpressure
                self._backpressured = True
                break
            admitted |= await self._prefill_step()
        self.stats["requests_active"] = self._n_active
        self.stats["requests_waiting"] = self._waiting_size()
        return admitted

    def _reserve_for_prompt(self, seq: _Sequence, probe_host: bool = False,
                            hashes=None):
        """The one allocation protocol of local prefill, remote prefill
        (prefill worker) and remote decode (decode worker): claim the
        prompt's cached prefix (the final token is always recomputed so
        prefill yields fresh last-position logits; claimed blocks a router
        hint prefetched count as prefetch hits), with ``probe_host``
        reserve its continuation from the host / disk tiers (starting that
        chain's h2d copy here, so it has usually landed by the time the
        chunk needs the pages), and allocate blocks for prompt + decode
        headroom. Returns (history tokens, upload or None), or None on pool
        pressure (every claim rolled back)."""
        cfg = self.cfg
        bs = cfg.block_size
        prompt = seq.tokens
        if hashes is None:
            hashes = sequence_block_hashes(prompt[: len(prompt) - 1], bs)
        matched = self.allocator.match_prefix(prompt[: len(prompt) - 1], hashes=hashes)
        if self.offload is not None and matched:
            hinted = [b.seq_hash for b in matched if b.prefetched]
            for b in matched:
                b.prefetched = False
            if hinted:
                self.offload.note_prefetch_hits(len(hinted), hashes=hinted)
        restore_hashes: list[int] = []
        restore_data: list = []
        if probe_host and self.offload is not None:
            tail = [s for _l, s in hashes[len(matched):]]
            restore_hashes, restore_data = self.offload.reserve_chain(tail)
        total_needed = min((len(prompt) + bs) // bs + 1, cfg.max_blocks_per_seq)
        fresh = self.allocator.allocate(max(0, total_needed - len(matched)))
        if fresh is None:
            self.allocator.free(matched)
            if restore_hashes:
                self.offload.unreserve(restore_hashes, restore_data)
            return None
        seq.blocks = matched + fresh
        seq.committed = len(matched)
        seq.parent_hash = matched[-1].seq_hash if matched else None
        seq.cached_prefix = (len(matched) + len(restore_hashes)) * bs
        upload = None
        if restore_hashes:
            upload = self.offload.begin_upload(
                restore_hashes, restore_data,
                [b.idx for b in fresh[: len(restore_hashes)]])
        return seq.cached_prefix, upload

    def _begin_prefill(self, seq: _Sequence, hashes=None) -> bool:
        """Reserve the prompt's pages (its host / disk continuation
        included) and queue the in-flight prefill. False on pool
        pressure."""
        reserved = self._reserve_for_prompt(seq, probe_host=True, hashes=hashes)
        if reserved is None:
            return False
        history, upload = reserved
        self.stats["prefix_cache_hits_tokens"] += history
        self._prefill_states.append(
            _PrefillState(seq=seq, pos=history, upload=upload))
        return True

    async def _prefill_step(self) -> bool:
        """ONE dedicated prefill chunk of the oldest in-flight prompt; on
        its final chunk, sample the first token and join the batch.
        Returns True when the prompt completed."""
        st = self._prefill_states[0]
        seq = st.seq
        if seq.context.is_stopped():
            self._abort_prefill(st, FinishReason.CANCELLED)
            return False
        p0, t0 = st.pos, time.perf_counter()
        try:
            async with self._device_lock:
                first = await asyncio.get_running_loop().run_in_executor(
                    None, self._prefill_chunk_device, st
                )
        except Exception:  # noqa: BLE001 — fail THIS request, keep serving
            logger.exception("prefill failed for request %s", seq.context.id)
            self._abort_prefill(st, FinishReason.ERROR)
            return False
        self._note_prefill_time([(st, st.pos - p0)], time.perf_counter() - t0)
        if first is None:
            return False  # more chunks to go
        self._complete_prefill(st, first)
        return True

    def _note_prefill_time(self, chunks, wall_s: float) -> None:
        """One dispatch that carried prompt chunks [(state, tokens)]: its
        wall time counts toward each prompt's prefill_ms. (The prefill
        rate the cost model advertises comes from dedicated chunks alone,
        timed in _prefill_chunk_device.)"""
        for st, _ in chunks:
            st.ms += wall_s * 1e3

    def _complete_prefill(self, st: _PrefillState, first) -> None:
        seq = st.seq
        self.hist["prefill_ms"].observe(st.ms)
        self._drop_prefill_state(st)
        self._commit_full_blocks(seq)
        self._emit_token(seq, *first)
        if not seq.finished:
            # admission counts in-flight prefills against the batch slots,
            # so a completing prompt always finds one free
            self._place_in_batch(seq)

    def _drop_prefill_state(self, st: _PrefillState) -> None:
        if st in self._prefill_states:
            self._prefill_states.remove(st)

    def _abort_prefill(self, st: _PrefillState, reason: FinishReason,
                       text: Optional[str] = None) -> None:
        """The one teardown of an in-flight prefill (cancellation, device
        failure and the drain's handoff, whose ``text`` is the migration
        signal; dedicated and mixed paths): drop the state, free the
        blocks, hand the reserved host chain back, end the stream."""
        seq = st.seq
        self._drop_prefill_state(st)
        self.allocator.free(seq.blocks)
        seq.blocks = []
        self._rollback_upload(st)
        seq.out_queue.put_nowait(LLMEngineOutput(finish_reason=reason, text=text))

    def _rollback_upload(self, st: _PrefillState) -> None:
        """Record an abandoned upload (if it never landed) and return the
        reserved chain's entries to the host pool (the upload only reads
        them, so this is safe mid-flight)."""
        if self.offload is None or st.upload is None:
            return
        if not st.restored:
            self.offload.cancel_upload(st.upload)
        self.offload.unreserve(st.upload.hashes, st.upload.data)

    def _prefill_chunk_device(self, st: _PrefillState):
        """Executor thread: land the tiers (the preamble), then one bucketed
        chunk. The chunk's own time, after the preamble, is the cost model's
        prefill observation: on the card, CUDA events around the chunk,
        read when they completed (no sync of their own: the final chunk's
        sample syncs); on the CPU, the host clock. Returns (token,
        lp_entry) on the final chunk, else None."""
        self._offload_preamble(st.upload if not st.restored else None)
        st.restored = True
        self._observe_chunk_events()
        timed = self.cost is not None
        on_card = timed and self.device.type == "cuda"
        p0, t_c = st.pos, time.perf_counter()
        if on_card:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        logits, st.pos = self._run_one_chunk(st.seq, st.pos)
        if timed and st.pos > p0:
            if on_card:
                ev[1].record()
                self._chunk_events.append((st.pos - p0, *ev))
            else:
                self.cost.observe_prefill(
                    st.pos - p0, max(time.perf_counter() - t_c, 1e-9))
        if st.pos < len(st.seq.tokens):
            return None
        first = self._sample_prefill(st.seq, logits)
        self._observe_chunk_events()
        return first

    def _observe_chunk_events(self) -> None:
        """Fold every timed chunk whose end event completed into the cost
        model, oldest first (never waits)."""
        q = self._chunk_events
        while q and q[0][2].query():
            tokens, start, end = q.popleft()
            self.cost.observe_prefill(
                tokens, max(start.elapsed_time(end) / 1e3, 1e-9))

    def _run_one_chunk(self, seq: _Sequence, pos: int):
        """One bucketed prefill chunk of ``seq`` from ``pos``: returns (the
        last position's logits, the next position)."""
        cfg = self.cfg
        chunk = seq.tokens[pos : pos + cfg.prefill_chunk]
        toks = np.zeros(_bucket(len(chunk)), np.int32)
        toks[: len(chunk)] = chunk
        out = self._timed(("prefill", len(toks), False), lambda: llama.prefill(
            self.params, cfg.model, self._dev(toks), self._dev(self._table_for(seq)),
            pos, len(chunk), self.k_cache, self.v_cache,
            **self._scale_kwargs(),
        ))
        if self.k_scales is not None:
            self._note_quant_step(None, len(chunk))
        self.stats["prefill_chunks"] += 1
        return out[0], pos + len(chunk)

    # ---- the KV tiers ----

    def _offload_preamble(self, upload: Optional[RestoreUpload] = None) -> None:
        """Before a prefill chunk or a mixed step (executor thread): launch
        the gather of every pending eviction ahead of the compute that may
        overwrite those pages, then land the reserved chain's upload with
        one scatter (waiting only if the copy has not arrived). The landed
        pages were allocated fresh and queued for a scale reset: the resets
        go first, so the scales the scatter lands stay (an int8 device
        cache adopting an int8 tier's scales)."""
        if self.offload is None:
            return
        self.offload.flush_evictions_async(self.k_cache, self.v_cache)
        if upload is not None:
            self._flush_scale_resets()
            t0 = time.perf_counter()
            self.offload.finish_upload(self.k_cache, self.v_cache, upload)
            self.hist["restore_ms"].observe((time.perf_counter() - t0) * 1e3)

    def _flush_evictions_budgeted(self) -> None:
        """Before a decode window or a verify (executor thread, before the
        graph replay launches): at most ``offload_flush_budget`` optional
        blocks, but every pending eviction whose page is in the live block
        tables (a page this dispatch may write) flushes now."""
        if self.offload is None or not self.offload.has_pending():
            return
        must = set(np.unique(self._block_tables).tolist())
        must.discard(0)
        self.offload.flush_evictions_async(
            self.k_cache, self.v_cache,
            budget=self.offload.flush_budget, must_idxs=must,
        )

    async def _offload_prejoin(self, hashes: list[int]) -> None:
        """Before the loop's host-tier probe: launch any pending eviction
        gathers (under the device lock, so they stay stream-ordered before
        later compute), wait OFF the loop for in-flight flushes holding
        ``hashes``, and promote the chain's disk continuation to the host
        staging area off the loop."""
        off = self.offload
        if off is None or not off.async_tier or not hashes:
            return
        off.flush_dropped()
        loop = asyncio.get_running_loop()
        if off.has_pending():
            async with self._device_lock:
                await loop.run_in_executor(
                    None, off.flush_evictions_async, self.k_cache, self.v_cache)
        if off.has_inflight_flushes():
            await loop.run_in_executor(None, off._join_flushes_for, hashes)
        if off.disk is not None:
            await loop.run_in_executor(None, off.promote_chain, hashes)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ---- programs: the ledger and the graphs ----

    def _timed(self, key: tuple, dispatch, cold: Optional[bool] = None,
               graph: tuple = ()):
        """Run a device dispatch; the first of its program ``key`` (the
        reference's ``(kind, *bucket shape)`` tuple), or the dispatch the
        caller calls ``cold`` (the first of a graph), is timed to the end
        of its device work into the ledger."""
        if cold is None:
            cold = key not in self._compiled_keys
        t0 = time.perf_counter()
        out = dispatch()
        if cold:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._note_compile(key, (time.perf_counter() - t0) * 1e3, graph)
        return out

    def _note_compile(self, key: tuple, wall_ms: float, graph: tuple = ()) -> None:
        """First dispatch of a program key, or of one of its graphs
        (``graph``: the host flags that tell them apart): ledger it (the
        reference's ``_note_compile``). ``ms`` is what that dispatch cost:
        kernel builds, the eager run and, for a decode window or a verify,
        its CUDA graph's capture."""
        self._compiled_keys.add(key)
        entry = {"kind": key[0], "key": list(key[1:]), "ms": round(wall_ms, 3)}
        if graph:
            entry["graph"] = list(graph)
        self.compile_ledger.append(entry)
        if len(self.compile_ledger) > 512:
            del self.compile_ledger[:-256]
        self.stats["xla_compiles_total"] += 1
        self.stats["xla_compile_ms_total"] += wall_ms
        if wall_ms > 1000.0:
            logger.info("first dispatch: %s %s took %.0f ms",
                        key[0], key[1:], wall_ms)

    def _run_program(self, key: tuple, graph_key: tuple, program, holds):
        """A decode window or a verify: its graph replayed, or run and
        captured on the graph key's first dispatch, which is ledgered
        under ``key`` with the graph's host flags."""
        return self._timed(key, lambda: self._graphs.run(graph_key, program, holds),
                           cold=graph_key not in self._graphs.dispatched,
                           graph=graph_key[len(key):])

    def _host_flags(self) -> tuple[bool, bool]:
        """(any row sampled, any row filtered by top-k / top-p; the filter
        matters only where a row samples), from the host arrays of every
        slot: what a graph's capture must decide."""
        sampled = bool((self._temps > 0.0).any())
        return sampled, sampled and bool(
            ((self._top_ks > 0) | (self._top_ps < 1.0)).any())

    def _load_static(self, steps: np.ndarray, penalized: bool) -> dict:
        """The batch's host state into the static device inputs."""
        arrays = dict(
            last_tokens=self._last_tokens,
            positions=np.maximum(self._seq_lens - 1, 0),
            block_tables=self._block_tables, seq_lens=self._seq_lens,
            seeds=self._seeds, steps=steps, temps=self._temps,
            top_ks=self._top_ks, top_ps=self._top_ps,
        )
        if penalized:
            arrays.update(freq_pens=self._freq_pens, pres_pens=self._pres_pens,
                          rep_pens=self._rep_pens)
        return self._static.load(**arrays)

    def _state(self, s: dict, penalized: bool) -> tuple[dict, tuple]:
        """(keyword arguments, state tensors) a program reads besides the
        static inputs: penalty vectors and buffers, scale planes (recycled
        pages reset first)."""
        kw = {}
        if penalized:
            kw.update(freq_pens=s["freq_pens"], pres_pens=s["pres_pens"],
                      rep_pens=s["rep_pens"], counts=self._pen_counts,
                      prompt_mask=self._pen_mask)
        kw.update(self._scale_kwargs())
        holds = (self.k_cache, self.v_cache) + tuple(
            kw[k] for k in ("counts", "prompt_mask", "k_scales", "v_scales")
            if k in kw)
        return kw, holds

    def _decode_program(self, steps: np.ndarray, n: int, penalized: bool,
                        want_lp: bool):
        """(ledger key, graph key, program, state it holds) of an n-step
        decode window over the engine's host state, loaded into the static
        inputs."""
        s = self._load_static(steps, penalized)
        sampled, filtered = self._host_flags()
        kw, holds = self._state(s, penalized)
        key = ("decode", n, penalized, want_lp)

        def program():
            return llama.decode_window(
                self.params, self.cfg.model, s["last_tokens"], s["positions"],
                s["block_tables"], s["seq_lens"], s["seeds"], s["steps"],
                s["temps"], s["top_ks"], s["top_ps"], self.k_cache,
                self.v_cache, n_steps=n, with_logprobs=want_lp,
                sampled=sampled, filtered=filtered, **kw)

        return key, key + (sampled, filtered), program, holds

    def _verify_program(self, window: np.ndarray, proposals: np.ndarray,
                        steps: np.ndarray, penalized: bool, want_lp: bool):
        """As :meth:`_decode_program`, for a verify of ``proposals.shape[1]``
        proposals per row (acceptance always filters: no ``filtered``)."""
        B, g = proposals.shape
        if self._verify_static is None:  # an engine verifies one gamma
            self._verify_static = StaticInputs(self.device, {
                "window": ((B, g + 1), np.int32),
                "proposals": ((B, g), np.int32)})
        s = self._load_static(steps, penalized)
        v = self._verify_static.load(window=window, proposals=proposals)
        sampled, _ = self._host_flags()
        kw, holds = self._state(s, penalized)
        key = ("verify", g, penalized, want_lp)

        def program():
            return llama.verify_window(
                self.params, self.cfg.model, v["window"], v["proposals"],
                s["positions"], s["block_tables"], s["seq_lens"], s["seeds"],
                s["steps"], s["temps"], s["top_ks"], s["top_ps"],
                self.k_cache, self.v_cache, n_spec=g, with_logprobs=want_lp,
                sampled=sampled, **kw)

        return key, key + (sampled,), program, holds

    def _table_for(self, seq: _Sequence) -> np.ndarray:
        t = np.zeros(self.cfg.max_blocks_per_seq, np.int32)
        for i, b in enumerate(seq.blocks[: self.cfg.max_blocks_per_seq]):
            t[i] = b.idx
        return t

    def _sample_prefill(self, seq: _Sequence, logits: torch.Tensor):
        """Sample the first token from the prefill logits with full penalty
        semantics (prompt mask and output counts rebuilt from the token
        lists, so a preemption replay draws from the same distribution a
        decode window would). Returns (token, logprob entry or None)."""
        so = seq.request.sampling_options
        temp = so.temperature if so.temperature is not None else 1.0
        seed = (so.seed or 0) & 0x7FFFFFFF
        keys = (make_keys([seed], [seq.generated], self.device)
                if temp > 0.0 else None)

        def f32(x):
            return torch.tensor([x], dtype=torch.float32, device=self.device)

        tok = sample_first_token(
            logits[None], keys, f32(temp),
            torch.tensor([so.top_k or 0], dtype=torch.int32, device=self.device),
            f32(so.top_p if so.top_p is not None else 1.0),
            f32(so.frequency_penalty or 0.0), f32(so.presence_penalty or 0.0),
            f32(so.repetition_penalty or 1.0),
            self._dev(np.asarray(seq.tokens[: seq.prompt_len], np.int64)),
            self._dev(np.asarray(seq.tokens[seq.prompt_len :], np.int64)),
        )
        token = int(tok[0])
        entry = None
        k = min(so.logprobs, 20) if so.logprobs is not None else -1
        if k >= 0:
            chosen, top_ids, top_lps = token_logprobs(logits[None], tok)
            ids, lps = top_ids[0].tolist(), top_lps[0].tolist()
            entry = {
                "logprob": float(chosen[0]),
                "top": [[int(ids[j]), float(lps[j])] for j in range(k)],
            }
        return token, entry

    def _place_in_batch(self, seq: _Sequence) -> None:
        slot = self._active.index(None)
        seq.slot = slot
        self._active[slot] = seq
        self._n_active += 1
        so = seq.request.sampling_options
        self._block_tables[slot] = self._table_for(seq)
        self._seq_lens[slot] = seq.seq_len
        self._last_tokens[slot] = seq.tokens[-1]
        self._seeds[slot] = (so.seed or 0) & 0x7FFFFFFF
        self._temps[slot] = so.temperature if so.temperature is not None else 1.0
        self._top_ks[slot] = so.top_k or 0
        self._top_ps[slot] = so.top_p if so.top_p is not None else 1.0
        self._freq_pens[slot] = so.frequency_penalty or 0.0
        self._pres_pens[slot] = so.presence_penalty or 0.0
        self._rep_pens[slot] = so.repetition_penalty or 1.0
        self._logprob_ks[slot] = (
            min(so.logprobs, 20) if so.logprobs is not None else -1
        )
        if self._slot_has_penalty(slot):
            self._reset_penalty_slot(slot, seq)

    def _slot_has_penalty(self, i: int) -> bool:
        return (
            self._freq_pens[i] != 0.0
            or self._pres_pens[i] != 0.0
            or self._rep_pens[i] != 1.0
        )

    def _penalties_active(self) -> bool:
        return self._pen_counts is not None and any(
            self._slot_has_penalty(i)
            for i, s in enumerate(self._active) if s is not None
        )

    def _logprobs_active(self) -> bool:
        return any(
            self._logprob_ks[i] >= 0
            for i, s in enumerate(self._active) if s is not None
        )

    def _ensure_penalty_buffers(self) -> None:
        """The [B, V] output counts and prompt mask, made on first use and
        then only updated in place (a penalized graph holds them)."""
        B, V = self.cfg.max_batch_size, self.cfg.model.vocab_size
        if self._pen_counts is None:
            self._pen_counts = torch.zeros((B, V), dtype=torch.int32, device=self.device)
            self._pen_mask = torch.zeros((B, V), dtype=torch.bool, device=self.device)

    def _reset_penalty_slot(self, slot: int, seq: _Sequence) -> None:
        """Rebuild one slot's output counts and prompt mask (repetition
        penalty covers prompt + output tokens)."""
        V = self.cfg.model.vocab_size
        self._ensure_penalty_buffers()
        gen = self._dev(np.asarray(seq.tokens[seq.prompt_len :], np.int64))
        self._pen_counts[slot] = torch.bincount(gen, minlength=V).to(torch.int32)
        self._pen_mask[slot] = False
        self._pen_mask[slot, self._dev(np.asarray(seq.tokens[: seq.prompt_len], np.int64))] = True

    # ---- scheduling policy ----

    def _mixed_fusable(self) -> bool:
        """Can the in-flight prefills' next chunks fuse into one mixed step?
        Needs something to fuse WITH: a live decode batch, or at least two
        prompts packing together (a lone prompt with nothing decoding runs
        the dedicated prefill program)."""
        return (
            bool(self._prefill_states)
            and (self._n_active > 0 or len(self._prefill_states) > 1)
        )

    def _pick_window(self) -> int:
        """1 while actionable admission work is pending, else the largest
        power of two within every active sequence's stop/context headroom
        (waiting requests that cannot admit right now don't count)."""
        batch_full = self._n_active >= self.cfg.max_batch_size
        actionable = (
            (bool(self._prefill_states) and not self._mixed_fusable())
            or (not self._waiting_is_empty() and not batch_full
                and not self._backpressured)
            or (bool(self._remote_ready) and not batch_full)
        )
        if actionable or self.cfg.decode_window <= 1:
            return 1
        headroom = self.cfg.decode_window
        for seq in self._active:
            if seq is None:
                continue
            headroom = min(headroom, self.cfg.max_context - seq.seq_len)
            sc = seq.request.stop_conditions
            if sc.max_tokens is not None:
                headroom = min(headroom, sc.max_tokens - seq.generated)
        n = 1
        while n * 2 <= headroom and n * 2 <= self.cfg.decode_window:
            n *= 2
        return n

    def _preempt(self, seq: _Sequence) -> None:
        """Evict a running sequence under pool pressure (recompute flavor):
        its full blocks stay claimable by hash, so re-admission re-claims
        the prefix and recomputes only the tail — never silent
        truncation."""
        self._release_slot(seq)
        self.allocator.free(seq.blocks)
        seq.blocks = []
        seq.committed = 0
        seq.parent_hash = None
        seq.cached_prefix = 0
        self._waiting_front.appendleft(seq)
        self.stats["preemptions"] += 1
        logger.info("preempted request %s at %d tokens (pool pressure)",
                    getattr(seq.context, "id", "?"), seq.seq_len)

    def _youngest_active(self) -> Optional[_Sequence]:
        cand = [s for s in self._active if s is not None and not s.finished]
        return max(cand, key=lambda s: s.arrival_t) if cand else None

    def _evict_for_headroom(self, seq: _Sequence) -> bool:
        """Pool exhausted while growing ``seq``: preempt the youngest active
        sequence (possibly ``seq``), or LENGTH-finish ``seq`` when nothing
        else is left. Returns True when ``seq`` itself was removed."""
        victim = self._youngest_active()
        if victim is seq or victim is None:
            if self._n_active <= 1:
                logger.warning("KV pool too small for request %s at %d tokens",
                               getattr(seq.context, "id", "?"), seq.seq_len)
                self._finish(seq, FinishReason.LENGTH)
            else:
                self._preempt(seq)
            return True
        self._preempt(victim)
        return False

    def _provision(self, n: int) -> None:
        """Blocks for ``n`` more tokens of every active sequence (growing
        through preemption when the pool is short); cancels and context
        limits finish here."""
        cfg = self.cfg
        for seq in list(self._active):
            if seq is None or seq.finished or seq.slot < 0:
                continue
            if seq.context.is_stopped():
                self._finish(seq, FinishReason.CANCELLED)
                continue
            while (
                seq.seq_len + n > len(seq.blocks) * cfg.block_size
                and seq.slot >= 0
                and not seq.finished
            ):
                if len(seq.blocks) >= cfg.max_blocks_per_seq:
                    self._finish(seq, FinishReason.LENGTH)
                    break
                extra = self.allocator.allocate(1)
                if extra is not None:
                    seq.blocks.extend(extra)
                    self._block_tables[seq.slot] = self._table_for(seq)
                    continue
                if self._evict_for_headroom(seq):
                    break

    async def _decode_once(self) -> None:
        if self._mixed_fusable():
            await self._mixed_step_once()
            return
        n = self._pick_window()
        self._provision(n)
        if self._n_active == 0:
            return
        # speculative decoding: batches with an n-gram match verify
        # spec_gamma proposals in one fused forward instead of a decode
        # window; it bails to the window when blocks are short or nothing
        # matched. Not with the int8-with-scales cache: the verify forward
        # has no scale-plane stream (warned at init).
        if (
            self.cfg.spec_gamma > 0
            and n > 1
            and not self._prefill_states
            and self.k_scales is None
        ):
            proposals = self._propose_ngram()
            if proposals is not None and await self._spec_verify_once(proposals):
                return
        # a preemption may have made admission actionable: never grow past
        # what was provisioned
        n = min(n, self._pick_window())
        steps = np.asarray(
            [s.generated if s else 0 for s in self._active], np.int64
        )
        slots = {i: s for i, s in enumerate(self._active) if s is not None}
        async with self._device_lock:
            toks, lps = await asyncio.get_running_loop().run_in_executor(
                None, self._dispatch_window, steps, n
            )
        self._emit_window(toks, lps, n, slots)

    def _propose_ngram(self) -> Optional[np.ndarray]:
        """Prompt-lookup drafts: match each sequence's trailing n-gram
        against its own earlier tokens and propose the continuation that
        followed last time. Returns [B, gamma] with -1 padding (never
        matches a real token id), or None when no slot produced a
        proposal."""
        g, ng = self.cfg.spec_gamma, self.cfg.spec_ngram
        out = np.full((self.cfg.max_batch_size, g), -1, np.int64)
        found = False
        for i, seq in enumerate(self._active):
            if seq is None or seq.finished:
                continue
            toks = seq.tokens
            if len(toks) < ng + 2:
                continue
            # vectorized sliding match over a bounded tail window
            arr = np.asarray(toks[-4097:], np.int64)
            key = arr[-ng:]
            hay = arr[:-1]  # a match ending at the tail itself is useless
            hits = hay[: len(hay) - ng + 1] == key[0]
            for k in range(1, ng):
                hits &= hay[k : len(hay) - ng + 1 + k] == key[k]
            idx = np.flatnonzero(hits)
            # the most recent occurrence BEFORE the trailing one
            idx = idx[idx < len(arr) - ng]
            if idx.size == 0:
                continue
            j = int(idx[-1])
            cont = arr[j + ng : j + ng + g]
            if cont.size:
                out[i, : cont.size] = cont
                found = True
        return out if found else None

    async def _spec_verify_once(self, proposals: np.ndarray) -> bool:
        """One fused verify of gamma proposals + bonus token per slot.
        Returns False (the caller falls back to a plain window) when block
        headroom for the in-flight rows isn't available without preempting
        — speculation never causes a preemption."""
        cfg = self.cfg
        g = cfg.spec_gamma
        T = g + 1
        if T > cfg.block_size:
            return False  # in-flight rows must fit a page (the append)
        for seq in list(self._active):
            if seq is None or seq.finished or seq.slot < 0:
                continue
            while seq.seq_len + g > len(seq.blocks) * cfg.block_size:
                if len(seq.blocks) >= cfg.max_blocks_per_seq:
                    return False  # near the context limit: plain windows clamp
                extra = self.allocator.allocate(1)
                if extra is None:
                    return False
                seq.blocks.extend(extra)
                self._block_tables[seq.slot] = self._table_for(seq)
        # window tokens: last accepted token + proposals (-1 -> 0 for a safe
        # embed; acceptance reads the ORIGINAL -1s, which never accept)
        window = np.zeros((cfg.max_batch_size, T), np.int32)
        window[:, 0] = self._last_tokens
        window[:, 1:] = np.maximum(proposals, 0)
        steps = np.asarray(
            [s.generated if s else 0 for s in self._active], np.int64
        )
        async with self._device_lock:
            out_toks, n_accs, lps = await asyncio.get_running_loop().run_in_executor(
                None, self._dispatch_verify, window,
                proposals.astype(np.int32), steps,
            )
        self.stats["decode_steps"] += 1
        for i, seq in list(enumerate(self._active)):
            if seq is None or seq.finished:
                continue
            n_acc = int(n_accs[i])
            self.stats["spec_proposed"] += int((proposals[i] >= 0).sum())
            self.stats["spec_accepted"] += n_acc
            for t in range(n_acc + 1):
                if seq.finished:
                    break
                self._emit_token(seq, int(out_toks[i, t]), self._lp_entry(lps, i, t))
            if seq.finished or self._active[i] is not seq:
                continue
            self._seq_lens[i] = seq.seq_len
            self._last_tokens[i] = seq.tokens[-1]
            # the last emitted token's KV lands with the NEXT dispatch
            self._commit_full_blocks(seq, written_len=seq.seq_len - 1)
        return True

    def _dispatch_verify(self, window: np.ndarray, proposals: np.ndarray,
                         steps: np.ndarray):
        """Executor thread: fused verify forward + on-device acceptance (a
        replayed CUDA graph on the card). Returns (out_tokens [B, T], n_acc
        [B], logprob arrays [T, B, ...] or None) as host arrays."""
        want_lp = self._logprobs_active()
        self._flush_evictions_budgeted()
        out = self._run_program(*self._verify_program(
            window, proposals, steps, self._penalties_active(), want_lp))
        lps = None
        if want_lp:  # step-major, as _lp_entry reads a window's arrays
            lps = tuple(a.transpose(0, 1).cpu().numpy() for a in out[-1])
        return out[0].cpu().numpy(), out[1].cpu().numpy(), lps

    def _sampling_tensors(self):
        return (
            self._dev(self._temps), self._dev(self._top_ks), self._dev(self._top_ps)
        )

    def _penalty_kwargs(self) -> dict:
        if not self._penalties_active():
            return {}
        return dict(
            freq_pens=self._dev(self._freq_pens),
            pres_pens=self._dev(self._pres_pens),
            rep_pens=self._dev(self._rep_pens),
            counts=self._pen_counts,
            prompt_mask=self._pen_mask,
        )

    def _dispatch_window(self, steps: np.ndarray, n: int):
        """Executor thread: one n-step decode window (a replayed CUDA graph
        on the card). Returns (tokens [n, B] host array, logprob host
        arrays or None)."""
        cfg = self.cfg
        for seq in self._active:
            if seq is None or seq.finished or seq.slot < 0:
                continue
            if seq.seq_len + n > len(seq.blocks) * cfg.block_size:
                raise RuntimeError(
                    f"window n={n} exceeds provisioned blocks for request "
                    f"{getattr(seq.context, 'id', '?')}"
                )
        want_lp = self._logprobs_active()
        self._flush_evictions_budgeted()
        out = self._run_program(*self._decode_program(
            steps, n, self._penalties_active(), want_lp))
        if self.k_scales is not None:
            self._note_quant_step(out[5], self._n_active * n,
                                  gen_tokens=self._n_active * n)
        lps = out[-1] if want_lp else None
        return out[0].cpu().numpy(), (
            tuple(a.cpu().numpy() for a in lps) if lps is not None else None
        )

    def _emit_window(self, toks: np.ndarray, lps, n: int, slots: dict) -> None:
        """Emit window tokens in step order; a sequence that stops mid-window
        drops its tail, and a slot that changed hands gets nothing."""
        self.stats["decode_steps"] += n
        self.stats["decode_windows"] += 1
        live = [(i, s) for i, s in slots.items()
                if self._active[i] is s and not s.finished]
        for step_i in range(n):
            for i, seq in live:
                if seq.finished:
                    continue
                self._emit_token(seq, int(toks[step_i, i]),
                                 self._lp_entry(lps, i, step_i))
        for i, seq in live:
            if seq.finished:
                continue
            self._seq_lens[i] = seq.seq_len
            self._last_tokens[i] = seq.tokens[-1]
            # the last sampled token's KV lands with the NEXT dispatch
            self._commit_full_blocks(seq, written_len=seq.seq_len - 1)

    def _lp_entry(self, lps, i: int, step_i: Optional[int] = None):
        k = int(self._logprob_ks[i])
        if lps is None or k < 0:
            return None
        chosen, top_ids, top_lps = (
            lps if step_i is None else tuple(a[step_i] for a in lps)
        )
        return {
            "logprob": float(chosen[i]),
            "top": [[int(top_ids[i, j]), float(top_lps[i, j])] for j in range(k)],
        }

    # ---- fused mixed step ----

    async def _mixed_step_once(self) -> None:
        """ONE fused step: the ``mixed_step_budget`` token budget packed
        across every in-flight prefill plus one decode token for every
        active sequence."""
        cfg = self.cfg
        for st in list(self._prefill_states):
            if st.seq.context.is_stopped():
                self._abort_prefill(st, FinishReason.CANCELLED)
        if not self._prefill_states:
            return
        self._provision(1)
        if self._n_active == 0 and len(self._prefill_states) < 2:
            return  # a lone prefill: the dedicated program is cheaper
        packed = self._split_mixed_budget()
        steps = np.asarray(
            [s.generated if s else 0 for s in self._active], np.int64
        )
        t0 = time.perf_counter()
        try:
            async with self._device_lock:
                toks, lps, completed = await (
                    asyncio.get_running_loop().run_in_executor(
                        None, self._dispatch_mixed, packed, steps
                    )
                )
            self._note_prefill_time(packed, time.perf_counter() - t0)
        except Exception:  # noqa: BLE001 — not attributable to one prompt
            logger.exception("mixed step failed for requests %s",
                             [st.seq.context.id for st, _ in packed])
            for st in list(self._prefill_states):
                self._abort_prefill(st, FinishReason.ERROR)
            return
        self.stats["decode_steps"] += 1
        self.stats["mixed_steps"] += 1
        self.stats["mixed_prefill_segments"] += len(packed)
        for i, seq in list(enumerate(self._active)):
            if seq is None or seq.finished:
                continue
            self._emit_token(seq, int(toks[i]), self._lp_entry(lps, i))
            if seq.finished or self._active[i] is not seq:
                continue
            self._seq_lens[i] = seq.seq_len
            self._last_tokens[i] = seq.tokens[-1]
            self._commit_full_blocks(seq, written_len=seq.seq_len - 1)
        for st, first in completed:
            self._complete_prefill(st, first)

    def _split_mixed_budget(self) -> list[tuple[_PrefillState, int]]:
        """Every prompt gets a minimum chunk of budget // n_prompts (at
        least 1 token — none starves); the leftover goes to the earliest
        admitted prompts first."""
        sts = self._prefill_states
        budget = self.cfg.mixed_step_budget
        rem = [len(st.seq.tokens) - st.pos for st in sts]
        floor = max(budget // len(sts), 1)
        takes = [min(r, floor) for r in rem]
        left = budget - sum(takes)
        for i in range(len(sts)):
            if left <= 0:
                break
            extra = min(left, rem[i] - takes[i])
            takes[i] += extra
            left -= extra
        return list(zip(sts, takes))

    def _dispatch_mixed(self, packed, steps: np.ndarray):
        """Executor thread: the fused dispatch over MP prefill segments +
        the decode batch. The segment count pads to a power-of-two bucket
        (dead segments: valid 0, zero tables) and every segment shares one
        bucketed length. Returns (decode tokens [B], logprob arrays or
        None, [(state, (first_token, lp_entry))] for prompts that just
        completed)."""
        cfg = self.cfg
        for seq in self._active:
            if seq is None or seq.finished or seq.slot < 0:
                continue
            if seq.seq_len + 1 > len(seq.blocks) * cfg.block_size:
                raise RuntimeError(
                    f"mixed step exceeds provisioned blocks for request "
                    f"{getattr(seq.context, 'id', '?')}"
                )
        # land each prompt's reserved host chain (its first step only);
        # the eviction flush is shared across the pack
        for st, _take in packed:
            self._offload_preamble(st.upload if not st.restored else None)
            st.restored = True
        MP = _seg_bucket(len(packed))
        T = _bucket(max(take for _st, take in packed))
        toks_p = np.zeros((MP, T), np.int32)
        tables_p = np.zeros((MP, cfg.max_blocks_per_seq), np.int32)
        hists_p = np.zeros(MP, np.int32)
        valids_p = np.zeros(MP, np.int32)
        for i, (st, take) in enumerate(packed):
            chunk = st.seq.tokens[st.pos : st.pos + take]
            toks_p[i, : len(chunk)] = chunk
            tables_p[i] = self._table_for(st.seq)
            hists_p[i] = st.pos
            valids_p[i] = len(chunk)
        positions = np.maximum(self._seq_lens - 1, 0).astype(np.int32)
        penalized, want_lp = self._penalties_active(), self._logprobs_active()
        sampled, filtered = self._host_flags()
        out = self._timed(("mixed", MP, T, penalized, want_lp), lambda: llama.mixed_step(
            self.params, cfg.model, self._dev(self._last_tokens),
            self._dev(positions), self._dev(self._block_tables),
            self._dev(self._seq_lens), self._seeds, steps,
            *self._sampling_tensors(), self._dev(toks_p), self._dev(tables_p),
            self._dev(hists_p), self._dev(valids_p), self.k_cache, self.v_cache,
            with_logprobs=want_lp, sampled=sampled, filtered=filtered,
            **self._penalty_kwargs(), **self._scale_kwargs(),
        ))
        toks, p_logits = out[0], out[1]
        if self.k_scales is not None:
            self._note_quant_step(
                out[6], self._n_active + int(valids_p.sum()),
                gen_tokens=self._n_active)
        completed = []
        for i, (st, take) in enumerate(packed):
            st.pos += take
            if st.pos >= len(st.seq.tokens):
                completed.append((st, self._sample_prefill(st.seq, p_logits[i])))
        lps = out[-1] if want_lp else None
        return toks.cpu().numpy(), (
            tuple(a.cpu().numpy() for a in lps) if lps is not None else None
        ), completed

    # ---- token emission + finish logic ----

    def _emit_token(self, seq: _Sequence, token: int, lp_entry=None) -> None:
        req = seq.request
        sc = req.stop_conditions
        seq.tokens.append(token)
        seq.generated += 1
        self.stats["tokens_generated"] += 1
        if seq.generated == 1:  # arrival -> first token, the base model's
            self.hist_ttft.setdefault("", Histogram(MS_BUCKETS)).observe(
                (time.monotonic() - seq.arrival_t) * 1e3)
        finish: Optional[FinishReason] = None
        min_ok = seq.generated >= (sc.min_tokens or 0)
        if token in (sc.stop_token_ids or []):
            finish = FinishReason.STOP
        elif not sc.ignore_eos and token in (req.eos_token_ids or []) and min_ok:
            finish = FinishReason.EOS
        elif sc.max_tokens is not None and seq.generated >= sc.max_tokens:
            finish = FinishReason.LENGTH
        elif seq.seq_len >= self.cfg.max_context:
            finish = FinishReason.LENGTH
        elif seq.context.is_stopped():
            finish = FinishReason.CANCELLED
        out = LLMEngineOutput(token_ids=[token])
        if lp_entry is not None:
            out.logprobs = [lp_entry]
        if finish is not None:
            out.finish_reason = finish
            out.prompt_tokens = seq.prompt_len
            out.completion_tokens = seq.generated
            out.kv_overlap_blocks = seq.cached_prefix // self.cfg.block_size
        seq.out_queue.put_nowait(out)
        if finish is not None:
            self._finish(seq, finish, emit=False)

    def _finish(self, seq: _Sequence, reason: FinishReason, emit: bool = True) -> None:
        if seq.finished:
            return
        seq.finished = True
        if emit:
            seq.out_queue.put_nowait(LLMEngineOutput(
                finish_reason=reason, prompt_tokens=seq.prompt_len,
                completion_tokens=seq.generated,
            ))
        self._release_slot(seq)
        self.allocator.free(seq.blocks)
        seq.blocks = []
        self._wake.set()

    def _release_slot(self, seq: _Sequence) -> None:
        if seq.slot >= 0:
            self._active[seq.slot] = None
            self._seq_lens[seq.slot] = 0
            self._block_tables[seq.slot] = 0
            # a free slot is greedy: it leaves the graph's flags to the rest
            self._temps[seq.slot] = 0.0
            self._top_ks[seq.slot] = 0
            self._top_ps[seq.slot] = 1.0
            self._n_active -= 1
            seq.slot = -1

    def _commit_full_blocks(self, seq: _Sequence, written_len: int = -1) -> None:
        """Content-address blocks that just became full AND fully written
        (``written_len`` positions have their KV in the cache)."""
        bs = self.cfg.block_size
        if written_len < 0:
            written_len = seq.seq_len
        full = written_len // bs
        while seq.committed < full and seq.committed < len(seq.blocks):
            i = seq.committed
            seq.parent_hash = self.allocator.commit_full_block(
                seq.blocks[i], seq.tokens[i * bs : (i + 1) * bs], seq.parent_hash
            )
            seq.committed += 1

    # ---------------- the fleet tier: peer serves and hinted prefetch ----------------

    async def export_device_chain(self, seq_hashes: list[int],
                                  max_blocks: int = 128,
                                  with_scales: bool = True) -> tuple:
        """Serve side of the fleet prefix cache, DEVICE tier: the longest
        consecutive run of ``seq_hashes`` resident in the device prefix
        cache, gathered d2h by the block-copy kernel (at most
        ``max_blocks``, under the device lock). Non-destructive: the blocks
        are ref-claimed for the gather (a concurrent eviction cannot
        recycle the pages mid-copy) and released untouched. Returns
        (hashes, k, v, k_scales, v_scales) as CPU tensors. With the int8
        cache and ``with_scales`` the stacks are the device codec verbatim
        (codes + [L, n] scales); without it the codes are dequantized on
        the card before the d2h (counted) and the scales are None, as they
        are for a full-width cache."""
        if not seq_hashes or self._closed:
            return [], None, None, None, None
        claimed = self.allocator.match_prefix(
            (), hashes=[(0, h) for h in seq_hashes[:max_blocks]])
        if not claimed:
            return [], None, None, None, None
        ks = vs = None
        try:
            idxs = [b.idx for b in claimed]
            async with self._device_lock:
                got = await asyncio.get_running_loop().run_in_executor(
                    None, self._gather_device, idxs, False,
                    with_scales and self.k_scales is not None)
        finally:
            self.allocator.free(claimed)
        k, v = got[0], got[1]
        if len(got) > 2:
            ks, vs = got[2], got[3]
        served = list(seq_hashes[: len(claimed)])
        self.stats["peer_serve_d2h_blocks"] += len(served)
        return served, k, v, ks, vs

    def note_export_requant(self, n: int) -> None:
        """``n`` device-codec blocks left the card away from int8 (a
        full-width extract, or a peer serve whose wire codec is not int8)."""
        self.stats["kv_device_export_requant_total"] += n

    def chain_coverage(self, chain: list[int]) -> int:
        """Longest prefix of chained hashes resident in ANY local tier
        (device pool, host pool, staging, disk index): index-only probes.
        A peer pull fetches only the continuation past it."""
        n = 0
        for h in chain:
            if self.allocator.has_hash(h) or (
                    self.offload is not None and self.offload.tier_contains(h)):
                n += 1
                continue
            break
        return n

    async def prefetch_hint(self, blocks: list) -> int:
        """Router-hinted prefetch: ``blocks`` is the routed prompt's chain as
        (local_hash, chained_hash) pairs. Probes the device pool for the
        longest resident prefix, restores the host / disk (or peer-pulled)
        continuation into fresh pages and commits them to the reuse pool,
        so the request's admission claims them as ordinary prefix hits and
        its TTFT never sees the h2d copy. Best-effort: bails without side
        effects under pool pressure or on a cold tier. The host chain is
        read NON-destructively (a request racing its own hint still finds
        it) and dropped only after the device commit. Returns blocks
        landed."""
        if (self.offload is None or not self.cfg.offload_async or not blocks
                or self._closed):
            return 0
        chain = [s for _l, s in blocks]
        await self._offload_prejoin(chain)
        n_dev = 0
        for h in chain:
            if not self.allocator.has_hash(h):
                break
            n_dev += 1
        tail = blocks[n_dev:]
        if not tail:
            return 0
        hashes, data = self.offload.peek_chain([s for _l, s in tail])
        if not hashes:
            return 0
        fresh = self.allocator.allocate(len(hashes))
        if fresh is None:
            return 0
        upload = self.offload.begin_upload(hashes, data, [b.idx for b in fresh])
        loop = asyncio.get_running_loop()
        try:
            # wait out the copy BEFORE taking the device lock (holding it
            # would stall every decode window for the upload), bounded: a
            # wedged executor degrades the hint to a cold restore
            if upload.future is not None:
                await loop.run_in_executor(None, upload.future.result, 30.0)
            async with self._device_lock:
                await loop.run_in_executor(None, self._prefetch_land_device, upload)
        except Exception:  # noqa: BLE001 — prefetch is advisory
            logger.exception("hinted prefetch restore failed")
            self.allocator.free(fresh)
            self.offload.cancel_upload(upload)
            return 0
        # commit the landed pages under their chained hashes and drop the
        # allocation ref: they become claimable prefix blocks. A hash that
        # went device-resident meanwhile is not adopted (its block returns
        # to the free list)
        parent = chain[n_dev - 1] if n_dev else None
        adopted = 0
        for b, (local, seq_hash) in zip(fresh, tail):
            if self.allocator.adopt_restored(b, seq_hash, local, parent):
                b.prefetched = True
                adopted += 1
            parent = seq_hash
        self.allocator.free(fresh)
        self.offload.discard_chain(hashes)
        self.offload.note_prefetch_landed(upload)
        return adopted

    def _prefetch_land_device(self, upload: RestoreUpload) -> None:
        """Executor thread: launch pending evictions that may reference the
        prefetch's pages, reset the fresh pages' scales (before the landing
        adopts a chain's scales), then scatter the landed upload."""
        self.offload.flush_evictions_async(self.k_cache, self.v_cache)
        self._flush_scale_resets()
        self.offload.finish_upload(self.k_cache, self.v_cache, upload,
                                   account=False)

    # ---------------- disaggregation hooks ----------------

    def n_prompt_blocks(self, prompt_len: int) -> int:
        bs = self.cfg.block_size
        return (prompt_len + bs - 1) // bs

    def _remote_sequence(self, req: PreprocessedRequest, context) -> _Sequence:
        prompt = list(req.token_ids)
        return _Sequence(request=req, context=context, out_queue=asyncio.Queue(),
                         tokens=prompt, prompt_len=len(prompt))

    def _prefill_device(self, seq: _Sequence, pos: int):
        """Executor thread: every chunk of ``seq``'s prompt from ``pos``
        (pending evictions launched first), then the first token. Returns
        (token, logprob entry or None)."""
        self._offload_preamble()
        logits = None
        while pos < len(seq.tokens):
            logits, pos = self._run_one_chunk(seq, pos)
        return self._sample_prefill(seq, logits)

    async def prefill_extract(self, req: PreprocessedRequest, context,
                              skip_blocks: int = 0, keep_on_device: bool = False,
                              timings: Optional[dict] = None) -> tuple:
        """Prefill-worker side: compute the prompt's KV (with this worker's
        own prefix cache), sample the first token, and return the prompt's
        KV blocks after ``skip_blocks`` (the decode side's prefix hit),
        gathered by the block-copy kernel. Blocks are committed to the
        reuse pool before they are freed, so repeated prefixes stay warm.
        ``keep_on_device`` returns the gather's CUDA tensors (the local
        pipe), else CPU tensors for the wire. ``timings["gather_ms"]`` gets
        the gather + d2h wall. Returns (first_token, first_lp, k, v)."""
        seq = self._remote_sequence(req, context)
        reserved = self._reserve_for_prompt(seq)
        if reserved is None:
            raise OutOfBlocks(f"cannot cover {len(seq.tokens)}-token prompt")
        history = reserved[0]
        self.stats["prefix_cache_hits_tokens"] += history
        loop = asyncio.get_running_loop()
        try:
            async with self._device_lock:
                first_token, first_lp = await loop.run_in_executor(
                    None, self._prefill_device, seq, history)
                n_prompt = self.n_prompt_blocks(len(seq.tokens))
                idxs = [b.idx for b in seq.blocks[skip_blocks:n_prompt]]
                k = v = None
                if idxs:
                    t_g = time.perf_counter()
                    k, v = await loop.run_in_executor(
                        None, self._gather_device, idxs, keep_on_device)
                    if timings is not None:
                        timings["gather_ms"] = timings.get("gather_ms", 0.0) + (
                            time.perf_counter() - t_g) * 1e3
            self._commit_full_blocks(seq)
        finally:
            self.allocator.free(seq.blocks)
            seq.blocks = []
        return first_token, first_lp, k, v

    async def prefill_extract_stream(self, req: PreprocessedRequest, context,
                                     skip_blocks: int = 0,
                                     keep_on_device: bool = False,
                                     segment_blocks: int = 0, on_segment=None,
                                     timings: Optional[dict] = None) -> tuple:
        """Streamed twin of :meth:`prefill_extract`: the prompt prefills
        chunk by chunk, and every chunk's freshly completed blocks are
        gathered and handed to ``on_segment(b0, k_seg, v_seg)`` the moment
        the chunk's compute finishes, so the caller ships them while the
        next chunk computes. ``b0`` is relative to ``skip_blocks``;
        segments arrive in order and cover [skip_blocks, n_prompt_blocks)
        once. ``segment_blocks`` caps a segment (0 = one per chunk). The
        final segment (the partial last block included) goes out before
        first-token sampling. The device lock is taken per chunk and per
        gather, so concurrent extracts interleave chunk-wise, and the
        segment's backpressure is paid outside the lock. Returns
        (first_token, first_lp, blocks emitted)."""
        seq = self._remote_sequence(req, context)
        reserved = self._reserve_for_prompt(seq)
        if reserved is None:
            raise OutOfBlocks(f"cannot cover {len(seq.tokens)}-token prompt")
        history = reserved[0]
        self.stats["prefix_cache_hits_tokens"] += history
        bs = self.cfg.block_size
        prompt = seq.tokens
        n_prompt = self.n_prompt_blocks(len(prompt))
        sent = skip_blocks
        loop = asyncio.get_running_loop()

        async def emit_upto(full: int) -> None:
            nonlocal sent
            while sent < full:
                hi = min(full, sent + segment_blocks) if segment_blocks > 0 else full
                idxs = [b.idx for b in seq.blocks[sent:hi]]
                t_g = time.perf_counter()
                async with self._device_lock:
                    k_seg, v_seg = await loop.run_in_executor(
                        None, self._gather_device, idxs, keep_on_device)
                if timings is not None:
                    timings["gather_ms"] = timings.get("gather_ms", 0.0) + (
                        time.perf_counter() - t_g) * 1e3
                await on_segment(sent - skip_blocks, k_seg, v_seg)
                sent = hi

        try:
            async with self._device_lock:
                await loop.run_in_executor(None, self._offload_preamble)
            pos = history
            logits = None
            while pos < len(prompt):
                async with self._device_lock:
                    logits, pos = await loop.run_in_executor(
                        None, self._run_one_chunk, seq, pos)
                # blocks whose every position is now written; the final
                # chunk also releases the partial last block
                full = n_prompt if pos >= len(prompt) else min(pos // bs, n_prompt)
                if on_segment is not None and full > sent:
                    await emit_upto(full)
            async with self._device_lock:
                first_token, first_lp = await loop.run_in_executor(
                    None, self._sample_prefill, seq, logits)
            self._commit_full_blocks(seq)
        finally:
            self.allocator.free(seq.blocks)
            seq.blocks = []
        return first_token, first_lp, max(n_prompt - skip_blocks, 0)

    def _gather_device(self, idxs: list[int], keep_on_device: bool = False,
                       with_scales: bool = False):
        """The pages at ``idxs`` as ``[L, H, n, bs, D]`` stacks: one
        ``gather_blocks`` launch, then the d2h copy unless
        ``keep_on_device``. With the int8 cache the gather carries the
        scale planes: ``with_scales=True`` returns the device codec
        verbatim (k, v, k_scales, v_scales); otherwise the codes are
        dequantized to the model's width on the card (one
        ``scatter_blocks_dequant`` launch into a fresh stack), counted in
        ``kv_device_export_requant_total``."""
        idx = self._dev(np.asarray(idxs, np.int32))
        if self.k_scales is None:
            out = block_copy.gather_blocks(self.k_cache, self.v_cache, idx)
        else:
            out = block_copy.gather_blocks(self.k_cache, self.v_cache, idx,
                                           self.k_scales, self.v_scales)
            if not with_scales:
                self.note_export_requant(len(idxs))
                out = self._dequant_stack(*out)
        if keep_on_device:
            return out
        return tuple(t.cpu() for t in out)

    def _dequant_stack(self, k, v, ks, vs) -> tuple:
        """int8 code stacks times their [L, n] scales in the model's width,
        landed by the dequantizing scatter into fresh stacks."""
        dt = llama._dtype(self.cfg.model)
        n = k.shape[2]
        out_k = torch.empty(k.shape, dtype=dt, device=k.device)
        out_v = torch.empty(v.shape, dtype=dt, device=v.device)
        ar = torch.arange(n, dtype=torch.int32, device=k.device)
        block_copy.scatter_blocks_dequant(out_k, out_v, ar, k, v, ks, vs)
        return out_k, out_v

    def begin_remote(self, request: Context) -> Optional[RemoteHandle]:
        """Decode side, before a remote prefill is enqueued: match the local
        prefix cache and allocate the sequence's pages up front. None when
        the request should serve locally instead (empty, too long, out of
        vocab, or the pool cannot cover it)."""
        req = request.data
        if isinstance(req, dict):
            req = PreprocessedRequest.from_dict(req)
        prompt = list(req.token_ids)
        V = self.cfg.model.vocab_size
        if (not prompt or len(prompt) >= self.cfg.max_context
                or not all(0 <= t < V for t in prompt)):
            return None
        seq = self._remote_sequence(req, request.context)
        if self._reserve_for_prompt(seq) is None:
            return None
        self.stats["requests_total"] += 1
        self.stats["prompt_tokens_total"] += seq.prompt_len
        return RemoteHandle(seq=seq, skip_blocks=seq.committed,
                            n_prompt_blocks=self.n_prompt_blocks(len(prompt)))

    def release_remote(self, handle: RemoteHandle) -> None:
        """Local prefill chosen after begin_remote: return the pages
        untouched (no output emitted; the caller resubmits locally)."""
        self.stats["requests_total"] -= 1
        self.stats["prompt_tokens_total"] -= handle.seq.prompt_len
        self.allocator.free(handle.seq.blocks)
        handle.seq.blocks = []

    async def complete_remote(self, handle: RemoteHandle, first_token: int,
                              k_data, v_data, first_lp: Optional[dict] = None,
                              k_scales=None, v_scales=None) -> asyncio.Queue:
        """The prefill worker's KV arrived: land a bulk delivery (a
        streamed one already landed segment by segment) into the reserved
        pages, emit the first token it sampled (with its logprob entry)
        and queue the sequence for the decode batch. ``k_scales`` /
        ``v_scales`` ([L, n] f32) mark a quantized wire delivery."""
        seq = handle.seq
        if k_data is not None and k_data.shape[2]:
            n = int(k_data.shape[2])
            idxs = [b.idx for b in seq.blocks[handle.skip_blocks:handle.skip_blocks + n]]
            async with self._device_lock:
                await asyncio.get_running_loop().run_in_executor(
                    None, self._scatter_device, idxs, k_data, v_data,
                    k_scales, v_scales)
        self.stats["prefix_cache_hits_tokens"] += seq.cached_prefix
        self._emit_token(seq, first_token, first_lp)
        if not seq.finished:
            self._commit_full_blocks(seq, written_len=seq.seq_len - 1)
            self._remote_ready.append(seq)
            self._wake.set()
        return seq.out_queue

    async def scatter_remote_segment(self, handle: RemoteHandle, b0: int,
                                     k_data, v_data, k_scales=None,
                                     v_scales=None) -> None:
        """Streamed landing: scatter ONE segment's blocks into the
        reservation the moment it arrives. ``b0`` is relative to the
        handle's skip_blocks. A redelivered stream scatters again over the
        same uncommitted pages."""
        seq = handle.seq
        n = int(k_data.shape[2])
        if n == 0:
            return
        blocks = seq.blocks[handle.skip_blocks + b0:handle.skip_blocks + b0 + n]
        if seq.finished or len(blocks) != n:
            raise RuntimeError(
                f"remote segment [{b0}, {b0 + n}) outside the live "
                f"reservation of {getattr(seq.context, 'id', '?')}")
        async with self._device_lock:
            await asyncio.get_running_loop().run_in_executor(
                None, self._scatter_device, [b.idx for b in blocks], k_data,
                v_data, k_scales, v_scales)

    def abort_remote(self, handle: RemoteHandle, message: str = "") -> None:
        seq = handle.seq
        self.allocator.free(seq.blocks)
        seq.blocks = []
        seq.finished = True
        seq.out_queue.put_nowait(
            LLMEngineOutput(finish_reason=FinishReason.ERROR, text=message or None))

    def _scatter_device(self, idxs: list[int], k_data, v_data,
                        k_scales=None, v_scales=None) -> None:
        """Executor thread: land delivered stacks (CPU or CUDA) at ``idxs``
        in place, one block-copy launch. Pending evictions that may
        reference these pages are launched first, then the fresh pages'
        scale resets (so scales a landing adopts stay). The int8 cache
        adopts a matching int8 wire payload verbatim and requantizes
        anything else; a full-width or fp8 cache takes full-width stacks as
        they are (cast to its dtype) and dequantizes quantized ones."""
        if self.offload is not None:
            self.offload.flush_evictions_async(self.k_cache, self.v_cache)
        self._flush_scale_resets()
        idx = self._dev(np.asarray(idxs, np.int32))
        k, v = k_data.to(self.device), v_data.to(self.device)
        ks = vs = None
        if k_scales is not None:
            ks = k_scales.to(self.device, torch.float32)
            vs = v_scales.to(self.device, torch.float32)
        if self.k_scales is not None:
            if ks is not None and k.dtype == self.k_cache.dtype:
                block_copy.scatter_blocks(self.k_cache, self.v_cache, idx, k, v,
                                          self.k_scales, self.v_scales, ks, vs)
                return
            if ks is None:
                ks = vs = torch.ones((k.shape[0], k.shape[2]),
                                     dtype=torch.float32, device=self.device)
            block_copy.scatter_blocks_requant(
                self.k_cache, self.v_cache, self.k_scales, self.v_scales, idx,
                k, v, ks, vs)
        elif ks is not None:
            block_copy.scatter_blocks_dequant(self.k_cache, self.v_cache, idx,
                                              k, v, ks, vs)
        else:
            block_copy.scatter_blocks(self.k_cache, self.v_cache, idx, k, v)
