#!/usr/bin/env python3
"""Drive the PyTorch port (dynamo_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the build of every CUDA kernel from csrc/ (one
     nvcc per source, in parallel) with its ptxas register report;
  2. kernel vs plain: each kernel entry point against its plain PyTorch
     version on the same inputs, the GQA kernels at the Llama-3-8B shapes
     (H=32, Hkv=8, D=128, bs=16, bf16; also over int8 pages with per-page
     scales, and over scale-free float8_e4m3fn pages) and the MLA latent
     kernels at the DeepSeek-V2-Lite shapes
     (H=16, C=512, R=64, bs=16, bf16); attention outputs within
     atol=rtol=2e-2 (bf16 output, sums in another order), (m, l) within
     rtol=1e-3 (f32, the order of the sums only), the KV append bit-exact
     at both the GQA and the MLA widths and the quantized append bit-exact
     at the Llama widths (the trash page 0 excluded), its in-place form
     (one launch) at B = 1, 8 and 64 with 0, 2 and B - 1 padded rows, bf16
     and f32 rows, pages that grow and pages that hold, planes and
     n_requants equal, two launches bit-equal; the row store's cast on
     store into fp8 caches byte-equal to models/quant.to_e4m3 (the
     reference's cast, NaN above 464) over all 65 536 bf16 bit patterns
     and seeded f32 rows (16-byte and element stores), and both appends
     into fp8 caches byte-equal to their plain twins; the multi-token
     append of the speculative verify bit-exact at both widths (B=8, T=4
     and T=16 windows crossing pages, padded slots on page 0 excluded), the
     verify's attention (T*G=16 rows per kv head, T*H=64 latent rows per
     token) against the plain twins at the same tolerances; the int8/fp8 grouped
     GEMM at DeepSeek-V2-Lite's expert shapes (64 experts, 2048 x 1408 and
     1408 x 2048; 48 decode rows and 7206 prefill rows) within 2e-2 of its
     plain twin, unowned rows exactly 0; the int8_native ``_mm``
     (torch._int_mm) on the card against the CPU's int32 product; the
     three GQA kernels at gpt-oss-20b's shapes (H=64, Hkv=8, D=64) with a
     128-token window and sinks drawn N(ln 128, 1), bf16, int8 and fp8 pages
     (the merged decode's call and the verify's rows with (m, l), decode
     rows with the sink folded, prefill and ragged; the scale each sink
     puts on its row's o within 1e-2 of the plain version's), then the
     pages below every walk's first step filled with NaN: outputs
     bit-equal and finite (the walks skip those pages); plus
     a tiny gpt-oss (windows of 16, sinks, biased clamped MoE whose clamp
     cuts elements on both devices, no routing tie) and
     five tiny models (dense GQA, MLA + MoE, and each again quantized:
     int8 KV + fp8 weights, int8 experts; dense GQA over an fp8 KV cache,
     logits within 2e-2) through prefill / mixed step /
     decode window on the card against the same functions on the CPU
     (f32, TF32 off), the gpt-oss, dense and MLA ones through the speculative
     verify_window too (tokens and accepted counts exact, logits 1e-3),
     the same for a tiny Qwen2 (random q/k/v biases, G=7: 14 query heads
     over 2) and a tiny Qwen3 (random per-head q/k norm weights),
     and a tiny TorchEngine with spec_gamma=3, with spec_gamma=16 (68
     verify rows per kv head) and with spec_gamma=3 over an fp8 KV cache,
     against spec_gamma=0 (the same greedy
     stream, proposals accepted); a head layout the Llama shapes miss (G=7,
     an unaligned history, padded rows, a dead segment, an inactive decode
     slot) through the tensor-core prefill, ragged and decode tiles, bf16,
     int8 and fp8 pages, with (m, l); the decode kernel at 68 and 70 verify
     rows per kv head (G=4, gamma=16; G=7, gamma=9); the latent kernels
     across the reference's widths (C=256/R=32 MiniCPM3-4B's, C=384/R=16,
     C=640/R=64, C=128/R=8; 16, 64 and 272 rows per sequence; bf16, and
     f32 at two of them; C.8: C=768/R=64, C=1024/R=64 and C=512/R=160,
     wider than the tensor-core tiles, on the CUDA-core body in bf16 and
     f32); the grouped GEMM's tiled blocks (experts of 1 to 200 rows and
     an empty one at V2-Lite's gate shape, then K=7168 at N=256) and its
     few-rows (decode) mode at V2-Lite's gate and down shapes and at
     K=7168, N=256 (64 experts, 8 and 16 tokens routed top-6, two
     launches bit-equal); the bf16
     MoE FFN at DeepSeek-V2-Lite's widths run twice, bit-equal, each stage
     compared; the KV tiers' block copies (csrc/block_copy.cu: gather,
     scatter / adopt, dequantize, requantize) byte-equal to their plain
     twins at Llama-3-8B's widths over bf16, int8 (with its planes) and
     e4m3 pages and at V2-Lite's latent widths, for 1, 7 and 64 pages out
     of order with the trash page among them, and the disaggregated
     handoff's 192 pages (a 3072-token prompt's extract and landing); and
     both latent kernels over float8_e4m3fn latent pages (bf16 queries,
     the pages to_e4m3 of the seeded bf16 draw) against their plain twins
     on the same bytes: on the tensor-core body at V2-Lite's widths
     decode with (m, l), the verify's T = 4 rows and the whole verify, and
     the 512-token prefill chunk; on the CUDA-core body at C = 1024, R =
     64 and on the tensor-core body's element path (C = 128, R = 8)
     decode and prefill, at the bf16 checks' tolerances; the row store
     into fp8 latent pages at V2-Lite's widths (values beyond 464 and
     +-inf among the rows) and the verify's T = 4 rows byte-equal to the
     plain twins;
  3. serving: the port's OpenAI HTTP service in-process, thirteen drives
     one after the other (each model's memory freed before the next):
     llama3-8b-sim twice on fresh engines (how many greedy answers the two
     drives share), deepseek-v2-lite-sim, deepseek-v2-lite-sim with int8
     weights (experts through ragged_int8_gmm), deepseek-v2-lite-sim over
     fp8 latent pages (a 4096-page pool at half the bytes; its replays
     checked as the first drives', its step anatomy, how many of its
     answers equal the bf16 drive's, and its first 4 layers' prefill over
     fp8 pages held to the plain path's: the served kernel's logits no
     further from the f32 plain path's than ORACLE_FACTOR times the bf16
     plain path's, every token routed to the same experts), llama3-8b-sim
     with fp8 weights and the int8 KV cache, llama3-8b-sim with bf16
     weights over the fp8 KV cache (a 4 GiB pool) and spec_gamma=3 (a
     prompt-lookup pass, whose greedy answers are held against the bf16
     drive's as a quality reading, then a pass with those answers as
     drafts; its replays checked as the first drives', its step anatomy,
     and one prefill's fp8-vs-bf16 logit gap), then llama3-8b-sim and
     deepseek-v2-lite-sim with speculative decoding (spec_gamma=3; their
     acceptance, and the share of answers equal to the plain drive's)
     (random weights from a seed, byte tokenizer, full width and depth),
     then qwen2.5-7b-sim and qwen3-8b-sim (Qwen2.5-7B-Instruct's and
     Qwen3-8B's published configs, full width and depth, random biases
     and q/k norm weights; Qwen2.5's 131072-token window masks nothing at
     max_context 8192, C.9), and a Mistral-7B-Instruct-v0.2 checkpoint
     (published config, depth cut to 4 of 32 layers) written by the
     port's saver beside the repo's 32,000-piece SentencePiece vocab and
     served through dynamo_run's parse_args / build_engine from
     ``--model-path <dir>`` (leaves and a prefill's logits bit-equal to
     the saved weights'; SentencePiece encode ms per request), each of
     these three held to dense_forward at full width (the served bf16
     prefill's logits no further from the f32 forward's than
     ORACLE_FACTOR times the plain bf16 forward's), and gptoss-20b-sim
     (gpt-oss-20b's published shapes and depth, 41.8 GB of bf16 weights;
     every prompt longer than its 128-token window; its windowed
     launches counted apart, the replays checked as the first drives';
     its first 4 layers held to dense_forward as the three above, with
     every token routed to the same experts, and a witness that the
     check sees the sinks knocked out) —
     at the reference defaults otherwise; one
     request alone (the dedicated prefill), then several more of 64-1500
     bytes while it decodes (fused mixed steps), one of them a streaming
     chat; each engine first runs ``warmup()`` (every prefill bucket and
     the decode-window ladder, whose CUDA graphs it captures: buckets,
     ledger and graph pool bytes printed), as ``dynamo_run --warmup``
     does before its port opens; every response must be 200 and
     non-empty, and every kernel of the drive's path, its launch counter
     zeroed just before the drive (a graph's replay counts the launches
     it captured), must have launched; on the first Llama and V2-Lite
     drives, the int8 V2-Lite and the fp8 + int8 KV Llama, every decode
     window of the ladder (n = 4, 2, 1) and the gamma-3 verify (not over
     int8 pages) replayed from its CUDA graph must equal the eager step
     bit for bit, outputs and state (greedy; seeded sampled rows with
     top-k / top-p, penalties and logprobs; then after a slot is freed
     and another refilled on moved tables); then each drive's step
     anatomy (the decode window and, on the spec drives, the verify, each
     eager and replayed from its graph in one run; the dedicated prefill
     and, for GQA, a fused mixed step, eager as they serve), on the bf16
     drives a run-to-run probe (the same
     prefill and decode step twice: bit-equal logits?) and what a
     prefix-cache hit changes, and the dense projections' cost per decode
     step in each weight form (bf16 drive) or the plain dequantize's
     (quantized drives); the last three drives profile a decode window
     only; then the distributed role (``fleet_drive``): ``dynamo_run
     hub``, two full Llama-3-8B ``in=dyn://… out=torch --warmup`` workers
     (started after phase 1 built the kernels) and an ``in=http
     out=dyn://… --router kv`` frontend with no card visible, each its own
     process; seven prompts over four long prefixes one at a time (two
     cold ones pinned to the second worker, so that both hold prefixes;
     each of the three that share a prefix back on its holder), then all
     seven at once (every request back on the worker that served it, its
     whole cached prompt hit), the card's CUDA-context count unchanged by
     the frontend, the four kernels' launches read from the
     workers' stats just before and after; both workers hold a host tier,
     and after round 2 this process's router, told the holder of a
     prefix is loaded, routes a prompt over that prefix to the other
     worker and hints it with the holder as peer: the worker pulls the
     chain from the holder's device pages (its KvPeerServer, one gather
     there), lands it and serves the prompt from it (the pull's TTFT
     beside the same worker's cold TTFT on an equal-length prompt nobody
     holds; ``peer_*`` and ``h2d_prefetch_hits`` counted), and a prompt
     over a second prefix of the holder's sent at once after the hint, as
     a frontend sends it (its TTFT and the prefix it hit); then a SIGKILL
     healed within the lease TTL + 5 s, a SIGTERM that revokes the lease,
     and the round-1 and pulled answers equal to one engine's in this
     process; then migration and drain: a 192-token greedy stream's
     worker SIGKILLed once 32 text events reached the client (the
     frontend's MigratingEngine finishes it on the survivor: the
     survivor's migration_resumes and the frontend's /metrics counters
     up by one), a worker relaunched with --warmup, and a 512-token
     stream's worker SIGTERMed (``--drain-deadline 2``: out of discovery
     at once while its stats still answer draining, the stream handed off
     at the deadline and finished on the other worker, exit 0), both
     answers equal to one engine's, the seam's gap beside that engine's
     ITL; then the disaggregated roles (``disagg_drive``): ``dynamo_run
     hub``, an ``in=prefill`` and an ``in=dyn://… --disagg decode``
     llama3-8b-sim worker and a card-less frontend, each its own process;
     ten prompts of 1500-3072 tokens above ``--max-local-prefill 512`` one
     at a time and ten more at once, streamed over bf16 pages, over an
     int8 wire (the prefill worker's ``--kv-quant int8``, landed by the
     dequantizing scatter) and bulk (``--no-kv-stream`` on both roles),
     every answer equal to an aggregated engine's in this process (the
     int8 wire's to one whose KV went through the codec's round trip in
     plain arithmetic); a short prompt prefilled locally; the prefill
     worker killed mid-stream (a delay fault holds its second segment) and
     the queue item redelivered once to a fresh one after the queue's
     visibility timeout, the answer still
     equal; after the last answer a SIGTERM on the prefill worker, which
     must stop consuming and exit 0 within its drain deadline and a
     margin; TTFT per variant beside the aggregated engine's cold TTFT, the
     handoff's anatomy from both workers' records (queue wait, prefill,
     gather, quantize, wire time and bytes, the hidden share, the
     landing's scatter), and the launches of the prefill kernels on the
     prefill worker and of the decode kernels and the block copies on the
     decode worker; before the fleet, the KV
     tiers (``tier_drive``): llama3-8b-sim at full width with a 512-page
     pool, a 256-block host tier and a 512-block disk tier (a temporary
     directory, removed), three times on fresh prompts and a fresh
     engine: four 3072-token prompts, then prompt 0 back from disk and
     host, prompt 3 from the device and prompt 2 from the host,
     each answer equal to an engine whose pool kept every prefix on the
     device and each restored page to its snapshot before eviction; with
     bf16 pages, with the int8 cache and the int8 tier (the adopting
     scatter, no bounce: C.15's path), and with the two codec landings
     (int8 tier under bf16 pages, fp8 tier under the int8 cache: pages
     held to the codec's arithmetic); TTFT per tier (median and range) beside
     a plain prefix hit on the engine without tiers, each hit's anatomy
     (its steps' host and device ms, the tier work overlapping it, a
     restore's pin / stack / h2d ms), the hidden share of restore latency
     and the cost model's host and disk link rates;
  4. timing: the time of an empty launch (the floor of every row), then
     the median time per launch of each kernel with L2 flushed between
     launches (the quantized append: the whole function, one launch, its
     planes reset before each call), its plain version's and a library
     yardstick's
     (scaled_dot_product_attention / index_put_ / torch._grouped_mm over
     the dequantized bf16 experts, timed only, never used by the port),
     and the least time the card could take (bytes over 3.35 TB/s or
     operations over 989 TFLOP/s, from this run's inputs); the grouped
     GEMM's decode rows at the gate shape and, on their own line, at the
     down projection's shape; the fp8-KV rows of the three GQA kernels
     (their yardstick SDPA over the pages widened to bf16) and of both row
     appends (no one PyTorch call casts and scatters: no yardstick); the
     latent kernels' CUDA-core body (bf16
     at C=1024, R=64, C.8's widths; f32 at C=512, R=64; their yardstick
     SDPA over the same latents gathered contiguous); the latent kernels
     over fp8 latent pages at V2-Lite's widths (their yardstick SDPA over
     the latents widened to bf16) and the row store into fp8 latent
     pages; and the three
     GQA kernels with gpt-oss's window 128 and sinks at gpt-oss-20b's
     shapes, their bound counted from the positions the window keeps and
     their yardstick SDPA over the same windows (banded mask, no sink);
     and the tiers' block copies over 64 pages at Llama-3-8B's widths
     (gather and scatter of bf16 pages, yardstick index_select /
     index_copy_ on K and V; the dequantizing and requantizing landings,
     no yardstick), their launches the tier drive's.

The second-to-last lines are the ``{"kernels": [...]}`` JSON and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside this file, it prints no result and exits non-zero.
"""

from __future__ import annotations

import asyncio
import contextlib
import datetime
import gc
import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores

#: the row-name suffixes of the D = 256 rows (see GEMMA_DRIVE below)
GEMMA_WINDOW = 1024
WIDE = " (D=256)"
WIDE_WINDOW = f" (D=256, window {GEMMA_WINDOW})"

KERNELS = {
    # name -> (source, replaced TPU kernel)
    "paged_decode_attention": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:184",
    ),
    "paged_prefill_attention": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:440",
    ),
    "ragged_mixed_attention": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/ragged_paged_attention_pallas.py:225",
    ),
    "kv_cache_append": (
        "dynamo_tpu_torch/csrc/kv_cache_append.cu",
        "dynamo_tpu/ops/kv_cache_update_pallas.py:63",
    ),
    "mla_paged_decode_attention": (
        "dynamo_tpu_torch/csrc/mla_attention.cu",
        "dynamo_tpu/ops/mla_attention_pallas.py:132",
    ),
    "mla_paged_prefill_attention": (
        "dynamo_tpu_torch/csrc/mla_attention.cu",
        "dynamo_tpu/ops/mla_attention_pallas.py:375",
    ),
    "ragged_int8_gmm": (
        "dynamo_tpu_torch/csrc/moe_gmm.cu",
        "dynamo_tpu/ops/moe_gmm_pallas.py:137",
    ),
    "ragged_int8_gmm (prefill rows)": (
        "dynamo_tpu_torch/csrc/moe_gmm.cu",
        "dynamo_tpu/ops/moe_gmm_pallas.py:137",
    ),
    "kv_cache_append_quantized": (
        "dynamo_tpu_torch/csrc/kv_cache_append.cu",
        "dynamo_tpu/ops/kv_cache_update_pallas.py:273",
    ),
    "paged_decode_attention (int8 KV)": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:184",
    ),
    "paged_prefill_attention (int8 KV)": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:440",
    ),
    "ragged_mixed_attention (int8 KV)": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/ragged_paged_attention_pallas.py:225",
    ),
    "kv_cache_append_tokens": (
        "dynamo_tpu_torch/csrc/kv_cache_append.cu",
        "dynamo_tpu/ops/kv_cache_update_pallas.py:383",
    ),
    "kv_cache_append_tokens (MLA widths)": (
        "dynamo_tpu_torch/csrc/kv_cache_append.cu",
        "dynamo_tpu/ops/kv_cache_update_pallas.py:383",
    ),
    "paged_decode_attention (verify rows)": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:184",
    ),
    "mla_paged_decode_attention (verify rows)": (
        "dynamo_tpu_torch/csrc/mla_attention.cu",
        "dynamo_tpu/ops/mla_attention_pallas.py:132",
    ),
    # the latent kernels over float8_e4m3fn latent pages and the row
    # store's cast on store at MLA widths (the fp8 V2-Lite drive's)
    "mla_paged_decode_attention (fp8 KV)": (
        "dynamo_tpu_torch/csrc/mla_attention.cu",
        "dynamo_tpu/ops/mla_attention_pallas.py:132",
    ),
    "mla_paged_prefill_attention (fp8 KV)": (
        "dynamo_tpu_torch/csrc/mla_attention.cu",
        "dynamo_tpu/ops/mla_attention_pallas.py:375",
    ),
    "kv_cache_append (MLA widths, fp8 KV)": (
        "dynamo_tpu_torch/csrc/kv_cache_append.cu",
        "dynamo_tpu/ops/kv_cache_update_pallas.py:63",
    ),
    "paged_decode_attention (window 128)": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:184",
    ),
    "paged_prefill_attention (window 128, sinks)": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:440",
    ),
    "ragged_mixed_attention (window 128, sinks)": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/ragged_paged_attention_pallas.py:225",
    ),
    "paged_decode_attention (fp8 KV)": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:184",
    ),
    "paged_prefill_attention (fp8 KV)": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:440",
    ),
    "ragged_mixed_attention (fp8 KV)": (
        "dynamo_tpu_torch/csrc/paged_attention.cu",
        "dynamo_tpu/ops/ragged_paged_attention_pallas.py:225",
    ),
    "kv_cache_append (fp8 KV)": (
        "dynamo_tpu_torch/csrc/kv_cache_append.cu",
        "dynamo_tpu/ops/kv_cache_update_pallas.py:63",
    ),
    "kv_cache_append_tokens (fp8 KV)": (
        "dynamo_tpu_torch/csrc/kv_cache_append.cu",
        "dynamo_tpu/ops/kv_cache_update_pallas.py:383",
    ),
    "paged_decode_attention" + WIDE: (
        "dynamo_tpu_torch/csrc/paged_attention_wide.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:184",
    ),
    "paged_prefill_attention" + WIDE: (
        "dynamo_tpu_torch/csrc/paged_attention_wide.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:440",
    ),
    "ragged_mixed_attention" + WIDE: (
        "dynamo_tpu_torch/csrc/paged_attention_wide.cu",
        "dynamo_tpu/ops/ragged_paged_attention_pallas.py:225",
    ),
    "kv_cache_append" + WIDE: (
        "dynamo_tpu_torch/csrc/kv_cache_append.cu",
        "dynamo_tpu/ops/kv_cache_update_pallas.py:63",
    ),
    "paged_decode_attention" + WIDE_WINDOW: (
        "dynamo_tpu_torch/csrc/paged_attention_wide.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:184",
    ),
    "paged_prefill_attention" + WIDE_WINDOW: (
        "dynamo_tpu_torch/csrc/paged_attention_wide.cu",
        "dynamo_tpu/ops/paged_attention_pallas.py:440",
    ),
    "ragged_mixed_attention" + WIDE_WINDOW: (
        "dynamo_tpu_torch/csrc/paged_attention_wide.cu",
        "dynamo_tpu/ops/ragged_paged_attention_pallas.py:225",
    ),
    # the KV tiers' block copies replace no Pallas kernel: the reference
    # moves tier blocks with jitted XLA gathers and scatters (these cores)
    "gather_blocks": (
        "dynamo_tpu_torch/csrc/block_copy.cu",
        "dynamo_tpu/engine/offload.py:125",
    ),
    "scatter_blocks": (
        "dynamo_tpu_torch/csrc/block_copy.cu",
        "dynamo_tpu/engine/offload.py:132",
    ),
    "scatter_blocks_dequant": (
        "dynamo_tpu_torch/csrc/block_copy.cu",
        "dynamo_tpu/engine/offload.py:163",
    ),
    "scatter_blocks_requant": (
        "dynamo_tpu_torch/csrc/block_copy.cu",
        "dynamo_tpu/engine/offload.py:231",
    ),
}
#: the int8-KV variant of each GQA kernel shares the kernel's counter; the
#: int8-KV drive's launches land under the variant's name
INT8_KV = " (int8 KV)"
#: the same for the scale-free fp8 cache (float8_e4m3fn pages): the fp8
#: drive's launches of the three GQA kernels and the two appends (the row
#: store's cast on store) land under these names
FP8_KV = " (fp8 KV)"
#: the spec drives' verify forwards: a decode attention launch whose rows
#: pack T tokens counts in the wrapper's ``verify_launches`` too, and the
#: multi-token append of each spec drive lands under its width's row
VERIFY = " (verify rows)"
SPEC_GAMMA = 3
#: gpt-oss's sliding layers: the windowed variants of the GQA kernels at
#: gpt-oss-20b's widths (H=64, Hkv=8, D=64), timed in phase 4; their
#: launches are the gpt-oss drive's windowed ones (the wrappers'
#: ``window_launches``). The decode row is the merged decode's call, whose
#: (m, l) come without the sink (the merge folds it)
GPTOSS_WINDOW = 128
WINDOW = f" (window {GPTOSS_WINDOW})"
WINDOW_SINKS = f" (window {GPTOSS_WINDOW}, sinks)"
GPTOSS_DRIVE = "gptoss-20b-sim"
#: the depth of the gpt-oss model held to dense_forward at full width
GPTOSS_ORACLE_LAYERS = 4
#: Gemma-3-12B's attention (16 query heads over 8 kv heads of 256, G = 2;
#: a 1024-token window on 40 of its 48 layers): the D = 256 rows of the
#: three GQA kernels (and of the row store), checked over bf16, int8 and
#: fp8 pages in phase 2 and timed over bf16 pages in phase 4. Their
#: launches are the Gemma drive's: the D = 256 rows count all of them, the
#: window rows the windowed ones among them (``window_launches``)
GEMMA_DRIVE = "gemma3-12b-sim"
GEMMA_HEADS = dict(H=16, Hkv=8, D=256)
#: the depth of the Gemma-3 model held to dense_forward at full width: five
#: windowed layers and the first full one
GEMMA_ORACLE_LAYERS = 6
#: the drives run twice, the second time on a fresh engine (C.4); the
#: V2-Lite bf16 drive's second run is cut (the fp8 V2-Lite drive builds
#: another V2-Lite engine and reads its answers against the bf16 drive's)
REPEATED = ("llama3-8b-sim",)
#: the depth of the fp8 V2-Lite drive's oracle: the dense layer and three
#: MoE layers of the served weights (their f32 copy fits beside the model)
MLA_ORACLE_LAYERS = 4
#: the checkpoint drive: Mistral-7B-Instruct-v0.2's config.json at this
#: depth (of 32), written by the port's saver and served from its directory
CHECKPOINT_DRIVE = "mistral-7b-v0.2 checkpoint"
CHECKPOINT_LAYERS = 4
#: the full-width oracle: the served path's bf16 prefill logits (two
#: chunks, the second over the first's cached pages) may lie at most this
#: many times as far from dense_forward's f32 logits (the same weights
#: widened) as dense_forward's own bf16 logits do: the served path rounds
#: no worse than the plain forward, whose 8-bit mantissas through 28-36
#: random layers move the logits by a few percent of their range
ORACLE_FACTOR = 2.0


def log(*a):
    print(*a, flush=True)


def ptxas_entries(log_text: str) -> list:
    """(kernel, registers, "stores / loads" spill bytes) of every entry
    function in an ``nvcc -Xptxas -v`` log, the names demangled by
    ``cu++filt`` or ``c++filt`` where the machine has one."""
    import shutil

    out, name, spills = [], None, "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), "?"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"{m.group(1)} / {m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append([name, int(m.group(1)), spills])
            name = None
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(e[0] for e in out),
                               capture_output=True, text=True).stdout.split("\n")
        for e, n in zip(out, names):
            e[0] = n.replace("(anonymous namespace)::", "") or e[0]
    return [tuple(e) for e in out]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------- phase 2: kernels against their plain versions ----------------


class KernelInputs:
    """Synthetic paged caches and queries at the Llama-3-8B shapes, or at
    the head shapes given; with a ``window`` (and ``sinks``) every entry
    point takes the gpt-oss options: the decode and verify rows as the
    merged decode and the verify call the kernel (one past the cache,
    floors per row, (m, l) without the sink), prefill and ragged with the
    window and per-head sink logits drawn N(ln window, 1)."""

    def __init__(self, torch, dev, H=32, Hkv=8, D=128, window=0, sinks=False):
        self.torch = torch
        g = torch.Generator(device=dev).manual_seed(0)
        self.H, self.Hkv, self.D, self.bs = H, Hkv, D, 16
        self.M, self.N = 128, 2048  # table width (2048 tokens), pool pages
        self.scale = self.D ** -0.5
        H, Hkv, D, bs, M, N = self.H, self.Hkv, self.D, self.bs, self.M, self.N

        def randn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

        self.kc, self.vc = randn(Hkv, N, bs, D), randn(Hkv, N, bs, D)
        pages = torch.randperm(N - 1, generator=g, device=dev) + 1
        tables = pages[: 11 * M].reshape(11, M).to(torch.int32)
        # decode: B=8, ragged lengths up to 2048, one empty slot
        self.d_tables = tables[:8].contiguous()
        self.d_lens = torch.tensor([2048, 1500, 1031, 777, 512, 300, 17, 0],
                                   dtype=torch.int32, device=dev)
        self.q_dec = randn(8, H, D)
        # prefill: T=512 on 1000 tokens of history
        self.p_table = tables[8].contiguous()
        self.hist = torch.tensor([1000], dtype=torch.int32, device=dev)
        self.q_pre = randn(512, H, D)
        # ragged: the 8 decode rows plus MP=2 segments of T=256, one dead
        self.r_tables = torch.stack([tables[9], torch.zeros_like(tables[9])])
        self.r_hists = torch.tensor([700, 0], dtype=torch.int32, device=dev)
        self.r_valids = torch.tensor([200, 0], dtype=torch.int32, device=dev)
        self.q_chunks = randn(2, 256, H, D)
        # append: L=32 layers, B=8 rows on distinct pages
        self.k_new, self.v_new = randn(32, 8, Hkv, D), randn(32, 8, Hkv, D)
        self.a_kc, self.a_vc = randn(32, Hkv, 256, bs, D), randn(32, Hkv, 256, bs, D)
        self.a_blk = (torch.randperm(255, generator=g, device=dev)[:8] + 1).to(torch.int32)
        self.a_off = torch.randint(0, bs, (8,), generator=g, device=dev,
                                   dtype=torch.int32)
        self.sc = {}  # per-page scales of an int8 cache (see scaled())
        # the verify: T=4 in-flight tokens of the 8 decode rows over the
        # same histories, their window K/V; the history pass packs T*G=16
        # rows per kv head (token-major within the head)
        T, G = SPEC_GAMMA + 1, H // Hkv
        self.q_ver = randn(8, T, H, D)
        self.k_win, self.v_win = randn(8, T, Hkv, D), randn(8, T, Hkv, D)
        self.q_rows = self.q_ver.reshape(8, T, Hkv, G, D).permute(
            0, 2, 1, 3, 4).reshape(8, Hkv * T * G, D).contiguous()
        self.window = window
        # the sinks near the log of the window: each holds a real share of
        # its row's mass (N(0, 1) would hold a few percent over 128 scores)
        self.sinks = (torch.randn(H, generator=g, device=dev)
                      + math.log(window or 128) if sinks else None)
        # the decode / verify rows' options, and prefill's and ragged's
        self.dkw = (dict(window=window, q_pos_offset=1, group=G)
                    if window else {})
        self.skw = ({"window": window, "sinks": self.sinks}
                    if window or sinks else {})

    def scaled(self):
        """The same queries and tables over an int8 copy of the caches with
        one f32 absmax scale per page (K and V): the int8-KV variants."""
        import copy

        other = copy.copy(self)
        other.kc, other.vc, ks, vs = quantized_pages(self.torch, self.kc, self.vc)
        other.sc = {**other.sc, "k_scales": ks, "v_scales": vs}
        return other

    def fp8(self):
        """The same queries and tables over float8_e4m3fn copies of the
        caches (models/quant.to_e4m3, the reference's cast of the bf16
        pages; no scales): the fp8-KV variants."""
        import copy

        from dynamo_tpu_torch.models.quant import to_e4m3

        other = copy.copy(self)
        other.kc, other.vc = to_e4m3(self.kc), to_e4m3(self.vc)
        other.sc = {}
        return other

    def widened(self):
        """fp8 caches widened to bf16, exactly (the library yardstick's
        inputs; built outside any timed span)."""
        import copy

        other = copy.copy(self)
        other.kc, other.vc = self.kc.bfloat16(), self.vc.bfloat16()
        return other

    def dequantized(self):
        """The int8 caches dequantized to bf16 (the library yardstick's
        inputs; built outside any timed span)."""
        import copy

        other = copy.copy(self)
        other.kc = (self.kc.float() * self.sc["k_scales"][None, :, None, None]).bfloat16()
        other.vc = (self.vc.float() * self.sc["v_scales"][None, :, None, None]).bfloat16()
        other.sc = {}
        return other

    # one call of each entry point, kernel or plain
    def decode(self, fn):
        return fn(self.q_dec, self.kc, self.vc, self.d_tables, self.d_lens,
                  self.scale, return_stats=True, **self.sc, **self.dkw)

    def decode_sinks(self, fn):
        """Decode rows at seq_len - 1 with the sink folded into o (no
        (m, l)): the decode tiles' fold, as a ragged launch's decode rows
        take it."""
        return fn(self.q_dec, self.kc, self.vc, self.d_tables, self.d_lens,
                  self.scale, window=self.window, sinks=self.sinks, **self.sc)

    def without_sinks(self):
        """The same calls with the window alone."""
        import copy

        other = copy.copy(self)
        other.sinks = None
        other.skw = {"window": self.window} if self.window else {}
        return other

    def prefill(self, fn):
        return fn(self.q_pre, self.kc, self.vc, self.p_table, self.hist, self.scale,
                  **self.sc, **self.skw)

    def ragged(self, fn):
        return fn(self.q_dec, self.q_chunks, self.kc, self.vc, self.d_tables,
                  self.d_lens, self.r_tables, self.r_hists, self.r_valids,
                  self.scale, **self.sc, **self.skw)

    # (m, l) of a prefill / ragged launch against the plain softmax
    # statistics: o within 2e-2 cannot tell a dropped page or a causal edge
    # moved by a few positions from bf16 rounding; l at rtol 1e-3 can
    def launch_stats(self, q, T, **tables):
        from dynamo_tpu_torch.ops import paged_attention as pa

        G = self.H // self.Hkv
        _, m, l = pa.launch_paged_attention(
            q.reshape(-1, self.Hkv, G, self.D), self.kc, self.vc, self.scale,
            T=T, stats=True, **tables, **self.sc)
        return m, l

    def plain_stats(self, q, table, limit):
        """Rows ``q [R, H, D]`` through ``table`` ([M] shared or [R, M]),
        row r attending positions ``0..limit[r]``."""
        from dynamo_tpu_torch.ops import paged_attention as pa

        k = pa.gather_pages(self.kc, table, self.sc.get("k_scales"))
        v = pa.gather_pages(self.vc, table, self.sc.get("v_scales"))
        if table.dim() == 1:
            k, v = k[:, None], v[:, None]
        qg = q.reshape(q.shape[0], self.Hkv, -1, self.D).float() * self.scale
        _, m, l = pa.masked_attention(qg, k, v, limit)
        return m, l

    def prefill_stats(self):
        T = self.q_pre.shape[0]
        limit = self.hist.long() + self.torch.arange(T, device=self.q_pre.device)
        return (self.launch_stats(self.q_pre, T, p_tables=self.p_table[None],
                                  p_hists=self.hist),
                self.plain_stats(self.q_pre, self.p_table, limit))

    def ragged_stats(self):
        torch = self.torch
        MP, T = self.q_chunks.shape[:2]
        got = self.launch_stats(
            torch.cat([self.q_dec, self.q_chunks.reshape(MP * T, self.H, self.D)]),
            T, d_tables=self.d_tables, d_seq_lens=self.d_lens,
            p_tables=self.r_tables, p_hists=self.r_hists, p_valids=self.r_valids)
        parts = [self.plain_stats(self.q_dec, self.d_tables, self.d_lens.long() - 1)]
        t = torch.arange(T, device=self.q_dec.device)
        for m in range(MP):
            limit = torch.where(t < self.r_valids[m], self.r_hists[m].long() + t, -1)
            parts.append(self.plain_stats(self.q_chunks[m], self.r_tables[m], limit))
        return got, tuple(torch.cat(x) for x in zip(*parts))

    def append(self, fn, kc=None, vc=None):
        return fn(self.k_new, self.v_new, self.a_kc if kc is None else kc,
                  self.a_vc if vc is None else vc, self.a_blk, self.a_off)

    def verify_rows(self, fn):
        """The verify's history pass: the decode kernel (``group`` = G
        marks the packed rows) or its plain twin, with (m, l)."""
        kw = {**self.dkw, "group": self.H // self.Hkv}
        return fn(self.q_rows, self.kc, self.vc, self.d_tables, self.d_lens,
                  self.scale, return_stats=True, **self.sc, **kw)

    def verify(self, fn, dev=None):
        """``verify_attention`` (history pass + the dense causal window) on
        ``dev`` (the CPU takes the plain twin)."""
        args = (self.q_ver, self.k_win, self.v_win, self.kc, self.vc,
                self.d_tables, self.d_lens)
        kw = {k: v.to(dev) if dev is not None and hasattr(v, "to") else v
              for k, v in self.skw.items()}
        return fn(*(a if dev is None else a.to(dev) for a in args), self.scale,
                  **kw)


class MlaInputs:
    """Synthetic latent caches and queries at the DeepSeek-V2-Lite shapes:
    H=16 heads, kv_lora_rank C=512, rope dims R=64 (or the C and R given),
    bs=16, the model's own softmax scale, bf16 (or the dtype given); decode
    B=8 over lengths up to 2048 with one empty slot, prefill T=512 on 1000
    cached tokens, the append over all 27 layers."""

    def __init__(self, torch, dev, C=None, R=None, dtype=None):
        from dynamo_tpu_torch.models.config import deepseek_v2_lite

        self.torch = torch
        g = torch.Generator(device=dev).manual_seed(1)
        cfg = deepseek_v2_lite()
        self.H, self.C, self.R, self.bs = (cfg.num_heads, C or cfg.kv_lora_rank,
                                           R or cfg.qk_rope_head_dim, 16)
        self.M, self.N = 128, 2048
        self.scale = cfg.mla_softmax_scale()
        H, C, R, bs, M, N = self.H, self.C, self.R, self.bs, self.M, self.N

        def randn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(
                dtype or torch.bfloat16)

        self.cc, self.pc = randn(1, N, bs, C), randn(1, N, bs, R)
        pages = torch.randperm(N - 1, generator=g, device=dev) + 1
        tables = pages[: 9 * M].reshape(9, M).to(torch.int32)
        self.d_tables = tables[:8].contiguous()
        self.d_lens = torch.tensor([2048, 1500, 1031, 777, 512, 300, 17, 0],
                                   dtype=torch.int32, device=dev)
        self.qe_dec, self.qp_dec = randn(8, H, C), randn(8, H, R)
        self.p_table = tables[8].contiguous()
        self.hist = torch.tensor([1000], dtype=torch.int32, device=dev)
        self.qe_pre, self.qp_pre = randn(512, H, C), randn(512, H, R)
        L = cfg.num_layers
        self.c_new, self.pe_new = randn(L, 8, 1, C), randn(L, 8, 1, R)
        self.a_kc, self.a_vc = randn(L, 1, 256, bs, C), randn(L, 1, 256, bs, R)
        self.a_blk = (torch.randperm(255, generator=g, device=dev)[:8] + 1).to(torch.int32)
        self.a_off = torch.randint(0, bs, (8,), generator=g, device=dev,
                                   dtype=torch.int32)
        # the verify: T=4 in-flight tokens of the 8 decode rows, whose
        # history pass packs T*H=64 latent query rows per token
        T = SPEC_GAMMA + 1
        self.qe_ver, self.qp_ver = randn(8, T, H, C), randn(8, T, H, R)
        self.c_win, self.pe_win = randn(8, T, C), randn(8, T, R)

    def decode(self, fn):
        return fn(self.qe_dec, self.qp_dec, self.cc, self.pc, self.d_tables,
                  self.d_lens, self.scale, return_stats=True)

    def verify_rows(self, fn):
        """The verify's history pass ``[B, T*H, C]`` with (m, l)."""
        from dynamo_tpu_torch.ops import mla_attention as mla

        B, T, H, C = self.qe_ver.shape
        kw = {"tokens": T} if fn is mla.mla_paged_decode_attention else {}
        return fn(self.qe_ver.reshape(B, T * H, C),
                  self.qp_ver.reshape(B, T * H, -1), self.cc, self.pc,
                  self.d_tables, self.d_lens, self.scale, return_stats=True, **kw)

    def verify(self, fn):
        return fn(self.qe_ver, self.qp_ver, self.c_win, self.pe_win, self.cc,
                  self.pc, self.d_tables, self.d_lens, self.scale)

    def prefill(self, fn):
        return fn(self.qe_pre, self.qp_pre, self.cc, self.pc, self.p_table,
                  self.hist, self.scale)

    def prefill_stats(self):
        """(m, l) of the prefill launch against the plain softmax's."""
        from dynamo_tpu_torch.ops import mla_attention as mla

        _, m, l = mla.launch_mla_attention(
            self.qe_pre, self.qp_pre, self.cc, self.pc, self.p_table,
            self.scale, hist=self.hist, stats=True, out_f32=True)
        T = self.qe_pre.shape[0]
        limit = self.hist.long() + self.torch.arange(T, device=self.cc.device)
        _, rm, rl = mla.latent_attention(
            self.qe_pre, self.qp_pre,
            mla.gather_latents(self.cc, self.p_table)[None],
            mla.gather_latents(self.pc, self.p_table)[None], limit, self.scale)
        return (m, l), (rm, rl)

    def append(self, fn, kc=None, vc=None):
        return fn(self.c_new, self.pe_new, self.a_kc if kc is None else kc,
                  self.a_vc if vc is None else vc, self.a_blk, self.a_off)

    def fp8(self):
        """The same queries and tables over float8_e4m3fn copies of the
        latent pages and of the append caches (models/quant.to_e4m3, the
        reference's cast of the bf16 draw): the fp8-KV variants."""
        import copy

        from dynamo_tpu_torch.models.quant import to_e4m3

        other = copy.copy(self)
        other.cc, other.pc = to_e4m3(self.cc), to_e4m3(self.pc)
        other.a_kc, other.a_vc = to_e4m3(self.a_kc), to_e4m3(self.a_vc)
        return other

    def widened(self):
        """fp8 latent pages widened to bf16, exactly (the library
        yardstick's inputs; built outside any timed span)."""
        import copy

        other = copy.copy(self)
        other.cc, other.pc = self.cc.bfloat16(), self.pc.bfloat16()
        return other


class TokenAppendInputs:
    """``kv_cache_append_tokens``' inputs: B=8 sequences of T=4 in-flight
    rows (and again of T = bs = 16), four pages each from a 256-page pool:
    windows starting at rows 14, 3, 29, 45 and 8 (the T=4 ones at 14 and
    29 cross a page boundary), one at row 0 of its second page (16), and
    two padded slots with every row on the trash page 0. Over the Llama
    widths' append caches (L=32, Hkv=8, D=128) of :class:`KernelInputs`
    and the V2-Lite latent caches (L=27, C=512, R=64) of
    :class:`MlaInputs`, bf16."""

    STARTS = (14, 16, 3, 29, 0, 45, 8, 0)
    PADDED = (4, 7)

    def __init__(self, torch, dev, inp: KernelInputs, mi: MlaInputs):
        self.torch = torch
        g = torch.Generator(device=dev).manual_seed(5)
        bs, B = inp.bs, len(self.STARTS)
        pages = (torch.randperm(inp.a_kc.shape[2] - 1, generator=g, device=dev)
                 [: B * 4] + 1).reshape(B, 4)
        self.caches = {"gqa": (inp.a_kc, inp.a_vc), "mla": (mi.a_kc, mi.a_vc)}
        self.idx, self.new = {}, {}
        for T in (SPEC_GAMMA + 1, bs):
            pos = (torch.tensor(self.STARTS, device=dev)[:, None]
                   + torch.arange(T, device=dev)[None, :])
            blk = torch.gather(pages, 1, pos // bs)
            blk[list(self.PADDED)] = 0
            pos[list(self.PADDED)] = torch.arange(T, device=dev)
            self.idx[T] = (blk.to(torch.int32), (pos % bs).to(torch.int32))
            for w, (kc, vc) in self.caches.items():
                L, Hkv, Dk, Dv = kc.shape[0], kc.shape[1], kc.shape[-1], vc.shape[-1]
                self.new[w, T] = tuple(
                    torch.randn(L, B, T, Hkv, d, generator=g, device=dev).bfloat16()
                    for d in (Dk, Dv))

    def append(self, fn, width="gqa", T=SPEC_GAMMA + 1, caches=None):
        kc, vc = self.caches[width] if caches is None else caches
        return fn(*self.new[width, T], kc, vc, *self.idx[T])

    def index_put(self, width="gqa", T=SPEC_GAMMA + 1):
        """The library yardstick: one advanced-index assignment per cache
        with the indices already widened (timed only)."""
        kc, vc = self.caches[width]
        blk, off = (x.long()[None] for x in self.idx[T])
        lidx = self.torch.arange(kc.shape[0], device=kc.device)[:, None, None]
        k_new, v_new = self.new[width, T]

        def call():
            kc[lidx, :, blk, off] = k_new
            vc[lidx, :, blk, off] = v_new
        return call


def check_spec_kernels(torch, inp: KernelInputs, mi: MlaInputs,
                       ta: TokenAppendInputs) -> dict:
    """The speculative path's kernels at its shapes: the multi-token append
    bit-exact with its plain twin at both widths and both window lengths
    (page 0 excluded: the padded slots race there); the verify attention
    (GQA, MLA) against the plain twins, outputs 2e-2, the history pass's
    (m, l) rtol 1e-3; the GQA append and verify again into and over fp8
    caches (bf16 rows cast on store: bytes equal)."""
    from dynamo_tpu_torch.models.quant import to_e4m3
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import kv_cache_update as kvu
    from dynamo_tpu_torch.ops import mla_attention as mla
    from dynamo_tpu_torch.ops import paged_attention as pa

    errs = {}
    for width, label in (("gqa", "kv_cache_append_tokens"),
                         ("mla", "kv_cache_append_tokens (MLA widths)")):
        for T in sorted({t for _w, t in ta.new}):
            kc, vc = (c.clone() for c in ta.caches[width])
            pk, pv = (c.clone() for c in ta.caches[width])
            ta.append(kvu.kv_cache_append_tokens, width, T, (kc, vc))
            ta.append(kvu.kv_cache_append_tokens_plain, width, T, (pk, pv))
            torch.cuda.synchronize()
            if not (torch.equal(kc[:, :, 1:], pk[:, :, 1:])
                    and torch.equal(vc[:, :, 1:], pv[:, :, 1:])):
                raise AssertionError(f"{label}, T={T}: not bit-exact with "
                                     "index_put_")
            del kc, vc, pk, pv
        errs[label] = 0.0
        log(f"  {label} (B=8, T=4 and T=16, windows crossing pages, padded "
            "slots on page 0): bit-exact except the trash page  OK")
    # the verify's append into fp8 caches (bf16 rows, cast on store)
    fkc, fvc = (to_e4m3(c) for c in ta.caches["gqa"])
    for T in sorted({t for _w, t in ta.new}):
        kc, vc, pk, pv = fkc.clone(), fvc.clone(), fkc.clone(), fvc.clone()
        ta.append(kvu.kv_cache_append_tokens, "gqa", T, (kc, vc))
        ta.append(kvu.kv_cache_append_tokens_plain, "gqa", T, (pk, pv))
        torch.cuda.synchronize()
        if not (same_bytes(torch, kc[:, :, 1:], pk[:, :, 1:])
                and same_bytes(torch, vc[:, :, 1:], pv[:, :, 1:])):
            raise AssertionError(f"kv_cache_append_tokens into fp8 caches, "
                                 f"T={T}: not byte-equal to the plain cast")
        del kc, vc, pk, pv
    del fkc, fvc
    errs["kv_cache_append_tokens" + FP8_KV] = 0.0
    log("  kv_cache_append_tokens into fp8 caches (bf16 rows, T=4 and T=16): "
        "byte-equal to the plain cast except the trash page  OK")
    o, m, l = inp.verify_rows(pa.paged_decode_attention)
    ro, rm, rl = inp.verify_rows(pa.paged_decode_attention_plain)
    torch.cuda.synchronize()
    err = close("verify rows o", o, ro, 2e-2, 2e-2)
    close_stats("verify rows", (m, l), (rm, rl))
    f8 = inp.fp8()
    fo, fm, fl = f8.verify_rows(pa.paged_decode_attention)
    ro, rm, rl = f8.verify_rows(pa.paged_decode_attention_plain)
    got = f8.verify(att.verify_attention)
    ref = f8.verify(att.verify_attention, "cpu")
    torch.cuda.synchronize()
    ferr = max(close("verify rows o, fp8 pages", fo, ro, 2e-2, 2e-2),
               close("verify_attention, fp8 pages", got.cpu(), ref, 2e-2, 2e-2))
    close_stats("verify rows, fp8 pages", (fm, fl), (rm, rl))
    del f8
    log(f"  verify rows (16 per kv head) and verify_attention over fp8 pages: "
        f"max |err| {ferr:.3e}, (m, l) within 1e-3  OK")
    got = inp.verify(att.verify_attention)
    ref = inp.verify(att.verify_attention, "cpu")
    errs["paged_decode_attention" + VERIFY] = max(
        err, close("verify_attention", got.cpu(), ref, 2e-2, 2e-2))
    o, m, l = mi.verify_rows(mla.mla_paged_decode_attention)
    ro, rm, rl = mi.verify_rows(mla.mla_paged_decode_attention_plain)
    torch.cuda.synchronize()
    err = close("mla verify rows o", o, ro, 2e-2, 2e-2)
    close_stats("mla verify rows", (m, l), (rm, rl))
    got = mi.verify(mla.mla_verify_attention)
    ref = mi.verify(mla.mla_verify_attention_xla)
    torch.cuda.synchronize()
    errs["mla_paged_decode_attention" + VERIFY] = max(
        err, close("mla_verify_attention", got, ref, 2e-2, 2e-2))
    for name, rows in (("paged_decode_attention" + VERIFY, "16 rows per kv head"),
                       ("mla_paged_decode_attention" + VERIFY, "64 rows per token")):
        log(f"  {name} ({rows}) and the merged verify attention: max |err| "
            f"{errs[name]:.3e}, (m, l) within 1e-3  OK")
    return errs


class QuantInputs:
    """Inputs of the two quantized-path kernels. ragged_int8_gmm at
    DeepSeek-V2-Lite's expert shapes (64 experts; gate/up K=2048, N=1408;
    down K=1408, N=2048) with int8 and fp8 codes of random bf16 weights,
    bf16 rows routed top-6 by random scores: 8 decode tokens (48 rows) and
    a 1201-token prefill (7206 rows), each with 16 rows no expert owns.
    kv_cache_append_quantized at Llama-3-8B's widths (L=32, B=8, Hkv=8,
    D=128, bs=16) over a 256-page int8 pool whose per-page scales are
    those of random bf16 pages; two padded rows share the trash page 0."""

    SHAPES = dict(X=64, E=2048, F=1408, prefill_tokens=1201, L=32, N=256)

    def __init__(self, torch, dev):
        from dynamo_tpu_torch.models.quant import quantize_array

        self.torch = torch
        g = torch.Generator(device=dev).manual_seed(2)
        X, E, F = (self.SHAPES[k] for k in ("X", "E", "F"))
        self.codes = {}
        for mode in ("int8", "fp8_e4m3"):
            for proj, (K, N) in (("gate", (E, F)), ("down", (F, E))):
                w = torch.randn(X, K, N, generator=g, device=dev).bfloat16()
                qw = quantize_array(w, mode)
                self.codes[mode, proj] = (qw["q"], qw["s"])
                del w
        self.rows = {}
        for label, tokens in (("decode", 8), ("prefill", self.SHAPES["prefill_tokens"])):
            scores = torch.rand(tokens, X, generator=g, device=dev)
            experts = scores.topk(6, dim=-1).indices.reshape(-1)
            sizes = torch.bincount(experts, minlength=X)
            R = int(sizes.sum()) + 16
            lhs = {K: torch.randn(R, K, generator=g, device=dev).bfloat16()
                   for K in (E, F)}
            self.rows[label] = (lhs, sizes)
        L, B, Hkv, D, N, bs = self.SHAPES["L"], 8, 8, 128, self.SHAPES["N"], 16
        pages = torch.randn(2, L, Hkv, N, bs, D, generator=g, device=dev)
        self.scales = (pages.abs().amax(dim=(2, 4, 5)) / 127.0).contiguous()  # [2, L, N]
        self.caches = torch.clamp(torch.round(
            pages / self.scales[:, :, None, :, None, None]), -127, 127).to(torch.int8)
        del pages
        self.k_new = torch.randn(L, B, Hkv, D, generator=g, device=dev).bfloat16()
        self.v_new = torch.randn(L, B, Hkv, D, generator=g, device=dev).bfloat16()
        blk = torch.randperm(N - 1, generator=g, device=dev)[:B] + 1
        blk[[2, 6]] = 0  # padded rows: the trash page
        self.blk = blk.to(torch.int32)
        self.off = torch.randint(0, bs, (B,), generator=g, device=dev,
                                 dtype=torch.int32)

    def gmm(self, fn, label="decode", mode="int8", proj="gate"):
        lhs, sizes = self.rows[label]
        q, sc = self.codes[mode, proj]
        return fn(lhs[q.shape[1]], q, sc, sizes)

    def append(self, fn, caches=None):
        c = self.caches if caches is None else caches
        return fn(self.k_new, self.v_new, c[0], c[1], self.scales[0],
                  self.scales[1], self.blk, self.off)

    def append_in_place(self, fn, caches, planes):
        """The in-place append (``append_quantized_rows`` or its plain
        twin) into ``caches`` and ``planes`` ([2, L, N], grown in place)."""
        return fn(self.k_new, self.v_new, caches[0], caches[1], planes[0],
                  planes[1], self.blk, self.off)


def check_quant_kernels(torch, qi: QuantInputs) -> dict:
    """The grouped GEMM (both codes, both projections, decode and prefill
    rows) against its plain twin at 2e-2 with the unowned rows exactly 0,
    and the quantized append bit-exact (page 0 excluded)."""
    from dynamo_tpu_torch.ops import kv_cache_update as kvu
    from dynamo_tpu_torch.ops import moe_gmm

    errs = {}
    for label in ("decode", "prefill"):
        for mode in ("int8", "fp8_e4m3"):
            for proj in ("gate", "down"):
                got = qi.gmm(moe_gmm.ragged_int8_gmm, label, mode, proj)
                ref = qi.gmm(moe_gmm.ragged_int8_plain, label, mode, proj)
                torch.cuda.synchronize()
                owned = int(qi.rows[label][1].sum())
                if not bool((got[owned:] == 0).all()):
                    raise AssertionError(f"ragged_int8_gmm {label}: unowned rows "
                                         "must be exactly 0")
                err = close(f"ragged_int8_gmm {label} {mode} {proj}", got, ref,
                            2e-2, 2e-2)
                key = "ragged_int8_gmm" + ("" if label == "decode" else " (prefill rows)")
                errs[key] = max(errs.get(key, 0.0), err)
                log(f"  ragged_int8_gmm {label} ({got.shape[0]} rows) {mode} "
                    f"{proj}: kernel vs plain max |err| {err:.3e}  OK")
    caches = qi.caches.clone()
    got = qi.append(kvu.kv_cache_append_quantized, caches)
    plain = qi.caches.clone()
    ref = qi.append(kvu.kv_cache_append_quantized_plain, plain)
    torch.cuda.synchronize()
    if not (torch.equal(caches[:, :, :, 1:], plain[:, :, :, 1:])
            and torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
            and int(got[4]) == int(ref[4])):
        raise AssertionError("kv_cache_append_quantized: not bit-exact with "
                             "its plain twin")
    log(f"  kv_cache_append_quantized (L=32, B=8, {int(got[4])} scale entries "
        "grew): bit-exact except the trash page  OK")
    del caches, plain
    check_fused_append(torch, qi)
    errs["kv_cache_append_quantized"] = 0.0
    return errs


def check_fused_append(torch, qi: QuantInputs) -> None:
    """The in-place quantized append (one ``kv_append_quant_kernel``
    launch) against its plain twin at Llama-3-8B's widths over phase 2's
    int8 pool: B = 1, 8 and 64 rows with 0, 2 and B - 1 of them padded
    (on the trash page 0), bf16 and f32 rows, every other live page's
    scale set high enough to hold. Codes bit-exact off page 0, both planes
    grown in place and bit-equal, n_requants equal; a second launch on the
    same inputs bit-equal to the first, page 0 included."""
    from dynamo_tpu_torch.ops import kv_cache_update as kvu

    dev = qi.caches.device
    L, Hkv, N, bs, D = qi.caches.shape[1:]
    for B, padded in ((1, 0), (8, 0), (8, 2), (8, 7), (64, 0), (64, 2), (64, 63)):
        g = torch.Generator(device=dev).manual_seed(100 * B + padded)
        blk = torch.randperm(N - 1, generator=g, device=dev)[:B] + 1
        planes = qi.scales.clone()
        planes[:, :, blk[::2]] = 1.0  # these pages keep their scale
        blk[torch.randperm(B, generator=g, device=dev)[:padded]] = 0
        blk = blk.to(torch.int32)
        off = torch.randint(0, bs, (B,), generator=g, device=dev, dtype=torch.int32)
        for dt in (torch.bfloat16, torch.float32):
            # wider than the pool's rows, so most other pages grow
            k_new = (torch.randn(L, B, Hkv, D, generator=g, device=dev) * 2).to(dt)
            v_new = (torch.randn(L, B, Hkv, D, generator=g, device=dev) * 1.5).to(dt)
            pc, pp = qi.caches.clone(), planes.clone()
            n_ref = kvu.append_quantized_rows_plain(k_new, v_new, pc[0], pc[1],
                                                    pp[0], pp[1], blk, off)
            runs = []
            for _ in range(2):
                c, pl = qi.caches.clone(), planes.clone()
                n = kvu.append_quantized_rows(k_new, v_new, c[0], c[1], pl[0],
                                              pl[1], blk, off)
                runs.append((c, pl, n))
            torch.cuda.synchronize()
            (c, pl, n), (c2, pl2, n2) = runs
            tag = f"fused quantized append, B={B}, {padded} padded, {dt}"
            if not (torch.equal(c[:, :, :, 1:], pc[:, :, :, 1:])
                    and torch.equal(pl, pp) and int(n) == int(n_ref)):
                raise AssertionError(f"{tag}: not bit-exact with its plain twin")
            if not (torch.equal(c2, c) and torch.equal(pl2, pl) and int(n2) == int(n)):
                raise AssertionError(f"{tag}: two launches differ")
            del runs, c, pl, c2, pl2, pc, pp
        log(f"  kv_cache_append_quantized in place (B={B}, {padded} padded, "
            f"bf16 and f32 rows, {int(n)} scale entries grew): bit-exact off "
            "the trash page, planes and n_requants equal, two launches "
            "bit-equal  OK")


def check_int8_native_mm(torch, dev) -> None:
    """``_mm`` with int8_native weights (Llama-3-8B's wo, 4096 x 4096) on
    the card (``torch._int_mm`` on the column-major codes, 8 and 40 rows)
    against the same function on the CPU (an int32 product): the same
    activation codes and exact integer sums, so equal to f32 rounding of
    the epilogue (rtol 1e-6). A tiny model is no test of this: its f32
    activations round apart between the two devices, and a code that
    flips moves the logits by a quantization step."""
    from dynamo_tpu_torch.models.llama import _mm
    from dynamo_tpu_torch.models.quant import quantize_array

    gen = torch.Generator(device=dev).manual_seed(4)
    w = quantize_array(torch.randn(4096, 4096, generator=gen, device=dev,
                                   dtype=torch.bfloat16) * 0.02, "int8_native")
    assert w["qn"].stride() == (1, 4096)
    cw = {k: v.cpu() for k, v in w.items()}
    for rows in (8, 40):
        x = torch.randn(rows, 4096, generator=gen, device=dev, dtype=torch.bfloat16)
        got = _mm(x, w)
        ref = _mm(x.cpu(), cw)
        err = close(f"int8_native _mm, {rows} rows", got.cpu(), ref, 1e-6, 1e-6)
        log(f"  int8_native _mm (torch._int_mm), {rows} rows x 4096 x 4096: card "
            f"vs CPU max |err| {err:.3e}  OK")


def close(name, got, ref, rtol, atol):
    """Max |got - ref|; raises when any element is outside rtol/atol."""
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol={rtol} "
            f"atol={atol}, max |err| {float(err.max())}"
        )
    return float(err.max())


def close_stats(name, got, ref):
    (m, l), (rm, rl) = got, ref
    close(f"{name} m", m, rm, 1e-3, 1e-3)
    close(f"{name} l", l, rl, 1e-3, 1e-3)


def check_mla_kernels(torch, mi: MlaInputs) -> dict:
    from dynamo_tpu_torch.ops import kv_cache_update as kvu
    from dynamo_tpu_torch.ops import mla_attention as mla

    errs = {}
    o, m, l = mi.decode(mla.mla_paged_decode_attention)
    ro, rm, rl = mi.decode(mla.mla_paged_decode_attention_plain)
    torch.cuda.synchronize()
    errs["mla_paged_decode_attention"] = close("mla decode o", o, ro, 2e-2, 2e-2)
    close_stats("mla decode", (m, l), (rm, rl))
    if not (bool((o[7] == 0).all()) and bool((m[7] == -1e30).all())
            and bool((l[7] == 0).all())):
        raise AssertionError("mla decode: the empty slot must give o=0, "
                             "m=-1e30, l=0")
    # one launch per decode call: the splits merge inside it (no combine).
    # A trace that caught no kernel at all says nothing (the profiler now
    # and then records no device events): it is taken again, up to 3 times
    from torch.profiler import ProfilerActivity, profile

    for what, call in (("decode", lambda: mi.decode(mla.mla_paged_decode_attention)),
                       ("verify rows", lambda: mi.verify_rows(
                           mla.mla_paged_decode_attention))):
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            if names:
                break
        if len(names) != 1 or "mla_tc_kernel" not in names[0]:
            raise AssertionError(f"mla {what}: one mla_tc_kernel launch per "
                                 f"call, got {names}")
    log("  mla_paged_decode_attention (decode, verify rows): one "
        "mla_tc_kernel launch per call  OK")
    got = mi.prefill(mla.mla_paged_prefill_attention)
    ref = mi.prefill(mla.mla_paged_prefill_attention_plain)
    torch.cuda.synchronize()
    if got.dtype != torch.float32:
        raise AssertionError("mla prefill must return f32 like the TPU kernel")
    errs["mla_paged_prefill_attention"] = close("mla prefill", got, ref, 2e-2, 2e-2)
    close_stats("mla prefill", *mi.prefill_stats())
    kc, vc = mi.a_kc.clone(), mi.a_vc.clone()
    mi.append(kvu.kv_cache_append, kc, vc)
    mi.append(kvu.kv_cache_append_plain)
    torch.cuda.synchronize()
    if not (torch.equal(kc, mi.a_kc) and torch.equal(vc, mi.a_vc)):
        raise AssertionError("kv_cache_append at MLA widths: not bit-exact")
    for name in ("mla_paged_decode_attention", "mla_paged_prefill_attention"):
        log(f"  {name}: kernel vs plain max |err| {errs[name]:.3e}  OK")
    log("  kv_cache_append at MLA widths (C=512 / R=64): bit-exact  OK")
    return errs


def check_mla_fp8(torch, dev, mi: MlaInputs, ta: "TokenAppendInputs") -> dict:
    """Both latent kernels over float8_e4m3fn latent pages (bf16 queries;
    the pages to_e4m3 of phase 2's seeded bf16 draw) against their plain
    twins on the same page bytes, at the bf16 checks' tolerances (outputs
    2e-2, (m, l) rtol 1e-3: the widen is exact): on the tensor-core body at
    V2-Lite's widths decode with (m, l), the verify's history rows (T = 4,
    64 rows per sequence) and the whole verify, and a 512-token prefill
    chunk on 1000 cached; on the CUDA-core body at C = 1024, R = 64 decode
    and prefill; on the tensor-core body's element path for rope rows
    that are not whole 16-byte copies (C = 128, R = 8) decode and prefill.
    Then the latent row store into fp8 pages at MLA widths (all 27 layers,
    B = 8; the verify's T = 4 rows too), with values above 464 and +-inf
    among the rows, byte-equal to its plain twin (models/quant.to_e4m3:
    the reference's NaN above 464). Returns the errors of the two fp8
    rows."""
    from dynamo_tpu_torch.models.quant import to_e4m3
    from dynamo_tpu_torch.ops import kv_cache_update as kvu
    from dynamo_tpu_torch.ops import mla_attention as mla

    fp8 = torch.float8_e4m3fn
    m8 = mi.fp8()
    errs = {}
    o, m, l = m8.decode(mla.mla_paged_decode_attention)
    ro, rm, rl = m8.decode(mla.mla_paged_decode_attention_plain)
    torch.cuda.synchronize()
    errs["mla_paged_decode_attention" + FP8_KV] = close(
        "mla decode over fp8 pages", o, ro, 2e-2, 2e-2)
    close_stats("mla decode over fp8 pages", (m, l), (rm, rl))
    if not (bool((o[7] == 0).all()) and bool((l[7] == 0).all())):
        raise AssertionError("mla decode over fp8 pages: the empty slot")
    got = m8.verify_rows(mla.mla_paged_decode_attention)
    ref = m8.verify_rows(mla.mla_paged_decode_attention_plain)
    torch.cuda.synchronize()
    err_v = close("mla verify rows over fp8 pages", got[0], ref[0], 2e-2, 2e-2)
    close_stats("mla verify rows over fp8 pages", got[1:], ref[1:])
    err_v = max(err_v, close("mla verify over fp8 pages",
                             m8.verify(mla.mla_verify_attention),
                             m8.verify(mla.mla_verify_attention_xla), 2e-2, 2e-2))
    got = m8.prefill(mla.mla_paged_prefill_attention)
    ref = m8.prefill(mla.mla_paged_prefill_attention_plain)
    torch.cuda.synchronize()
    errs["mla_paged_prefill_attention" + FP8_KV] = close(
        "mla prefill over fp8 pages", got, ref, 2e-2, 2e-2)
    log(f"  MLA over fp8 latent pages (tensor-core body, C={mi.C}, R={mi.R}): "
        f"decode {errs['mla_paged_decode_attention' + FP8_KV]:.3e}, verify "
        f"{err_v:.3e}, prefill {errs['mla_paged_prefill_attention' + FP8_KV]:.3e} "
        "max |err| vs plain, (m, l) within 1e-3  OK")
    for C, R, body in ((1024, 64, "CUDA-core"), (128, 8, "tensor-core, element pe")):
        wi = MlaInputs(torch, dev, C=C, R=R).fp8()
        if mla.tc_takes(C, R) != (body != "CUDA-core"):
            raise AssertionError(f"C={C} R={R}: not the {body} body")
        o, m, l = wi.decode(mla.mla_paged_decode_attention)
        ro, rm, rl = wi.decode(mla.mla_paged_decode_attention_plain)
        got = wi.prefill(mla.mla_paged_prefill_attention)
        ref = wi.prefill(mla.mla_paged_prefill_attention_plain)
        torch.cuda.synchronize()
        e_d = close(f"fp8 C={C} R={R} decode", o, ro, 2e-2, 2e-2)
        close_stats(f"fp8 C={C} R={R} decode", (m, l), (rm, rl))
        e_p = close(f"fp8 C={C} R={R} prefill", got, ref, 2e-2, 2e-2)
        log(f"  MLA over fp8 latent pages at C={C}, R={R} ({body} body): decode "
            f"{e_d:.3e}, prefill {e_p:.3e} max |err| vs plain  OK")
        del wi
    # the latent row store's cast on store at MLA widths
    c_new, pe_new = mi.c_new.clone(), mi.pe_new.clone()
    flat = c_new.view(-1)
    special = torch.tensor([464.0, -466.0, 500.0, -1e4, float("inf"),
                            -float("inf"), 2.0 ** -10, 448.0], device=dev)
    flat[torch.arange(special.numel(), device=dev) * 997] = special.to(flat.dtype)
    kc, vc = to_e4m3(mi.a_kc), to_e4m3(mi.a_vc)
    rk, rv = kc.clone(), vc.clone()
    kvu.kv_cache_append(c_new, pe_new, kc, vc, mi.a_blk, mi.a_off)
    kvu.kv_cache_append_plain(c_new, pe_new, rk, rv, mi.a_blk, mi.a_off)
    tk, tv = to_e4m3(mi.a_kc), to_e4m3(mi.a_vc)
    rtk, rtv = tk.clone(), tv.clone()
    ta.append(kvu.kv_cache_append_tokens, "mla", caches=(tk, tv))
    ta.append(kvu.kv_cache_append_tokens_plain, "mla", caches=(rtk, rtv))
    torch.cuda.synchronize()
    # the verify's padded slots race on the trash page 0: excluded
    if not (kc.dtype == fp8 and same_bytes(torch, kc, rk) and same_bytes(torch, vc, rv)
            and same_bytes(torch, tk[:, :, 1:], rtk[:, :, 1:])
            and same_bytes(torch, tv[:, :, 1:], rtv[:, :, 1:])):
        raise AssertionError("the row stores into fp8 pages at MLA widths: "
                             "bytes differ from the plain twins'")
    nan = int(((kc.view(torch.uint8) & 0x7F) == 0x7F).sum())
    if nan < 5:
        raise AssertionError(f"fp8 MLA store: {nan} NaN bytes for the 5 values "
                             "beyond 464")
    errs["kv_cache_append (MLA widths, fp8 KV)"] = 0.0
    log(f"  kv_cache_append into fp8 latent pages (L={c_new.shape[0]}, B=8, "
        f"C={mi.C}, R={mi.R}; {nan} NaN bytes from values beyond 464) and "
        "kv_cache_append_tokens (T=4; the trash page 0 excluded): byte-equal "
        "to the plain twins  OK")
    return errs


def check_attention(torch, inp: KernelInputs, tag: str = "") -> dict:
    """The three GQA attention entry points against their plain versions
    (outputs 2e-2, (m, l) 1e-3, the empty slot's o=0, m=-1e30, l=0)."""
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import ragged_paged_attention as rpa

    errs = {}
    o, m, l = inp.decode(pa.paged_decode_attention)
    ro, rm, rl = inp.decode(pa.paged_decode_attention_plain)
    torch.cuda.synchronize()
    errs["paged_decode_attention" + tag] = close("decode o" + tag, o, ro, 2e-2, 2e-2)
    close_stats("decode" + tag, (m, l), (rm, rl))
    if not (bool((o[7] == 0).all()) and bool((m[7] == -1e30).all())
            and bool((l[7] == 0).all())):
        raise AssertionError("decode: the empty slot must give o=0, m=-1e30, l=0")
    got = inp.prefill(pa.paged_prefill_attention)
    ref = inp.prefill(pa.paged_prefill_attention_plain)
    torch.cuda.synchronize()
    errs["paged_prefill_attention" + tag] = close("prefill" + tag, got, ref, 2e-2, 2e-2)
    close_stats("prefill" + tag, *inp.prefill_stats())
    got = inp.ragged(rpa.ragged_mixed_attention)
    ref = inp.ragged(rpa.ragged_mixed_attention_plain)
    torch.cuda.synchronize()
    errs["ragged_mixed_attention" + tag] = max(
        close("ragged decode rows" + tag, got[0], ref[0], 2e-2, 2e-2),
        close("ragged segments" + tag, got[1], ref[1], 2e-2, 2e-2),
    )
    close_stats("ragged" + tag, *inp.ragged_stats())
    return errs


def same_bytes(torch, a, b) -> bool:
    """Bit for bit: fp8 tensors through their bytes (NaN bytes included,
    which a value comparison calls unequal), others by torch.equal."""
    if a.dtype == torch.float8_e4m3fn or b.dtype == torch.float8_e4m3fn:
        return a.dtype == b.dtype and torch.equal(a.view(torch.uint8),
                                                  b.view(torch.uint8))
    return torch.equal(a, b)


def check_kernels(torch, dev, inp: KernelInputs) -> dict:
    from dynamo_tpu_torch.models.quant import to_e4m3
    from dynamo_tpu_torch.ops import kv_cache_update as kvu

    errs = {**check_attention(torch, inp),
            **check_attention(torch, inp.scaled(), INT8_KV),
            **check_attention(torch, inp.fp8(), FP8_KV)}
    kc, vc = inp.a_kc.clone(), inp.a_vc.clone()
    inp.append(kvu.kv_cache_append, kc, vc)
    inp.append(kvu.kv_cache_append_plain)
    torch.cuda.synchronize()
    if not (torch.equal(kc, inp.a_kc) and torch.equal(vc, inp.a_vc)):
        raise AssertionError("kv_cache_append: not bit-exact with index_put_")
    errs["kv_cache_append"] = 0.0
    # bf16 rows into fp8 caches: the cast on store against to_e4m3
    kc, vc = to_e4m3(inp.a_kc), to_e4m3(inp.a_vc)
    pk, pv = kc.clone(), vc.clone()
    inp.append(kvu.kv_cache_append, kc, vc)
    inp.append(kvu.kv_cache_append_plain, pk, pv)
    torch.cuda.synchronize()
    if not (same_bytes(torch, kc, pk) and same_bytes(torch, vc, pv)):
        raise AssertionError("kv_cache_append into fp8 caches: not byte-equal "
                             "to the plain cast")
    errs["kv_cache_append" + FP8_KV] = 0.0
    for name, e in errs.items():
        log(f"  {name}: kernel vs plain max |err| {e:.3e}  OK")
    return errs


def check_e4m3_store(torch, dev) -> None:
    """The row store's cast into an fp8 cache, and models/quant.to_e4m3 run
    on the card, byte for byte against to_e4m3 on the CPU (the reference's
    cast: the CPU tests hold it to jnp's astype): all 65 536 bf16 bit
    patterns as the rows of
    one kv_cache_append launch (L=8, B=8, Hkv=8, D=128; the 16-byte path;
    NaN bytes for |x| > 464 and +-inf, where the card's satfinite cvt
    saturates), then seeded f32 rows (N(0, 200) with the edges 464 / 465 /
    466, +-inf, NaN and subnormal-sized values) through
    kv_cache_append_tokens at D = 128 (16-byte path) and at D = 6 (element
    stores)."""
    from dynamo_tpu_torch.models.quant import to_e4m3
    from dynamo_tpu_torch.ops import kv_cache_update as kvu

    fp8 = torch.float8_e4m3fn
    bits = (torch.arange(1 << 16, dtype=torch.int32) - (1 << 15)).to(torch.int16)
    rows = bits.view(torch.bfloat16).reshape(8, 8, 8, 128)
    L, B, Hkv, D = rows.shape
    kc = torch.zeros(L, Hkv, 12, 16, D, dtype=fp8, device=dev)
    vc = torch.zeros_like(kc)
    blk = torch.arange(1, B + 1, dtype=torch.int32, device=dev)
    off = torch.arange(B, dtype=torch.int32, device=dev) * 2
    kvu.kv_cache_append(rows.to(dev), rows.flip(0).to(dev), kc, vc, blk, off)
    torch.cuda.synchronize()
    b, o = blk.long(), off.long()
    got_k = kc.view(torch.uint8)[:, :, b, o].permute(0, 2, 1, 3).cpu()
    got_v = vc.view(torch.uint8)[:, :, b, o].permute(0, 2, 1, 3).cpu()
    want = to_e4m3(rows).view(torch.uint8)
    if not (torch.equal(got_k, want) and torch.equal(got_v, want.flip(0))):
        bad = int((got_k != want).sum())
        raise AssertionError(f"fp8 cast on store, bf16 grid: {bad} of 65536 "
                             "bytes differ from the reference's cast")
    nan = int(((want & 0x7F) == 0x7F).sum())
    # the plain cast itself on the card (write_slots lands prefill chunks
    # and fused-step rows through it there)
    if not torch.equal(to_e4m3(rows.to(dev)).view(torch.uint8).cpu(), want):
        raise AssertionError("models/quant.to_e4m3 on the card: bytes differ "
                             "from the CPU's over the bf16 grid")
    g = torch.Generator().manual_seed(13)
    for D in (128, 6):
        T, L, B, Hkv = 4, 2, 8, 2
        x = torch.randn(2, L, B, T, Hkv, D, generator=g) * 200
        flat = x.view(-1)
        special = torch.tensor([464.0, -464.0, 465.0, -466.0, 1e6, float("inf"),
                                -float("inf"), float("nan"), 2.0 ** -10, -2.0 ** -9,
                                1e-30, -0.0, 448.0, 456.0, 3e-3, -7.5])
        flat[torch.randperm(flat.numel(), generator=g)[: special.numel()]] = special
        kc = torch.zeros(L, Hkv, B * T + 1, 16, D, dtype=fp8, device=dev)
        vc = torch.zeros_like(kc)
        blk = torch.arange(1, B * T + 1, dtype=torch.int32, device=dev).reshape(B, T)
        off = torch.full((B, T), 5, dtype=torch.int32, device=dev)
        kvu.kv_cache_append_tokens(x[0].to(dev), x[1].to(dev), kc, vc, blk, off)
        torch.cuda.synchronize()
        for cache, rows_f in ((kc, x[0]), (vc, x[1])):
            got = cache.view(torch.uint8)[:, :, blk.long(), 5].permute(
                0, 2, 3, 1, 4).cpu()
            ref = to_e4m3(rows_f).view(torch.uint8)
            if not (torch.equal(got, ref) and torch.equal(
                    to_e4m3(rows_f.to(dev)).view(torch.uint8).cpu(), ref)):
                raise AssertionError(f"fp8 cast on store, f32 rows at D={D}: "
                                     "bytes differ from the reference's cast")
    log(f"  kv_rows_kernel's fp8 cast on store and to_e4m3 on the card: all "
        f"65536 bf16 patterns ({nan} NaN bytes) and f32 rows at D=128 (16-byte "
        "path) and D=6 (element stores) byte-equal to the reference's cast  OK")


def check_odd_group(torch, dev) -> dict:
    """A head layout the Llama shapes do not reach: G = 7 (H=28, Hkv=4,
    D=128, Qwen2-7B's), so a tensor-core tile's rows (18 tokens x 7 heads)
    do not fill its last 16-row group, nor do a decode block's 7 rows; a
    ragged launch of 3 decode rows (one inactive) and 2 segments of T=160:
    history 333 (no multiple of 16 or 64) with 117 real rows, and a dead
    one; bf16, int8 and fp8 pages. o within 2e-2 of the plain versions, (m, l)
    within rtol 1e-3 of the plain softmax, dead rows o = 0, m = -1e30,
    l = 0. Also the prefill entry point with valid_len over the same rows,
    and the decode entry point over the same decode rows."""
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import ragged_paged_attention as rpa

    g = torch.Generator(device=dev).manual_seed(7)
    Hkv, G, D, bs, M, N = 4, 7, 128, 16, 40, 400
    H, T, valid, hist, scale = Hkv * G, 160, 117, 333, D ** -0.5
    tables = (torch.randperm(N - 1, generator=g, device=dev)[: 5 * M] + 1)
    tables = tables.reshape(5, M).to(torch.int32)
    lens = torch.tensor([0, 17, 611], dtype=torch.int32, device=dev)
    qd = torch.randn(3, H, D, generator=g, device=dev).bfloat16()
    qc = torch.randn(2, T, H, D, generator=g, device=dev).bfloat16()
    p_tab = torch.stack([tables[3], torch.zeros_like(tables[3])])
    p_h = torch.tensor([hist, 0], dtype=torch.int32, device=dev)
    p_v = torch.tensor([valid, 0], dtype=torch.int32, device=dev)
    kc = torch.randn(Hkv, N, bs, D, generator=g, device=dev).bfloat16()
    vc = torch.randn(Hkv, N, bs, D, generator=g, device=dev).bfloat16()
    from dynamo_tpu_torch.models.quant import to_e4m3

    errs = {}
    for label, caches in (("bf16", (kc, vc, None, None)),
                          ("int8 pages", quantized_pages(torch, kc, vc)),
                          ("fp8 pages", (to_e4m3(kc), to_e4m3(vc), None, None))):
        k, v, ks, vs = caches
        sc = {} if ks is None else {"k_scales": ks, "v_scales": vs}
        args = (qd, qc, k, v, tables[:3], lens, p_tab, p_h, p_v, scale)
        got = rpa.ragged_mixed_attention(*args, **sc)
        ref = rpa.ragged_mixed_attention_plain(*args, ks, vs)
        pre = pa.paged_prefill_attention(qc[0], k, v, tables[3], p_h[:1], scale,
                                         valid_len=valid, **sc)
        pre_ref = pa.paged_prefill_attention_plain(qc[0], k, v, tables[3],
                                                   p_h[:1], scale, valid, ks, vs)
        o, m, l = pa.launch_paged_attention(
            torch.cat([qd, qc.reshape(2 * T, H, D)]).reshape(-1, Hkv, G, D), k, v,
            scale, d_tables=tables[:3], d_seq_lens=lens, p_tables=p_tab,
            p_hists=p_h, p_valids=p_v, T=T, stats=True, **sc)
        torch.cuda.synchronize()
        err = max(close(f"G=7 ragged decode rows, {label}", got[0], ref[0], 2e-2, 2e-2),
                  close(f"G=7 ragged segments, {label}", got[1], ref[1], 2e-2, 2e-2),
                  close(f"G=7 prefill, {label}", pre, pre_ref, 2e-2, 2e-2))
        gk = pa.gather_pages(k, tables[:3], ks).float()
        gv = pa.gather_pages(v, tables[:3], vs).float()
        parts = [pa.masked_attention(qd.reshape(3, Hkv, G, D).float() * scale, gk,
                                     gv, lens.long() - 1)[1:]]
        t = torch.arange(T, device=dev)
        for mseg in range(2):
            limit = torch.where(t < p_v[mseg], p_h[mseg].long() + t, -1)
            gk = pa.gather_pages(k, p_tab[mseg], ks).float()[:, None]
            gv = pa.gather_pages(v, p_tab[mseg], vs).float()[:, None]
            parts.append(pa.masked_attention(
                qc[mseg].reshape(T, Hkv, G, D).float() * scale, gk, gv, limit)[1:])
        close_stats(f"G=7 ragged, {label}", (m, l),
                    tuple(torch.cat(x) for x in zip(*parts)))
        dead = [0] + list(range(3 + valid, 3 + 2 * T))
        if not (bool((o[dead] == 0).all()) and bool((m[dead] == -1e30).all())
                and bool((l[dead] == 0).all())):
            raise AssertionError(f"G=7 ragged, {label}: rows that attend nothing "
                                 "must give o=0, m=-1e30, l=0")
        # the same decode rows as a decode launch (the decode body alone)
        do, dm, dl = pa.paged_decode_attention(qd, k, v, tables[:3], lens, scale,
                                               return_stats=True, **sc)
        ro, rm, rl = pa.paged_decode_attention_plain(qd, k, v, tables[:3], lens,
                                                     scale, True, ks, vs)
        torch.cuda.synchronize()
        err = max(err, close(f"G=7 decode, {label}", do, ro, 2e-2, 2e-2))
        close_stats(f"G=7 decode, {label}", (dm, dl), (rm, rl))
        if not (bool((do[0] == 0).all()) and bool((dm[0] == -1e30).all())
                and bool((dl[0] == 0).all())):
            raise AssertionError(f"G=7 decode, {label}: the inactive slot must "
                                 "give o=0, m=-1e30, l=0")
        errs[label] = err
        log(f"  G=7 (H=28, Hkv=4), history 333, valid 117 of 160, a dead segment, "
            f"{label}: prefill, ragged and decode vs plain max |err| {err:.3e}, "
            "(m, l) within 1e-3, dead rows and the inactive slot zero  OK")
    return errs


def check_decode_rows(torch, inp: KernelInputs) -> None:
    """C.6: the decode body at (gamma + 1) * G verify rows per kv head,
    more than one 16-row block each: G = 4, gamma = 16 (68 rows) and G = 7,
    gamma = 9 (70 rows), over the Llama-3-8B caches and tables of phase 2
    (Hkv = 8, D = 128, B = 8 up to 2048 with an inactive slot), bf16, int8
    and fp8 pages, with (m, l): o within 2e-2 of the plain version, (m, l)
    within rtol 1e-3, the inactive slot o = 0, m = -1e30, l = 0."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=inp.kc.device).manual_seed(12)
    for G, gamma in ((4, 16), (7, 9)):
        rows = (gamma + 1) * G
        q = torch.randn(8, inp.Hkv * rows, inp.D, generator=g,
                        device=inp.kc.device).bfloat16()
        for label, x in (("bf16", inp), ("int8 pages", inp.scaled()),
                         ("fp8 pages", inp.fp8())):
            args = (q, x.kc, x.vc, x.d_tables, x.d_lens, inp.scale)
            o, m, l = pa.paged_decode_attention(*args, return_stats=True,
                                                group=G, **x.sc)
            ro, rm, rl = pa.paged_decode_attention_plain(*args, return_stats=True,
                                                         **x.sc)
            torch.cuda.synchronize()
            err = close(f"{rows} verify rows, {label}", o, ro, 2e-2, 2e-2)
            close_stats(f"{rows} verify rows, {label}", (m, l), (rm, rl))
            if not (bool((o[7] == 0).all()) and bool((m[7] == -1e30).all())
                    and bool((l[7] == 0).all())):
                raise AssertionError(f"{rows} verify rows: the empty slot must "
                                     "give o=0, m=-1e30, l=0")
            log(f"  paged_decode_attention, {rows} rows per kv head (G={G}, "
                f"gamma={gamma}), {label}: max |err| {err:.3e}, (m, l) within "
                "1e-3, empty slot zero  OK")


def nan_below(torch, x: KernelInputs, cuts: dict):
    """A copy of ``x`` whose pages wholly below each table's cut (``{table
    row tensor: first position kept}``) are NaN: the bf16 or fp8 pages
    themselves, or for int8 pages their scales. Pages the kernel skips
    are never read; a page it reads and masks would turn its output NaN
    (0 x NaN in the value product)."""
    import copy

    other = copy.copy(x)
    scaled = bool(x.sc)
    kc, vc = x.kc.clone(), x.vc.clone()
    ks = x.sc.get("k_scales")
    vs = x.sc.get("v_scales")
    ks, vs = (ks.clone(), vs.clone()) if scaled else (None, None)
    for table, cut in cuts:
        pages = table[: max(cut, 0) // x.bs].long()
        if scaled:
            ks[pages] = float("nan")
            vs[pages] = float("nan")
        elif kc.dtype == torch.float8_e4m3fn:  # 0x7F: e4m3fn's NaN
            kc.view(torch.uint8)[:, pages] = 0x7F
            vc.view(torch.uint8)[:, pages] = 0x7F
        else:
            kc[:, pages] = float("nan")
            vc[:, pages] = float("nan")
    other.kc, other.vc = kc, vc
    if scaled:
        other.sc = {"k_scales": ks, "v_scales": vs}
    return other


def sink_scale(torch, with_sinks, without):
    """Per row and head (the last dimension D reduced): the factor that
    takes the sinkless o to the o with the sink folded, as the projection
    <a, b> / <b, b>; NaN where the row attended nothing."""
    a, b = with_sinks.float(), without.float()
    den = (b * b).sum(-1)
    return torch.where(den > 1e-12, (a * b).sum(-1) / den.clamp_min(1e-12),
                       float("nan"))


def check_windowed(torch, inp: KernelInputs, where: str,
                   names=(WINDOW, WINDOW_SINKS)) -> dict:
    """The gpt-oss options of the three GQA kernels against their plain
    versions, bf16, int8 and fp8 pages: the merged decode's call (window floors
    one past the cache, (m, l)), the verify's T*G rows (a floor per
    token), decode rows with the sink folded, prefill and the ragged call
    with the window and the sinks (``inp`` without sinks: Gemma-3's
    windows alone, decode rows at seq_len - 1 without (m, l)). Outputs
    within 2e-2, (m, l) within
    rtol 1e-3, the empty slot o = 0, m = -1e30, l = 0. The sink launches
    against the same launches without sinks: the scale the sink puts on
    each row's o within 1e-2 of the plain versions', the sinks holding at
    least 10% of the mass on average. ``names``: the row-name suffixes of
    the decode row and of the prefill and ragged rows. Then the pages
    wholly below each tile's first step (the decode bodies step 16
    positions, the segment tiles 64 from the tile's first token's floor)
    are made NaN: every output stays finite and bit-equal, so the walks
    skip those pages and do not mask them."""
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import ragged_paged_attention as rpa

    W, bs = inp.window, inp.bs
    errs = {}
    for label, x, tag in (("bf16", inp, ""), ("int8 pages", inp.scaled(), INT8_KV),
                          ("fp8 pages", inp.fp8(), FP8_KV)):
        folded = ("decode, sink folded" if x.sinks is not None
                  else "decode rows, no (m, l)")
        calls = {
            "decode (merged decode's call)": (x.decode, pa.paged_decode_attention,
                                              pa.paged_decode_attention_plain),
            "verify rows": (x.verify_rows, pa.paged_decode_attention,
                            pa.paged_decode_attention_plain),
            folded: (x.decode_sinks, pa.paged_decode_attention,
                     pa.paged_decode_attention_plain),
            "prefill": (x.prefill, pa.paged_prefill_attention,
                        pa.paged_prefill_attention_plain),
            "ragged": (x.ragged, rpa.ragged_mixed_attention,
                       rpa.ragged_mixed_attention_plain),
        }
        outs, worst = {}, {}
        for what, (call, kernel, plain) in calls.items():
            got, ref = call(kernel), call(plain)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            outs[what] = got
            if what in ("decode (merged decode's call)", "verify rows"):
                worst[what] = close(f"{what}, {label}", got[0], ref[0], 2e-2, 2e-2)
                close_stats(f"{what}, {label}", got[1:], ref[1:])
                o, m, l = got
                if not (bool((o[7] == 0).all()) and bool((m[7] == -1e30).all())
                        and bool((l[7] == 0).all())):
                    raise AssertionError(f"{what}, {label}: the empty slot must "
                                         "give o=0, m=-1e30, l=0")
            else:
                worst[what] = max(close(f"{what}, {label}", a, b, 2e-2, 2e-2)
                                  for a, b in zip(got, ref))
        # each sink launch against the same launch without sinks: the
        # sink only rescales a row's o, by l / (l + e^(s - m)); that scale
        # (o projected on the sinkless o over D, per row and head) held to
        # the plain versions' at 1e-2, where a dropped sink or another
        # head's sink moves it by tenths
        bare, scaled = x.without_sinks(), {}
        for what in ((folded, "prefill", "ragged")
                     if x.sinks is not None else ()):
            call, kernel, plain = calls[what]
            scales = []
            for fn in (kernel, plain):
                with_s = call.__func__(x, fn)
                without = call.__func__(bare, fn)
                with_s = with_s if isinstance(with_s, tuple) else (with_s,)
                without = without if isinstance(without, tuple) else (without,)
                scales.append(torch.cat([sink_scale(torch, a, b).flatten()
                                         for a, b in zip(with_s, without)]))
            torch.cuda.synchronize()
            live = ~torch.isnan(scales[1])
            off = float((scales[0] - scales[1])[live].abs().max())
            share = float(1 - scales[1][live].mean())
            if not (bool(torch.isfinite(scales[0][live]).all()) and off <= 1e-2
                    and share >= 0.1):
                raise AssertionError(
                    f"{what}, {label}: the sink's scale of o is {off:.3e} from "
                    f"the plain version's (tolerance 1e-2); the sinks hold "
                    f"{share:.1%} of the mass (at least 10% expected)")
            scaled[what] = (off, share)
        # the pages below every tile's first step made NaN: each decode
        # row's (its lowest floor: len - W, the sink decode's), the prefill
        # chunk's first tile's, the ragged live segment's first tile's
        lens = x.d_lens.tolist()
        cuts = [(x.d_tables[b], (n - W) // 16 * 16) for b, n in enumerate(lens) if n]
        cuts.append((x.p_table, (int(x.hist) - W + 1) // 64 * 64))
        cuts.append((x.r_tables[0], (int(x.r_hists[0]) - W + 1) // 64 * 64))
        poisoned = nan_below(torch, x, cuts)
        skipped = sum(max(c, 0) // bs for _t, c in cuts)
        bad = []
        for what, (call, kernel, _plain) in calls.items():
            again = call.__func__(poisoned, kernel)
            again = again if isinstance(again, tuple) else (again,)
            torch.cuda.synchronize()
            for a, b in zip(outs[what], again):
                if not (torch.equal(a, b) and bool(torch.isfinite(b).all())):
                    bad.append(what)
        if bad:
            raise AssertionError(f"window {W}, {label}: pages below the walks' "
                                 f"first steps were read by {bad}")
        errs["paged_decode_attention" + names[0] + tag] = worst[
            "decode (merged decode's call)"]
        errs["paged_prefill_attention" + names[1] + tag] = worst["prefill"]
        errs["ragged_mixed_attention" + names[1] + tag] = worst["ragged"]
        sink_note = ("; the sink's scale of o vs plain: " + ", ".join(
            f"{k} {v:.2e} (sinks {sh:.0%} of the mass)"
            for k, (v, sh) in scaled.items()) if scaled else "")
        log(f"  window {W}{' + sinks' if x.sinks is not None else ''} at "
            f"H={inp.H}, Hkv={inp.Hkv}, D={inp.D}, "
            f"{label}: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
            + " max |err| vs plain, (m, l) within 1e-3" + sink_note
            + f"; {skipped} pages below "
            f"the first steps made NaN: outputs bit-equal and finite  OK"
            f"  [{where}]")
    return errs


def check_wide_appends(torch, dev, inp: KernelInputs) -> None:
    """The three appends at a wide head (``inp``'s D, Gemma-3's 256), each
    against its plain twin: ``kv_cache_append`` into bf16 caches bit for
    bit and into fp8 caches byte for byte (L=32, B=8 over ``inp``'s append
    caches); ``kv_cache_append_tokens`` (L=4, B=8, T=4 windows crossing
    pages, two padded slots on the trash page 0) into bf16 and fp8 caches;
    ``kv_cache_append_quantized`` (L=4, B=8, two padded rows) into int8
    pages with per-page scales: codes, planes and n_requants equal (page 0
    excluded: padded rows race there)."""
    from dynamo_tpu_torch.models.quant import to_e4m3
    from dynamo_tpu_torch.ops import kv_cache_update as kvu

    for label, (kc, vc) in (("bf16", (inp.a_kc, inp.a_vc)),
                            ("fp8", (to_e4m3(inp.a_kc), to_e4m3(inp.a_vc)))):
        got = (kc.clone(), vc.clone())
        ref = (kc.clone(), vc.clone())
        inp.append(kvu.kv_cache_append, *got)
        inp.append(kvu.kv_cache_append_plain, *ref)
        torch.cuda.synchronize()
        if not all(same_bytes(torch, a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"kv_cache_append at D={inp.D} into {label} "
                                 "caches: not byte-equal to the plain version")
        del got, ref
    g = torch.Generator(device=dev).manual_seed(21)
    L, B, T, Hkv, D, N, bs = 4, 8, SPEC_GAMMA + 1, inp.Hkv, inp.D, 64, inp.bs
    pages = (torch.randperm(N - 1, generator=g, device=dev)[: 2 * B] + 1).reshape(B, 2)
    start = torch.randint(0, bs, (B,), generator=g, device=dev)
    pos = start[:, None] + torch.arange(T, device=dev)[None]
    blk = torch.gather(pages, 1, pos // bs)
    blk[[3, 6]] = 0  # padded slots: every row on the trash page
    blk, off = blk.to(torch.int32), (pos % bs).to(torch.int32)
    new = [torch.randn(L, B, T, Hkv, D, generator=g, device=dev).bfloat16()
           for _ in range(2)]
    base = [torch.randn(L, Hkv, N, bs, D, generator=g, device=dev).bfloat16()
            for _ in range(2)]
    for label, caches in (("bf16", base), ("fp8", [to_e4m3(c) for c in base])):
        got = [c.clone() for c in caches]
        ref = [c.clone() for c in caches]
        kvu.kv_cache_append_tokens(*new, *got, blk, off)
        kvu.kv_cache_append_tokens_plain(*new, *ref, blk, off)
        torch.cuda.synchronize()
        if not all(same_bytes(torch, a[:, :, 1:], b[:, :, 1:])
                   for a, b in zip(got, ref)):
            raise AssertionError(f"kv_cache_append_tokens at D={D} into {label} "
                                 "caches: not byte-equal to the plain version")
    scales = [(c.float().abs().amax(dim=(1, 3, 4)) / 127.0).contiguous()
              for c in base]  # [L, N] absmax / 127 of bf16 pages
    codes = [torch.clamp(torch.round(c.float() / s[:, None, :, None, None]),
                         -127, 127).to(torch.int8) for c, s in zip(base, scales)]
    # the new rows at twice the pages' spread: some scales grow
    qnew = [2 * x[:, :, 0].contiguous() for x in new]
    qblk = blk[:, 0].contiguous()
    qoff = off[:, 0].contiguous()
    outs = []
    for fn in (kvu.kv_cache_append_quantized, kvu.kv_cache_append_quantized_plain):
        cc = [c.clone() for c in codes]
        outs.append(fn(*qnew, *cc, *scales, qblk, qoff))
    torch.cuda.synchronize()
    got, ref = outs
    if not (all(torch.equal(a[:, :, 1:], b[:, :, 1:]) for a, b in zip(got[:2], ref[:2]))
            and torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
            and int(got[4]) == int(ref[4])):
        raise AssertionError(f"kv_cache_append_quantized at D={D}: not bit-exact "
                             "with its plain twin")
    log(f"  the appends at D={D}: kv_cache_append (L=32, B=8) and "
        f"kv_cache_append_tokens (L=4, B=8, T={T}) into bf16 and fp8 caches "
        f"byte-equal to their plain twins, kv_cache_append_quantized (L=4, "
        f"B=8, {int(got[4])} scale entries grew) bit-exact (page 0 excluded)  OK")


def check_wide_heads(torch, dev, card: str):
    """The head widths above 128 (csrc/paged_attention_wide.cu) against
    the plain versions: Gemma-3-12B's attention (H=16, Hkv=8, D=256, G=2)
    at phase 2's lengths through the three GQA kernels over bf16, int8 and
    fp8 pages (decode with (m, l), prefill, ragged, and the verify's T*G
    rows), then with its 1024-token window (check_windowed without sinks:
    the merged decode's call, the verify rows, prefill and ragged crossing
    the floors, the pages below every walk's first step made NaN); the
    appends at D=256 (check_wide_appends); and D=192 (H=16, Hkv=8) through
    the three kernels over the three page types. Outputs within 2e-2, (m,
    l) within rtol 1e-3. Returns (errors by row, the D=256 inputs, the
    windowed D=256 inputs)."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    inp = KernelInputs(torch, dev, **GEMMA_HEADS)
    errs = {}
    for tag, x in (("", inp), (INT8_KV, inp.scaled()), (FP8_KV, inp.fp8())):
        errs.update(check_attention(torch, x, WIDE + tag))
        o, m, l = x.verify_rows(pa.paged_decode_attention)
        ro, rm, rl = x.verify_rows(pa.paged_decode_attention_plain)
        torch.cuda.synchronize()
        err = close(f"verify rows{WIDE}{tag}", o, ro, 2e-2, 2e-2)
        close_stats(f"verify rows{WIDE}{tag}", (m, l), (rm, rl))
        log(f"  D=256 (H=16, Hkv=8){tag or ' bf16'}: decode "
            f"{errs['paged_decode_attention' + WIDE + tag]:.3e}, prefill "
            f"{errs['paged_prefill_attention' + WIDE + tag]:.3e}, ragged "
            f"{errs['ragged_mixed_attention' + WIDE + tag]:.3e}, verify rows "
            f"{err:.3e} max |err| vs plain, (m, l) within 1e-3  OK")
    check_wide_appends(torch, dev, inp)
    errs["kv_cache_append" + WIDE] = 0.0
    winp = KernelInputs(torch, dev, **GEMMA_HEADS, window=GEMMA_WINDOW)
    errs.update(check_windowed(torch, winp, card, names=(WIDE_WINDOW, WIDE_WINDOW)))
    narrow = KernelInputs(torch, dev, H=16, Hkv=8, D=192)
    for tag, x in (("", narrow), (INT8_KV, narrow.scaled()), (FP8_KV, narrow.fp8())):
        e = check_attention(torch, x, " (D=192)" + tag)
        log(f"  D=192 (H=16, Hkv=8){tag or ' bf16'}: " + ", ".join(
            f"{k.split(' ')[0]} {v:.3e}" for k, v in e.items())
            + " max |err| vs plain, (m, l) within 1e-3  OK")
    del narrow
    return errs, inp, winp


#: the tiers' block copies (ops/block_copy.py): phase 2's widths and the
#: timed page count
BLOCK_WIDTHS = {"Llama-3-8B": (32, 8, 8, 128, 128),
                "V2-Lite latents": (27, 1, 1, 512, 64)}
BLOCK_PAGES = 64


def raw_equal(torch, a, b) -> bool:
    """Byte for byte, whatever the dtype (NaN bytes included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


class BlockInputs:
    """A paged cache pair of ``N`` pages at one model's widths (K and V may
    differ: MLA's latent rows) in ``dtype`` (int8 with its [L, N] planes),
    random stacks to land, and out-of-order index vectors of ``n`` entries
    whose last is the trash page 0 (``m = n - 1`` real rows; ``m = n = 1``
    for one page; without ``trash``, n real pages and ``m = n``)."""

    def __init__(self, torch, dev, widths, dtype, n, N=80, seed=0, trash=True):
        from dynamo_tpu_torch.models.quant import to_e4m3

        L, Hk, Hv, Dk, Dv = widths
        bs = 16
        g = torch.Generator(device=dev).manual_seed(seed)
        self.torch, self.dev, self.dtype = torch, dev, dtype

        def draw(shape, scale=1.0):
            x = torch.randn(shape, generator=g, device=dev) * scale
            if dtype == torch.int8:
                return torch.randint(-127, 128, shape, generator=g, device=dev,
                                     dtype=torch.int8)
            if dtype == torch.float8_e4m3fn:
                return to_e4m3(x * 100)
            return x.to(dtype)

        self.kc = draw((L, Hk, N, bs, Dk))
        self.vc = draw((L, Hv, N, bs, Dv))
        self.planes = None
        if dtype == torch.int8:
            self.planes = tuple(torch.rand((L, N), generator=g, device=dev) + 0.01
                                for _ in range(2))
        perm = torch.randperm(N - 1, generator=g, device=dev)[:n] + 1
        if n > 1 and trash:
            perm[-1] = 0
        self.idxs = perm.to(torch.int32)
        self.m = n - 1 if n > 1 and trash else n
        m = self.m
        self.kd = draw((L, Hk, m, bs, Dk))
        self.vd = draw((L, Hv, m, bs, Dv))
        # carried scales: int8 / e4m3 codes scaled into (and for e4m3
        # landings past) the fp8 range, some 0 (a pad row's)
        self.ks, self.vs = (torch.rand((L, m), generator=g, device=dev) * 5
                            for _ in range(2))
        self.ks[0, 0] = 0.0
        self.widths = widths

    def caches(self):
        """Fresh copies of the caches (and planes)."""
        planes = (tuple(p.clone() for p in self.planes) if self.planes
                  else ())
        return self.kc.clone(), self.vc.clone(), planes

    def gather(self, fn):
        return fn(self.kc, self.vc, self.idxs, *(self.planes or ()))

    def scatter(self, fn, kc, vc, planes):
        if planes:
            return fn(kc, vc, self.idxs, self.kd, self.vd, *planes, self.ks,
                      self.vs)
        return fn(kc, vc, self.idxs, self.kd, self.vd)

    def dequant(self, fn, kc, vc):
        return fn(kc, vc, self.idxs, self.kd, self.vd, self.ks, self.vs)

    def requant(self, fn, kc, vc, planes, data=None, scales=None):
        kd, vd = data or (self.kd, self.vd)
        ks, vs = scales or (self.ks, self.vs)
        return fn(kc, vc, *planes, self.idxs, kd, vd, ks, vs)


def check_block_copy(torch, dev) -> dict:
    """Each block-copy entry point against its plain twin, byte-equal: at
    Llama-3-8B's widths over bf16, int8 (with planes) and e4m3 pages, and
    at V2-Lite's latent widths (bf16), for 1, 7 and 64 out-of-order pages
    with the trash page among them; the dequantize into bf16, f32 and e4m3
    caches (scales that carry e4m3 values past 464: NaN bytes), the
    requantize from bf16, f32, int8 and e4m3 stacks. Returns each entry
    point's max abs error (0.0: equal bytes)."""
    from dynamo_tpu_torch.ops import block_copy as bc

    def caches_equal(what, a, b):
        for x, y in zip(a, b):
            if not raw_equal(torch, x, y):
                raise AssertionError(f"{what}: kernel and plain twin differ")

    bf16, i8, e4m3, f32 = (torch.bfloat16, torch.int8, torch.float8_e4m3fn,
                           torch.float32)
    checked = 0
    for label, widths in BLOCK_WIDTHS.items():
        dtypes = (bf16, i8, e4m3) if label == "Llama-3-8B" else (bf16,)
        for dtype in dtypes:
            for n in (1, 7, BLOCK_PAGES):
                bi = BlockInputs(torch, dev, widths, dtype, n, seed=n)
                caches_equal(f"gather_blocks {label} {dtype} n={n}",
                             bi.gather(bc.gather_blocks),
                             bi.gather(bc.gather_blocks_plain))
                a, b = bi.caches(), bi.caches()
                bi.scatter(bc.scatter_blocks, *a)
                bi.scatter(bc.scatter_blocks_plain, *b)
                torch.cuda.synchronize()
                caches_equal(f"scatter_blocks {label} {dtype} n={n}",
                             (a[0], a[1], *a[2]), (b[0], b[1], *b[2]))
                checked += 2
        # codes times scales into each full-width / fp8 cache
        for code in ((i8, e4m3) if label == "Llama-3-8B" else (i8,)):
            for cache in ((bf16, f32, e4m3) if label == "Llama-3-8B" else (bf16,)):
                for n in (1, 7, BLOCK_PAGES):
                    bi = BlockInputs(torch, dev, widths, code, n, seed=n + 1)
                    a = (bi.kc.to(f32).to(cache) if cache != e4m3 else
                         bi.kc.view(torch.uint8).clone().view(e4m3),
                         bi.vc.to(f32).to(cache) if cache != e4m3 else
                         bi.vc.view(torch.uint8).clone().view(e4m3))
                    b = tuple(x.clone() for x in a)
                    bi.dequant(bc.scatter_blocks_dequant, *a)
                    bi.dequant(bc.scatter_blocks_dequant_plain, *b)
                    torch.cuda.synchronize()
                    caches_equal(f"scatter_blocks_dequant {label} {code} -> "
                                 f"{cache} n={n}", a, b)
                    checked += 1
    # requantize into the int8 cache (GQA only: MLA takes no int8 cache)
    widths = BLOCK_WIDTHS["Llama-3-8B"]
    for data in (bf16, f32, i8, e4m3):
        for n in (1, 7, BLOCK_PAGES):
            bi = BlockInputs(torch, dev, widths, i8, n, seed=n + 2)
            src = BlockInputs(torch, dev, widths, bf16 if data == f32 else data,
                              n, seed=n + 3)
            kd, vd = src.kd.to(f32) if data == f32 else src.kd, (
                src.vd.to(f32) if data == f32 else src.vd)
            scales = ((torch.ones_like(src.ks), torch.ones_like(src.vs))
                      if data in (bf16, f32) else (src.ks, src.vs))
            a, b = bi.caches(), bi.caches()
            bi.requant(bc.scatter_blocks_requant, a[0], a[1], a[2], (kd, vd), scales)
            bi.requant(bc.scatter_blocks_requant_plain, b[0], b[1], b[2],
                       (kd, vd), scales)
            torch.cuda.synchronize()
            caches_equal(f"scatter_blocks_requant {data} n={n}",
                         (a[0], a[1], *a[2]), (b[0], b[1], *b[2]))
            checked += 1
    # the disaggregated handoff's page count: a 3072-token prompt's 192
    # pages, gathered by the extract and landed by the decode side (full
    # width, and int8 wire codes into bf16 pages), with the trash page
    widths = BLOCK_WIDTHS["Llama-3-8B"]
    for code in (bf16, i8):
        bi = BlockInputs(torch, dev, widths, code, DISAGG_PAGES + 1, N=256,
                         seed=5)
        if code == bf16:
            caches_equal(f"gather_blocks n={DISAGG_PAGES + 1}",
                         bi.gather(bc.gather_blocks),
                         bi.gather(bc.gather_blocks_plain))
            a, b = bi.caches(), bi.caches()
            bi.scatter(bc.scatter_blocks, *a)
            bi.scatter(bc.scatter_blocks_plain, *b)
        else:
            a = (torch.zeros_like(bi.kc, dtype=bf16),
                 torch.zeros_like(bi.vc, dtype=bf16), ())
            b = tuple(x.clone() for x in a[:2]) + ((),)
            bi.dequant(bc.scatter_blocks_dequant, a[0], a[1])
            bi.dequant(bc.scatter_blocks_dequant_plain, b[0], b[1])
        torch.cuda.synchronize()
        caches_equal(f"scatter {code} n={DISAGG_PAGES + 1}",
                     (a[0], a[1], *a[2]), (b[0], b[1], *b[2]))
        checked += 2 if code == bf16 else 1
    log(f"  block copies: {checked} kernel / plain pairs byte-equal (gather "
        f"and scatter over bf16, int8 + planes and e4m3 pages at Llama-3-8B's "
        f"widths and bf16 latents at V2-Lite's, n = 1, 7, {BLOCK_PAGES} with "
        "the trash page; dequantize int8 / e4m3 codes into bf16, f32 and e4m3 "
        "caches; requantize bf16, f32, int8 and e4m3 stacks into the int8 "
        f"cache; gather, scatter and the int8 dequantize at {DISAGG_PAGES} "
        "pages, the disaggregated handoff's)")
    return {"gather_blocks": 0.0, "scatter_blocks": 0.0,
            "scatter_blocks_dequant": 0.0, "scatter_blocks_requant": 0.0}


def check_gmm_tiles(torch, dev) -> None:
    """The grouped GEMM's tiled blocks beside the few-rows mode in one
    launch, at DeepSeek-V2-Lite's gate shape (K = 2048, N = 1408): experts
    of 9 and 16 rows, of 200 and 130 (two row tiles), of 3 and 1 and an
    empty one; then K = 7168 (DeepSeek-V3's hidden width) at N = 256 over
    three experts (140, 2 and 9 rows); int8 and e4m3 codes, bf16 rows,
    within 2e-2 of the plain twin, the unowned rows exactly 0. Then the
    few-rows (decode) mode at V2-Lite's gate and down shapes (K = 1408, N =
    2048) and at K = 7168, N = 256 (K split across blocks), 64 experts
    routed top-6 from 8 tokens (0-4 rows each) and from 16 tokens skewed
    onto three experts (16 rows each, the others 0-3), each launched twice:
    bit-equal."""
    from dynamo_tpu_torch.models.quant import quantize_array
    from dynamo_tpu_torch.ops import moe_gmm

    g = torch.Generator(device=dev).manual_seed(13)
    for K, N, sizes in ((2048, 1408, [9, 0, 200, 3, 16, 130, 1]),
                        (7168, 256, [140, 2, 9])):
        X = len(sizes)
        sizes = torch.tensor(sizes, dtype=torch.int64, device=dev)
        R = int(sizes.sum()) + 16
        w = torch.randn(X, K, N, generator=g, device=dev).bfloat16()
        lhs = torch.randn(R, K, generator=g, device=dev).bfloat16()
        for mode in ("int8", "fp8_e4m3"):
            qw = quantize_array(w, mode)
            got = moe_gmm.ragged_int8_gmm(lhs, qw["q"], qw["s"], sizes)
            ref = moe_gmm.ragged_int8_plain(lhs, qw["q"], qw["s"], sizes)
            torch.cuda.synchronize()
            if not bool((got[R - 16:] == 0).all()):
                raise AssertionError("ragged_int8_gmm tiles: unowned rows must "
                                     "be exactly 0")
            err = close(f"ragged_int8_gmm K={K} {mode}", got, ref, 2e-2, 2e-2)
            log(f"  ragged_int8_gmm tiles, K={K} N={N}, experts "
                f"{sizes.tolist()} rows, {mode}: max |err| {err:.3e}, "
                "unowned rows 0  OK")
    X = 64
    routes = []
    for T, skew in ((8, 0.0), (16, 4.0)):
        scores = torch.rand(T, X, generator=g, device=dev)
        scores[:, :3] += skew  # skewed: every token on experts 0-2
        sizes = torch.bincount(scores.topk(6, dim=-1).indices.reshape(-1),
                               minlength=X)
        routes.append((T, sizes))
    for K, N in ((2048, 1408), (1408, 2048), (7168, 256)):
        w = torch.randn(X, K, N, generator=g, device=dev).bfloat16()
        for mode in ("int8", "fp8_e4m3"):
            qw = quantize_array(w, mode)
            err = 0.0
            for T, sizes in routes:
                R = int(sizes.sum()) + 16
                lhs = torch.randn(R, K, generator=g, device=dev).bfloat16()
                ref = moe_gmm.ragged_int8_plain(lhs, qw["q"], qw["s"], sizes)
                got = moe_gmm.ragged_int8_gmm(lhs, qw["q"], qw["s"], sizes)
                again = moe_gmm.ragged_int8_gmm(lhs, qw["q"], qw["s"], sizes)
                torch.cuda.synchronize()
                tag = f"ragged_int8_gmm decode K={K} N={N} {mode} T={T}"
                if not bool((got[R - 16:] == 0).all()):
                    raise AssertionError(f"{tag}: unowned rows must be exactly 0")
                if not torch.equal(got, again):
                    raise AssertionError(f"{tag}: two launches differ")
                err = max(err, close(tag, got, ref, 2e-2, 2e-2))
            del qw
            log(f"  ragged_int8_gmm few-rows mode, K={K} N={N}, 64 experts, "
                f"{mode}: experts of up to "
                f"{max(int(s.max()) for _, s in routes)} rows, max |err| "
                f"{err:.3e}, unowned rows 0, two launches bit-equal  OK")
        del w


def check_mla_widths(torch, dev) -> None:
    """C.7, C.8: both latent kernels across the widths the reference's
    kernels take (kv_lora_rank % 128 == 0, any rope width): MiniCPM3-4B's
    (its config.json: C = 256, R = 32), C = 384 with R = 16, C = 640 with
    R = 64 (two column slabs), C = 128 with R = 8, all on the tensor-core
    body; C = 768 and 1024 with R = 64 and C = 512 with R = 160, wider than
    its tiles, on the CUDA-core body; H = 16, bs = 16: decode B = 4 up to
    700 positions with an empty slot and (m, l) at 16 rows per sequence, 64
    (a verify's 4 tokens) and 272 (spec_gamma = 16), one launch each;
    prefill T = 90 on 300 cached (the last 64-row tile half full) with and
    without valid_len; against the plain versions (bf16 2e-2, (m, l) rtol
    1e-3). Then f32 (the CUDA-core body) at C = 384, R = 16, C = 640, R =
    64 and the three C.8 widths (2e-5)."""
    from dynamo_tpu_torch.ops import mla_attention as mla

    H, bs, M, N = 16, 16, 48, 400
    c8 = [(768, 64), (1024, 64), (512, 160)]
    for (C, R), dtype in ([((256, 32), torch.bfloat16), ((384, 16), torch.bfloat16),
                           ((640, 64), torch.bfloat16), ((128, 8), torch.bfloat16)]
                          + [(w, torch.bfloat16) for w in c8]
                          + [((384, 16), torch.float32), ((640, 64), torch.float32)]
                          + [(w, torch.float32) for w in c8]):
        g = torch.Generator(device=dev).manual_seed(14 + C + R)
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        body = ("tensor-core" if dtype == torch.bfloat16 and mla.tc_takes(C, R)
                else "CUDA-core")
        tag = f"C={C} R={R} {str(dtype)[6:]} ({body} body)"
        cc = torch.randn(1, N, bs, C, generator=g, device=dev).to(dtype)
        pc = torch.randn(1, N, bs, R, generator=g, device=dev).to(dtype)
        tables = (torch.randperm(N - 1, generator=g, device=dev)[: 5 * M] + 1)
        tables = tables.reshape(5, M).to(torch.int32)
        lens = torch.tensor([700, 0, 333, 17], dtype=torch.int32, device=dev)
        scale = (192 + R) ** -0.5
        err = 0.0
        for rows in (16, 64, 272):
            qe = torch.randn(4, rows, C, generator=g, device=dev).to(dtype)
            qp = torch.randn(4, rows, R, generator=g, device=dev).to(dtype)
            before = mla.mla_paged_decode_attention.launches
            o, m, l = mla.mla_paged_decode_attention(
                qe, qp, cc, pc, tables[:4], lens, scale, return_stats=True,
                tokens=rows // H)
            ro, rm, rl = mla.mla_paged_decode_attention_plain(
                qe, qp, cc, pc, tables[:4], lens, scale, return_stats=True)
            torch.cuda.synchronize()
            err = max(err, close(f"{tag} decode {rows} rows", o, ro, tol, tol))
            close_stats(f"{tag} decode {rows} rows", (m, l), (rm, rl))
            if not (bool((o[1] == 0).all()) and bool((m[1] == -1e30).all())
                    and bool((l[1] == 0).all())):
                raise AssertionError(f"{tag} decode: the empty slot must give "
                                     "o=0, m=-1e30, l=0")
            if mla.mla_paged_decode_attention.launches - before != 1:
                raise AssertionError(f"{tag} decode: one launch per call")
        qe = torch.randn(90, H, C, generator=g, device=dev).to(dtype)
        qp = torch.randn(90, H, R, generator=g, device=dev).to(dtype)
        hist = torch.tensor([300], dtype=torch.int32, device=dev)
        for valid in (None, 70):
            got = mla.mla_paged_prefill_attention(qe, qp, cc, pc, tables[4], hist,
                                                  scale, valid_len=valid)
            ref = mla.mla_paged_prefill_attention_plain(qe, qp, cc, pc, tables[4],
                                                        hist, scale, valid)
            torch.cuda.synchronize()
            err = max(err, close(f"{tag} prefill (valid {valid})", got, ref,
                                 tol, tol))
        log(f"  MLA latent kernels at {tag}, H={H}: decode (16, 64, 272 rows) "
            f"and prefill vs plain max |err| {err:.3e}, (m, l) within 1e-3  OK")


def quantized_pages(torch, kc, vc):
    """int8 codes of two bf16 caches with one f32 absmax scale per page
    (K and V): (k codes, v codes, k scales, v scales)."""
    out = []
    for c in (kc, vc):
        f = c.float()
        s = (f.abs().amax(dim=(0, 2, 3)) / 127.0).clamp_min(1e-12)
        out.append((torch.clamp(torch.round(f / s[None, :, None, None]), -127, 127)
                    .to(torch.int8), s))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def check_moe_deterministic(torch, dev) -> None:
    """The bf16 MoE FFN run to run on the card, at deepseek-v2-lite-sim's
    widths (64 experts top-6 + 2 shared, hidden 2048, expert width 1408)
    with one layer's random expert weights and 512 tokens: moe_ffn twice
    must give the same bits. Each stage (routing, the three grouped GEMMs,
    the combine) is compared too, and the index_add_ combine it replaced,
    as evidence of where run-to-run differences come from."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import deepseek_v2_lite

    g = torch.Generator(device=dev).manual_seed(8)
    cfg = deepseek_v2_lite()
    E, X, Fm = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    Fs = cfg.shared_expert_size or Fm * cfg.num_shared_experts
    shapes = dict(moe_gate=(E, X), we_gate=(X, E, Fm), we_up=(X, E, Fm),
                  we_down=(X, Fm, E), shared_gate=(E, Fs), shared_up=(E, Fs),
                  shared_down=(Fs, E))
    lp = {n: (torch.randn(v, generator=g, device=dev) * 0.02).bfloat16()
          for n, v in shapes.items()}
    x = torch.randn(512, E, generator=g, device=dev).bfloat16()
    runs = []
    for _ in range(2):
        t_sorted, w_sorted, _e, sizes = llama._moe_route(lp, cfg, x)
        xs = x[t_sorted]
        gate = llama._ragged_mm(xs, lp["we_gate"], sizes)
        up = llama._ragged_mm(xs, lp["we_up"], sizes)
        down = llama._ragged_mm(llama._expert_act(cfg, gate, up), lp["we_down"], sizes)
        weighted = down * w_sorted[:, None].to(x.dtype)
        runs.append({
            "routing": torch.cat([t_sorted.float(), w_sorted, sizes.float()]),
            "gate GEMM": gate, "up GEMM": up, "down GEMM": down,
            "combine": llama._moe_combine(down, t_sorted, w_sorted, x.shape[0], x.dtype),
            "index_add_ combine (replaced)": torch.zeros_like(x).index_add_(
                0, t_sorted, weighted),
            "moe_ffn": llama.moe_ffn(lp, cfg, x),
        })
    torch.cuda.synchronize()
    same = {k: torch.equal(runs[0][k], runs[1][k]) for k in runs[0]}
    log("  bf16 MoE at deepseek-v2-lite-sim widths (512 tokens, one layer), run "
        "twice, bits equal: " + ", ".join(f"{k} {v}" for k, v in same.items()))
    if not (same["moe_ffn"] and bool(torch.isfinite(runs[0]["moe_ffn"].float()).all())):
        raise AssertionError("moe_ffn is not bit-equal run to run on the card: "
                             f"{same}")


def tiny_models():
    """(label, config, weight quantization, KV cache: None, "int8" or
    "float8_e4m3") of the tiny models held on the card to the CPU: dense
    GQA, and MLA (q-lora, the kernel's R=64 and smallest C=128) with one
    dense layer then MoE (8 experts top-2, one shared); then each again on
    the quantized path, and the dense one over an fp8 cache;
    then Qwen2's q/k/v biases at G = 7 (14 query heads over 2 KV heads:
    a decode block's 7 live rows of 16, the ragged tiles' 9 tokens per
    64-row tile, a gamma=3 verify's 28 rows per KV head in two row
    groups) and Qwen3's per-head q/k norms."""
    from dynamo_tpu_torch.models.config import ModelConfig

    gqa = ModelConfig.tiny(dtype="float32", head_dim=64, num_heads=8,
                           num_kv_heads=2, hidden_size=128)
    qwen2 = ModelConfig.tiny(dtype="float32", head_dim=64, num_heads=14,
                             num_kv_heads=2, hidden_size=128, attention_bias=True)
    qwen3 = ModelConfig.tiny(dtype="float32", head_dim=64, num_heads=8,
                             num_kv_heads=2, hidden_size=128, qk_norm=True)
    mla = ModelConfig.tiny_mla(
        dtype="float32", kv_lora_rank=128, qk_rope_head_dim=64,
        num_layers=3, first_dense_layers=1, num_experts=8,
        num_experts_per_tok=2, num_shared_experts=1,
        moe_intermediate_size=32)
    return [
        ("tiny gpt-oss (windows of 16, sinks, biased clamped MoE)",
         tiny_gptoss("float32"), "none", None),
        ("tiny Gemma-3 (D=256, windows of 16, two ropes, sandwich norms)",
         tiny_gemma3("float32"), "none", None),
        ("tiny GQA", gqa, "none", None),
        ("tiny MLA+MoE", mla, "none", None),
        ("tiny GQA, fp8 weights + int8 KV", gqa, "fp8_e4m3", "int8"),
        ("tiny GQA, fp8 KV", gqa, "none", "float8_e4m3"),
        ("tiny MLA+MoE, int8 weights", mla, "int8", None),
        ("tiny Qwen2 (q/k/v biases, G=7)", qwen2, "none", None),
        ("tiny Qwen3 (per-head q/k norms)", qwen3, "none", None),
    ]


def tiny_gemma3(dtype):
    """A tiny Gemma-3 at the wide head (D=256, the card's f32 launches on
    the CUDA-core body): 6 layers, windows of 16 on the first five (every
    prefill of phase 2's checks crosses them), a query scale base of 32,
    the full layer's rope at theta 1e6 scaled linearly by 8 and the
    windowed layers' local rope at 1e4, sandwich norms, GeGLU, scaled and
    tied embeddings."""
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig.tiny(
        dtype=dtype, head_dim=256, num_heads=4, num_kv_heads=2,
        hidden_size=128, num_layers=6, layer_windows=(16,) * 5 + (0,),
        post_norms=True, qk_norm=True, attn_scale_base=32, rms_add_unit=True,
        scale_embed=True, tie_word_embeddings=True, hidden_act="gelu_tanh",
        rope_theta=1000000.0, rope_local_theta=10000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0})


def tiny_gptoss(dtype):
    """The ``tiny-gptoss`` preset at the kernels' head width (D = 64; the
    preset's 16 is a CPU size): 16-token windows on alternate layers,
    sinks, q/k/v/o biases, 4 experts top-2 with biased clamped SwiGLU."""
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig.tiny(
        dtype=dtype, head_dim=64, num_heads=8, num_kv_heads=2, hidden_size=128,
        num_layers=4, layer_windows=(16, 0, 16, 0), attn_sinks=True,
        o_bias=True, attention_bias=True, num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=32, moe_act="gptoss_clamp")


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@contextlib.contextmanager
def moe_probe(torch, llama):
    """While open, per device type: the expert elements that gpt-oss's
    clamp cuts (gate above 7, up outside [-7, 7]) and the smallest gap
    between any token's k-th and (k+1)-th routing scores, as llama's
    ``_expert_act`` and ``_route_topk`` see them."""
    act, route = llama._expert_act, llama._route_topk
    seen = {}

    def stats(x):
        return seen.setdefault(x.device.type, {"gate": 0, "up": 0,
                                               "margin": math.inf})

    def counted_act(cfg, g, u):
        st = stats(g)
        st["gate"] += int((g > 7.0).sum())
        st["up"] += int((u.abs() > 7.0).sum())
        return act(cfg, g, u)

    def measured_route(lp, cfg, x):
        logits = x.float() @ lp["moe_gate"].float() + lp["moe_router_bias"].float()
        top = torch.softmax(logits, -1).topk(cfg.num_experts_per_tok + 1).values
        st = stats(x)
        st["margin"] = min(st["margin"], float((top[:, -2] - top[:, -1]).min()))
        return route(lp, cfg, x)

    llama._expert_act, llama._route_topk = counted_act, measured_route
    try:
        yield seen
    finally:
        llama._expert_act, llama._route_topk = act, route


def check_model_on_card(torch, dev, label, cfg, quantization="none", kv=None):
    """A tiny model's three main-path functions on the card (kernels)
    against the same functions on the CPU (plain versions), f32. For
    gpt-oss, the clamp must cut expert elements and no token's routing be
    a tie, on both devices."""
    from dynamo_tpu_torch.models import llama

    if cfg.moe_act != "gptoss_clamp":
        model_on_card(torch, dev, label, cfg, quantization, kv)
        return
    with moe_probe(torch, llama) as seen:
        model_on_card(torch, dev, label, cfg, quantization, kv)
    log(f"  {label}: clamped gate / up elements and the smallest top-k "
        "routing margin: " + ", ".join(
            f"{d} {st['gate']} / {st['up']}, {st['margin']:.2e}"
            for d, st in seen.items()))
    if not (set(seen) == {"cpu", "cuda"} and all(
            st["gate"] > 0 and st["up"] > 0 and st["margin"] > 0
            for st in seen.values())):
        raise AssertionError(f"{label}: the clamp cut nothing or a routing "
                             f"choice was a tie: {seen}")


def model_on_card(torch, dev, label, cfg, quantization, kv) -> None:
    """check_model_on_card's comparison: logits within 1e-3, or 2e-2 over
    fp8 pages (a K/V value that the card's f32 sums put on the other side
    of an e4m3 rounding edge moves by 1/16 of itself), tokens exact."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.quant import KV_SCALE_EPS, kv_cache_dtype

    params = tiny_params(torch, cfg, quantization)
    gparams = to_device(params, dev)
    kc, vc = llama.init_kv_cache(cfg, 64, 16, dtype=kv_cache_dtype(cfg, kv))
    gkc, gvc = kc.to(dev), vc.to(dev)
    tol = 2e-2 if kv == "float8_e4m3" else 1e-3
    planes = {}
    if kv == "int8":
        planes = {k: torch.full((cfg.num_layers, 64), KV_SCALE_EPS)
                  for k in ("k_scales", "v_scales")}
    gplanes = {k: v.to(dev) for k, v in planes.items()}
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (64,), generator=gen, dtype=torch.int32)
    table = torch.arange(1, 9, dtype=torch.int32)
    lc = llama.prefill(params, cfg, toks, table, 0, 50, kc, vc, **planes)[0]
    lg = llama.prefill(gparams, cfg, toks.to(dev), table.to(dev), 0, 50,
                       gkc, gvc, **gplanes)[0]
    err = float((lg.cpu() - lc).abs().max())
    if not (bool(torch.isfinite(lg).all()) and err < tol):
        raise AssertionError(f"{label} prefill on the card: max |dlogit| {err}")
    # decode rows 0-1 continue the prompt; a second prompt prefills as a
    # fused segment beside them
    B = 2
    d_tables = torch.stack([table, torch.arange(9, 17, dtype=torch.int32)])
    d_lens = torch.tensor([50, 0], dtype=torch.int32)
    p_tok = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen, dtype=torch.int32)
    p_tab = torch.arange(17, 25, dtype=torch.int32)[None]
    z = dict(seeds=[0] * B, steps=[0] * B)
    samp = (torch.zeros(B), torch.zeros(B, dtype=torch.int32), torch.ones(B))
    args = (toks[49:51].clone(), (d_lens - 1).clamp(min=0), d_tables, d_lens)
    pre = (p_tok, p_tab, torch.tensor([0], dtype=torch.int32),
           torch.tensor([30], dtype=torch.int32))
    outs = []
    for where, p, k, v, pk in (("cpu", params, kc, vc, planes),
                               (dev, gparams, gkc, gvc, gplanes)):
        mv = lambda t: t.to(where)  # noqa: E731
        nxt, pl = llama.mixed_step(
            p, cfg, *map(mv, args), z["seeds"], z["steps"], *map(mv, samp),
            *map(mv, pre), k, v, **pk)[:2]
        toks_w = llama.decode_window(
            p, cfg, nxt, mv(d_lens), mv(d_tables), mv(d_lens + 1),
            z["seeds"], z["steps"], *map(mv, samp), k, v, n_steps=3, **pk)[0]
        outs.append((nxt.cpu(), pl.cpu(), toks_w.cpu()))
    (n0, p0, w0), (n1, p1, w1) = outs
    perr = float((p1 - p0).abs().max())
    if not (torch.equal(n0, n1) and torch.equal(w0[:, 0], w1[:, 0]) and perr < tol):
        raise AssertionError(
            f"{label} mixed step / decode window on the card disagree with the "
            f"CPU: tokens {n1.tolist()} vs {n0.tolist()}, windows "
            f"{w1[:, 0].tolist()} vs {w0[:, 0].tolist()}, max |dlogit| {perr}"
        )
    log(f"  {label} on the card vs CPU: prefill max |dlogit| {err:.2e}, "
        f"mixed-step max |dlogit| {perr:.2e} (tolerance {tol:g}), tokens "
        "equal  OK")


def tiny_params(torch, cfg, quantization="none"):
    """Seeded tiny-model weights on the CPU, matrices x5 (std 0.1):
    decisive logits and expert routing, so a token or an expert choice is
    never a near-tie that the sum order can flip. The tiny gpt-oss takes
    x2: at x5 its clamped-SwiGLU experts and biases grow the hidden state
    to ~120 and its logits move by ~4e-3 when the weights move by 1e-7 of
    themselves (f32 rounding), at x2 (with the wide expert biases of
    draw_attention_extras) by ~1e-6 (measured on the CPU); its wide gate
    and up biases are what make the clamp cut (check_model_on_card counts
    the cut elements)."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.quant import quantize_params

    params = llama.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    x = 2.0 if cfg.moe_act == "gptoss_clamp" else 5.0
    params = {k: ({kk: vv * (x if vv.dim() > 1 else 1.0) for kk, vv in v.items()}
                  if isinstance(v, dict) else v * (x if v.dim() > 1 else 1.0))
              for k, v in params.items()}
    draw_attention_extras(torch, params, cfg, torch.Generator().manual_seed(5))
    return quantize_params(params, cfg, quantization)


def draw_attention_extras(torch, params, cfg, gen) -> None:
    """In place: Qwen2's (and gpt-oss's) q/k/v biases drawn N(0, 0.1),
    Qwen3's and Gemma-3's per-head q/k norm weights N(1, 0.3), Gemma-3's
    sandwich norm weights N(1, 0.3), gpt-oss's o_proj bias
    N(0, 0.1), router logit bias N(0, 0.5), sinks N(ln window, 1) (a real
    share of each row's mass) and expert gate and up biases N(0, 4) (past
    the clamp's 7 for some elements), where the model has them (the random
    init leaves them at values that would check little)."""
    keys = []
    if cfg.attention_bias:
        keys += [("bq", 0.0, 0.1), ("bk", 0.0, 0.1), ("bv", 0.0, 0.1)]
    if cfg.qk_norm and not cfg.is_mla:
        keys += [("q_norm", 1.0, 0.3), ("k_norm", 1.0, 0.3)]
    if cfg.post_norms:  # gemma's sandwich norms
        keys += [("attn_post_norm", 1.0, 0.3), ("mlp_post_norm", 1.0, 0.3)]
    if cfg.o_bias:
        keys += [("bo", 0.0, 0.1)]
    if cfg.attn_sinks:
        keys += [("sinks", math.log(min(w for w in cfg.layer_windows if w)), 1.0)]
    if cfg.moe_act == "gptoss_clamp":
        keys += [("moe_router_bias", 0.0, 0.5), ("be_gate", 0.0, 4.0),
                 ("be_up", 0.0, 4.0)]
    for key, mean, std in keys:
        leaf = params["layers"][key]
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=gen.device)
                   * std + mean)


def check_verify_on_card(torch, dev, label, cfg) -> None:
    """A tiny model's speculative verify_window (gamma=3) on the card
    against the same function on the CPU, f32, from the same cache: a
    greedy row proposing its plain greedy chain with a miss at t=2, a
    seeded sampled row (top-k) proposing the same chain, an empty slot
    with no proposals. out_tokens and n_acc exact, the forward's logits
    within 1e-3, the caches after the append within 1e-3."""
    from dynamo_tpu_torch.models import llama

    g = SPEC_GAMMA
    params = tiny_params(torch, cfg)
    gparams = to_device(params, dev)
    kc, vc = llama.init_kv_cache(cfg, 64, 16)
    gen = torch.Generator().manual_seed(3)
    tables = torch.stack([torch.arange(1, 9), torch.arange(9, 17),
                          torch.zeros(8, dtype=torch.int64)]).to(torch.int32)
    lens = torch.tensor([50, 37, 0], dtype=torch.int32)
    for b in range(2):
        toks = torch.randint(0, cfg.vocab_size, (64,), generator=gen,
                             dtype=torch.int32)
        llama.prefill(params, cfg, toks, tables[b], 0, int(lens[b]), kc, vc)
    last = torch.randint(0, cfg.vocab_size, (3,), generator=gen, dtype=torch.int32)
    positions = (lens - 1).clamp(min=0)
    greedy = (torch.zeros(3), torch.zeros(3, dtype=torch.int32), torch.ones(3))
    chain = llama.decode_window(params, cfg, last, positions, tables, lens,
                                [0] * 3, [0] * 3, *greedy, kc.clone(),
                                vc.clone(), n_steps=g)[0].T  # [3, g]
    props = chain.clone()
    props[0, 2] = (props[0, 2] + 1) % cfg.vocab_size
    props[1] = chain[0]
    props[2] = -1
    window = torch.cat([last[:, None], props.clamp(min=0)], dim=1)
    samp = (torch.tensor([0.0, 0.8, 0.0]), torch.tensor([0, 8, 0], dtype=torch.int32),
            torch.ones(3))
    outs = []
    for where, p in (("cpu", params), (dev, gparams)):
        mv = lambda t: t.to(where)  # noqa: E731
        k, v = kc.clone().to(where), vc.clone().to(where)
        out, n_acc = llama.verify_window(
            p, cfg, *map(mv, (window, props, positions, tables, lens)),
            [3, 4, 0], [7, 2, 0], *map(mv, samp), k, v, n_spec=g)[:2]
        logits = llama._verify_forward(
            p, cfg, *map(mv, (window, positions, tables, lens)),
            kc.clone().to(where), vc.clone().to(where), g)[0]
        outs.append((out.cpu(), n_acc.cpu(), logits.cpu(), k.cpu(), v.cpu()))
    (o0, n0, l0, k0, v0), (o1, n1, l1, k1, v1) = outs
    lerr = float((l1[:2] - l0[:2]).abs().max())
    kerr = max(float((k1 - k0)[:, :, 1:].abs().max()),
               float((v1 - v0)[:, :, 1:].abs().max()))
    if not (torch.equal(o0, o1) and torch.equal(n0, n1) and lerr < 1e-3
            and kerr < 1e-3 and int(n0[0]) == 2):
        raise AssertionError(
            f"{label} verify_window on the card disagrees with the CPU: tokens "
            f"{o1.tolist()} vs {o0.tolist()}, n_acc {n1.tolist()} vs "
            f"{n0.tolist()}, max |dlogit| {lerr}, caches {kerr}")
    log(f"  {label} verify_window (gamma={g}) on the card vs CPU: tokens and "
        f"n_acc {n1.tolist()} equal, max |dlogit| {lerr:.2e}, caches "
        f"{kerr:.2e}  OK")


def check_engine_spec_on_card(torch, dev) -> None:
    """A tiny f32 TorchEngine on the card with speculation against
    spec_gamma=0 on the reference's repetitive prompt: the same greedy
    stream, with the spec engine's proposer fed the plain stream's true
    continuation (tests/test_speculative.py's device: organic n-gram hits
    depend on the random model), so every proposal is accepted. Twice:
    spec_gamma=3 on 16-token pages, and spec_gamma=16 on 32-token pages (a
    verify's 17 in-flight rows fit one page, as the reference requires):
    17 x G = 68 verify rows per kv head (C.6); then spec_gamma=3 again
    with both engines over an fp8 KV cache."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime import Context, collect

    cfg = tiny_models()[0][1]
    G = cfg.num_heads // cfg.num_kv_heads
    params = to_device(tiny_params(torch, cfg), dev)
    for spec_gamma, bs, n_tokens, kv in ((SPEC_GAMMA, 16, 20, "model"),
                                         (16, 32, 40, "model"),
                                         (SPEC_GAMMA, 16, 20, "float8_e4m3")):
        req = PreprocessedRequest(
            token_ids=[7, 8, 9, 10] * 6,
            stop_conditions=StopConditions(max_tokens=n_tokens),
            sampling_options=SamplingOptions(temperature=0.0), eos_token_ids=[])
        streams, stats = {}, {}
        for gamma in (0, spec_gamma):
            eng = TorchEngine(EngineConfig(model=cfg, num_blocks=2048 // bs,
                                           block_size=bs, max_batch_size=2,
                                           decode_window=4, spec_gamma=gamma,
                                           kv_cache_dtype=kv),
                              params=params, device=dev)
            if gamma:
                drafts = {tuple(req.token_ids): streams[0]}
                eng._propose_ngram = lambda eng=eng: oracle_drafts(eng, drafts)

            async def run(eng=eng):
                try:
                    return await collect(eng.generate(Context(req)))
                finally:
                    await eng.close()

            streams[gamma] = [t for o in asyncio.run(run()) for t in o.token_ids]
            stats[gamma] = dict(eng.stats)
        st = stats[spec_gamma]
        if not (streams[0] == streams[spec_gamma] and len(streams[0]) == n_tokens
                and st["spec_accepted"] > 0
                and st["decode_steps"] < stats[0]["decode_steps"]):
            raise AssertionError(f"tiny engine with spec_gamma={spec_gamma} on the "
                                 f"card: streams {streams}, stats {st}")
        log(f"  tiny TorchEngine, KV {kv}, spec_gamma={spec_gamma} "
            f"({(spec_gamma + 1) * G} verify rows per kv head, {bs}-token "
            "pages) vs 0 on the card: the "
            f"same greedy stream, {st['spec_accepted']}/{st['spec_proposed']} "
            f"proposals accepted, {st['decode_steps']} decode steps vs "
            f"{stats[0]['decode_steps']}  OK")


# ---------------- phase 3: serving llama3-8b-sim over HTTP ----------------


async def http_request(port: int, path: str, body: dict, progress=None):
    """POST ``body``; returns (status, text, token event times). For a
    streaming request the times are when each SSE event with text
    arrived; ``progress``, a list, receives them as they arrive."""
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode()
    writer.write(
        f"POST {path} HTTP/1.1\r\nHost: smoke\r\nConnection: close\r\n"
        f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n\r\n"
        .encode() + data
    )
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b""):
            break
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    times, text = ([] if progress is None else progress), ""
    if headers.get("transfer-encoding") == "chunked":
        buf = b""
        while True:
            size = int((await reader.readline()).strip() or b"0", 16)
            if size == 0:
                break
            buf += await reader.readexactly(size)
            await reader.readline()
            while b"\n\n" in buf:
                ev, buf = buf.split(b"\n\n", 1)
                if not ev.startswith(b"data: ") or ev == b"data: [DONE]":
                    continue
                for ch in json.loads(ev[6:]).get("choices", []):
                    piece = ch.get("text") or (ch.get("delta") or {}).get("content")
                    if piece:
                        text += piece
                        times.append(time.perf_counter() - t0)
    else:
        full = json.loads(await reader.read())
        if status == 200:
            ch = full["choices"][0]
            text = ch.get("text") or ch.get("message", {}).get("content", "")
        times.append(time.perf_counter() - t0)
    writer.close()
    await writer.wait_closed()
    return status, text, times


async def engine_resume(engine, pre, body: dict, migrated, seam: dict) -> tuple:
    """A migrated stream held to ``engine`` (built as the workers are): its
    undisturbed token ids for ``body`` (what the dead or drained worker
    served up to the seam), then its answer to the request the survivor
    got, the prompt + the first k of those tokens with the ``resume``
    annotation, k = ``seam['tokens']`` (the frontend's re-dispatch).
    Returns (k, tokens, the migrated text equal to the detokenized first k
    + continuation, the first token where the undisturbed answer's text
    and the migrated one part, the gap between the text events around the
    seam in ms)."""
    from dynamo_tpu_torch.llm.tokenizer import DecodeStream
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.protocols.openai import CompletionRequest
    from dynamo_tpu_torch.runtime import Context

    req = pre.preprocess_completion(CompletionRequest.from_dict(body))[0]

    async def ids(r) -> list:
        return [t async for o in engine.generate(Context(r)) for t in o.token_ids]

    def pieces(toks) -> list:
        d = DecodeStream(pre._tokenizer)
        out = [d.step(t) or "" for t in toks]
        out[-1] += d.flush() or ""
        return out

    undisturbed = await ids(req)
    p_u = pieces(undisturbed)
    k = seam["tokens"]
    events = sum(bool(x) for x in p_u[:k])  # the client's text events so far
    times = seam["times"]
    gap = (times[events] - times[events - 1]) * 1e3
    resumed = PreprocessedRequest.from_dict(
        {**req.to_dict(), "token_ids": list(req.token_ids) + undisturbed[:k],
         "annotations": {"resume": {"prompt_len": len(req.token_ids)}}})
    # as on the survivor, nothing of it cached: the whole of it prefills
    engine.allocator.reset()
    toks = undisturbed[:k] + await ids(resumed)
    text = "".join(pieces(toks))
    got = migrated[1]
    first, acc = len(undisturbed), ""
    for i, piece in enumerate(p_u):
        acc += piece
        if not got.startswith(acc):
            first = i
            break
    return k, len(toks), text == got, first, gap


async def http_get(port: int, path: str) -> str:
    """GET ``path``; returns the body (the service closes the connection)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    return raw.split(b"\r\n\r\n", 1)[1].decode()


def drives():
    """The serving drives in order: (served name, config, engine geometry,
    the kernel wrappers the model's path must launch; a wrapper, or a
    (wrapper, counter attribute) pair for a counter other than
    ``launches``)."""
    from dynamo_tpu_torch.launch.dynamo_run import PRESETS
    from dynamo_tpu_torch.models.config import (
        MISTRAL_7B_V02_HF,
        QWEN3_8B_HF,
        QWEN25_7B_HF,
        ModelConfig,
        deepseek_v2_lite,
    )
    from dynamo_tpu_torch.ops.kv_cache_update import (
        kv_cache_append,
        kv_cache_append_quantized,
        kv_cache_append_tokens,
    )
    from dynamo_tpu_torch.ops.mla_attention import (
        mla_paged_decode_attention,
        mla_paged_prefill_attention,
    )
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_prefill_attention,
    )
    from dynamo_tpu_torch.ops.moe_gmm import ragged_int8_gmm
    from dynamo_tpu_torch.ops.ragged_paged_attention import ragged_mixed_attention

    v2 = dict(num_blocks=4096, block_size=16, max_batch_size=8, decode_window=4,
              max_context=8192)
    mla_path = {"mla_paged_decode_attention": mla_paged_decode_attention,
                "mla_paged_prefill_attention": mla_paged_prefill_attention,
                "kv_cache_append": kv_cache_append}
    gqa_path = {"paged_decode_attention": paged_decode_attention,
                "paged_prefill_attention": paged_prefill_attention,
                "ragged_mixed_attention": ragged_mixed_attention,
                "kv_cache_append": kv_cache_append}
    mistral = ModelConfig.from_hf_config(
        {**MISTRAL_7B_V02_HF, "num_hidden_layers": CHECKPOINT_LAYERS})
    return [
        # reference defaults (block 16, batch 8, window 4, chunk 2048, 4
        # prompts per fused step); a 4096-page pool = 8 GiB of GQA KV, or
        # 2 GB of MLA latents (27 x 576 values x 2 B = 31 KB per token)
        ("llama3-8b-sim", ModelConfig.llama3_8b(),
         dict(num_blocks=4096, block_size=16, max_batch_size=8, decode_window=4),
         {"paged_decode_attention": paged_decode_attention,
          "paged_prefill_attention": paged_prefill_attention,
          "ragged_mixed_attention": ragged_mixed_attention,
          "kv_cache_append": kv_cache_append}),
        ("deepseek-v2-lite-sim", deepseek_v2_lite(), v2, mla_path),
        # int8 weights: the experts through ragged_int8_gmm, the MLA
        # projections, shared experts and the dense layer through _mm's
        # {"q", "s"}; the latent cache stays bf16 (MLA refuses int8 KV)
        ("deepseek-v2-lite-sim", deepseek_v2_lite(), {**v2, "quantization": "int8"},
         {**mla_path, "ragged_int8_gmm": ragged_int8_gmm,
          "ragged_int8_gmm (prefill rows)": (ragged_int8_gmm, "prefill_launches")}),
        # bf16 weights over float8_e4m3fn latent pages (half the pool's
        # bytes): both latent kernels over fp8 pages and the row store's
        # cast on store at MLA widths
        ("deepseek-v2-lite-sim", deepseek_v2_lite(),
         {**v2, "kv_cache_dtype": "float8_e4m3"},
         {"mla_paged_decode_attention" + FP8_KV: mla_paged_decode_attention,
          "mla_paged_prefill_attention" + FP8_KV: mla_paged_prefill_attention,
          "kv_cache_append (MLA widths, fp8 KV)": kv_cache_append}),
        # fp8 weights through _mm and the int8-with-scales KV cache: the
        # scaled GQA kernels and the quantized append
        ("llama3-8b-sim", ModelConfig.llama3_8b(),
         dict(num_blocks=4096, block_size=16, max_batch_size=8, decode_window=4,
              quantization="fp8_e4m3", kv_cache_dtype="int8"),
         {"paged_decode_attention" + INT8_KV: paged_decode_attention,
          "paged_prefill_attention" + INT8_KV: paged_prefill_attention,
          "ragged_mixed_attention" + INT8_KV: ragged_mixed_attention,
          "kv_cache_append_quantized": kv_cache_append_quantized}),
        # bf16 weights over the scale-free fp8 KV cache, a 4096-page pool (4
        # GiB, half the bf16 pool's bytes), with speculation (gamma 3) so
        # the verify's append lands in the fp8 pages too: the three GQA
        # kernels over fp8 pages and the row store's cast on store
        ("llama3-8b-sim", ModelConfig.llama3_8b(),
         dict(num_blocks=4096, block_size=16, max_batch_size=8, decode_window=4,
              kv_cache_dtype="float8_e4m3", spec_gamma=SPEC_GAMMA),
         {"paged_decode_attention" + FP8_KV: paged_decode_attention,
          "paged_prefill_attention" + FP8_KV: paged_prefill_attention,
          "ragged_mixed_attention" + FP8_KV: ragged_mixed_attention,
          "kv_cache_append" + FP8_KV: kv_cache_append,
          "kv_cache_append_tokens" + FP8_KV: kv_cache_append_tokens}),
        # speculative decoding (prompt lookup, gamma=3), reference defaults
        # otherwise: the verify forward's multi-token append and its decode
        # attention at verify rows, beside the path's prefill kernels
        ("llama3-8b-sim", ModelConfig.llama3_8b(),
         dict(num_blocks=4096, block_size=16, max_batch_size=8, decode_window=4,
              spec_gamma=SPEC_GAMMA),
         {"paged_decode_attention": paged_decode_attention,
          "paged_prefill_attention": paged_prefill_attention,
          "ragged_mixed_attention": ragged_mixed_attention,
          "kv_cache_append_tokens": kv_cache_append_tokens,
          "paged_decode_attention" + VERIFY: (paged_decode_attention,
                                              "verify_launches")}),
        ("deepseek-v2-lite-sim", deepseek_v2_lite(), {**v2, "spec_gamma": SPEC_GAMMA},
         {"mla_paged_decode_attention": mla_paged_decode_attention,
          "mla_paged_prefill_attention": mla_paged_prefill_attention,
          "kv_cache_append_tokens (MLA widths)": kv_cache_append_tokens,
          "mla_paged_decode_attention" + VERIFY: (mla_paged_decode_attention,
                                                  "verify_launches")}),
        # the other families of the main path, at their published widths
        # and depths (random weights, q/k/v biases and q/k norm weights
        # drawn): Qwen2.5-7B's G = 7 and its 131072-token window that masks
        # nothing at max_context 8192 (C.9), Qwen3-8B's per-head q/k norms
        ("qwen2.5-7b-sim", ModelConfig.from_hf_config(QWEN25_7B_HF), v2, gqa_path),
        ("qwen3-8b-sim", ModelConfig.from_hf_config(QWEN3_8B_HF), v2, gqa_path),
        # a Mistral-7B-Instruct-v0.2 checkpoint written by the port's saver
        # (depth cut), served through dynamo_run --model-path with its
        # SentencePiece tokenizer
        (CHECKPOINT_DRIVE, mistral, v2, gqa_path),
        # gpt-oss-20b at its published widths and depth (dynamo_run's
        # preset: context cut to 8192), bf16: the windowed launches of the
        # sliding layers (the full layers run the same kernels unwindowed)
        (GPTOSS_DRIVE, PRESETS[GPTOSS_DRIVE](), v2,
         {"paged_decode_attention" + WINDOW: (paged_decode_attention,
                                              "window_launches"),
          "paged_prefill_attention" + WINDOW_SINKS: (paged_prefill_attention,
                                                     "window_launches"),
          "ragged_mixed_attention" + WINDOW_SINKS: (ragged_mixed_attention,
                                                    "window_launches"),
          "kv_cache_append": kv_cache_append}),
        # Gemma-3-12B at its published widths and depth (dynamo_run's
        # preset: context cut to 8192), bf16, a 1024-page pool (6 GiB of
        # 384 KiB tokens): every launch of the three GQA kernels and the
        # row store at D = 256 (paged_attention_wide.cu), the windowed ones
        # of its 40 sliding layers counted apart
        (GEMMA_DRIVE, PRESETS[GEMMA_DRIVE](), {**v2, "num_blocks": 1024},
         {"paged_decode_attention" + WIDE: paged_decode_attention,
          "paged_prefill_attention" + WIDE: paged_prefill_attention,
          "ragged_mixed_attention" + WIDE: ragged_mixed_attention,
          "kv_cache_append" + WIDE: kv_cache_append,
          "paged_decode_attention" + WIDE_WINDOW: (paged_decode_attention,
                                                   "window_launches"),
          "paged_prefill_attention" + WIDE_WINDOW: (paged_prefill_attention,
                                                    "window_launches"),
          "ragged_mixed_attention" + WIDE_WINDOW: (ragged_mixed_attention,
                                                   "window_launches")}),
    ]


async def serve(torch, dev, card: str, name: str, cfg, geometry: dict,
                counted: dict, plain=None, repeat: bool = False, build=None,
                oracle: bool = False, encode_ms=None):
    """One serving drive of ``name`` over HTTP; returns the launch count of
    each kernel of its path during the drive (counters zeroed just before
    it) and its answers: (texts, {prompt ids: generated ids}). A spec drive
    (``spec_gamma`` > 0) takes ``plain``, the plain drive's answers of the
    same model, must accept proposals, and reports its acceptance and the
    share of answers equal to the plain drive's. A ``repeat`` drive is the
    plain drive again on a fresh engine (nothing cached, no prefix shared
    with the first): it reports how many of its greedy answers equal the
    first drive's, and where the first different token of each other
    answer lies (C.4), and skips the anatomy. ``build`` returns (engine,
    OpenAI worker) for a drive that is not random weights behind the byte
    tokenizer (the checkpoint drive; ``encode_ms``, its tokenizer's encode
    time per request, is set beside the TTFT). An ``oracle`` drive holds
    its prefill logits to ``dense_forward`` and profiles one decode window
    only."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.http import HttpService, ModelManager
    from dynamo_tpu_torch.llm import ByteTokenizer
    from dynamo_tpu_torch.llm.openai_engine import OpenAIWorkerEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.weights import init_random_params

    t0 = time.perf_counter()
    if build is None:
        params = init_random_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        draw_attention_extras(torch, params, cfg,
                              torch.Generator(device=dev).manual_seed(5))
        engine = TorchEngine(EngineConfig(model=cfg, **geometry), params=params,
                             device=dev)
        worker = OpenAIWorkerEngine(ByteTokenizer(), engine)
    else:
        engine, worker = build()
        params = engine.params
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    # the engine serves its own (possibly quantized) weights: drop the
    # full-width ones it replaced
    params = engine.params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    planes = ({} if engine.k_scales is None else
              {"k_scales": engine.k_scales, "v_scales": engine.v_scales})
    quant = geometry.get("quantization", "none")
    log(f"  {name} (weights {quant}, KV {engine.k_cache.dtype}): "
        f"{n_params / 1e9:.2f}B params, {cfg.num_layers} layers, weights "
        f"{engine._hbm_stats()['weights'] / 2**30:.2f} GiB, KV pool "
        f"{engine._hbm_stats()['kv_pool'] / 2**30:.2f} GiB, ready in "
        f"{time.perf_counter() - t0:.3f} s")
    # dynamo_run --warmup's order: every reachable program key dispatched
    # (the decode windows captured) before the port opens
    t0 = time.perf_counter()
    sizes = await engine.warmup()
    log(f"  warmup: prefill buckets {sizes} + decode window ladder in "
        f"{time.perf_counter() - t0:.2f} s; ledger {len(engine.compile_ledger)} "
        f"entries, {engine.stats['xla_compile_ms_total']:.1f} ms of first "
        f"dispatches (" + ", ".join(
            f"{e['kind']} {e['key']}{' graph ' + str(e['graph']) if 'graph' in e else ''}"
            f" {e['ms']:.1f}" for e in engine.compile_ledger)
        + f"); {len(engine._graphs.graphs)} CUDA graphs, pool "
        f"{engine._graphs.pool_bytes()} bytes")
    manager = ModelManager()
    manager.add_chat_model(name, worker)
    manager.add_completion_model(name, worker)
    svc = HttpService(manager, host="127.0.0.1", port=0)
    await svc.start()

    def completion(n_bytes, stream):
        prompt = ("The paged cache holds every token. " * 64)[:n_bytes]
        return "/v1/completions", {
            "model": name, "prompt": prompt, "max_tokens": 32,
            "temperature": 0.0, "stream": stream, "nvext": {"ignore_eos": True},
        }

    counters = {k: c if isinstance(c, tuple) else (c, "launches")
                for k, c in counted.items()}
    spec = geometry.get("spec_gamma", 0) > 0
    verifies = []  # (sequences verified, tokens they produced) per verify
    answers = {}  # prompt ids -> generated ids, per finished request
    dispatch, finish = engine._dispatch_verify, engine._finish

    def counted_verify(window, proposals, steps):
        out = dispatch(window, proposals, steps)
        live = [i for i, q in enumerate(engine._active)
                if q is not None and not q.finished]
        verifies.append((len(live), sum(int(out[1][i]) + 1 for i in live)))
        return out

    def recorded_finish(seq, reason, emit=True):
        if not seq.finished:
            answers[tuple(seq.tokens[:seq.prompt_len])] = seq.tokens[seq.prompt_len:]
        finish(seq, reason, emit)

    engine._dispatch_verify, engine._finish = counted_verify, recorded_finish

    async def requests():
        """The drive's seven requests; returns (results, wall seconds)."""
        t_start = time.perf_counter()
        n0 = engine.stats["tokens_generated"]
        # one request alone: the dedicated prefill program
        first = asyncio.create_task(http_request(svc.port, *completion(1200, True)))
        while engine.stats["tokens_generated"] < n0 + 2 and not first.done():
            await asyncio.sleep(0.01)
        # more while it decodes: fused mixed steps (on gpt-oss every prompt
        # longer than its window, so every sliding layer windows)
        shortest = 64 if not cfg.layer_windows else 2 * max(cfg.layer_windows)
        more = [completion(n, n % 2 == 0)
                for n in (shortest, 333, 700, 1100, 1500)]
        more.append(("/v1/chat/completions", {
            "model": name, "max_tokens": 32, "temperature": 0.0,
            "stream": True, "nvext": {"ignore_eos": True},
            "messages": [{"role": "user", "content": "Describe paged attention. " * 8}],
        }))
        results = [await first] + list(await asyncio.gather(
            *[http_request(svc.port, p, b) for p, b in more]))
        return results, time.perf_counter() - t_start

    def report(label, results, wall, before):
        """Log one pass: its answers, schedule, TTFT / ITL / tok/s and, on
        a spec drive, its speculation; returns the answers' texts and the
        pass's engine counters."""
        st = {k: v - before.get(k, 0) for k, v in engine.stats.items()
              if isinstance(v, int)}
        for i, (status, text, times) in enumerate(results):
            if status != 200 or not text:
                raise AssertionError(f"{name} request {i}: status {status}, "
                                     f"text {text!r}")
        streamed = [t for _s, _x, t in results if len(t) > 1]
        ttft = [t[0] * 1e3 for t in streamed]
        # per request: the mean gap from its first to its last text event
        # (a decode window emits its tokens together: single gaps are bursty)
        itl = [(t[-1] - t[0]) * 1e3 / (len(t) - 1) for t in streamed]
        log(f"  {label}{len(results)} requests answered 200 with text; engine: "
            f"{st['prefill_chunks']} dedicated prefill chunks, "
            f"{st['mixed_steps']} mixed steps, {st['decode_windows']} decode "
            f"windows ({st['decode_steps']} decode steps)")
        log(f"  TTFT ms (streamed requests): {[round(x, 1) for x in ttft]}; "
            f"ITL (per request, mean) median {statistics.median(itl):.2f} ms; "
            f"{st['tokens_generated']} tokens in {wall:.2f} s = "
            f"{st['tokens_generated'] / wall:.1f} tok/s  [{name}, {card}]")
        if encode_ms is not None:
            log(f"  tokenizer encode {encode_ms:.2f} ms per request (host, "
                f"measured apart) = {encode_ms / statistics.median(ttft):.1%} "
                f"of the median TTFT  [{name}, {card}]")
        texts = [text for _s, text, _t in results]
        if spec:
            n_ver, rows = len(verifies), sum(n for n, _ in verifies)
            produced = sum(e for _, e in verifies)
            verifies.clear()
            same = sum(a == b for a, b in zip(texts, plain[0]))
            log(f"  speculation: {st['spec_proposed']} proposed, "
                f"{st['spec_accepted']} accepted "
                f"({st['spec_accepted'] / max(st['spec_proposed'], 1):.1%}); "
                f"{n_ver} verifies ({rows} sequence rows) produced {produced} "
                f"tokens ({produced / max(n_ver, 1):.2f} per verify, "
                f"{produced / max(rows, 1):.2f} per row); answers equal to "
                f"the plain drive's: {same} of {len(texts)}  [{name}, {card}]")
        return texts, st

    for f, attr in counters.values():
        setattr(f, attr, 0)
    try:
        if repeat:
            texts, _ = report("fresh engine, the plain drive again: ",
                              *await requests(), {})
            same = sum(a == b for a, b in zip(texts, plain[0]))
            first_diff = []
            for prompt, ids in answers.items():
                ref = plain[1].get(prompt, [])
                if ids != ref:
                    first_diff.append(next((i for i, (a, b) in enumerate(zip(ids, ref))
                                            if a != b), min(len(ids), len(ref))))
            log(f"  C.4 run to run on fresh engines: greedy answers equal to the "
                f"first drive's: {same} of {len(texts)}; first different token "
                f"of the others at {sorted(first_diff)}  [{name}, {card}]")
        elif not spec:
            texts, _ = report("", *await requests(), {})
            if cfg.is_mla and engine.k_cache.dtype == torch.float8_e4m3fn:
                # a quality reading, not a gate: random-weight near-ties
                # may flip under fp8 pages
                same = sum(a == b for a, b in zip(texts, plain[0]))
                log(f"  fp8 latent pages: {engine.kv_block_bytes // engine.cfg.block_size}"
                    f" pool bytes per token (bf16 pages: "
                    f"{2 * engine.kv_block_bytes // engine.cfg.block_size}); "
                    f"answers equal to the bf16 drive's: {same} of {len(texts)}"
                    f"  [{name}, {card}]")
        elif engine.k_cache.dtype == torch.float8_e4m3fn:
            # the fp8 drive: prompt lookup first (nothing to find on random
            # weights, so plain decode windows: its answers against the
            # bf16 drive's are the fp8 pages' quality reading), then drafts
            # from those answers (verifies over fp8 pages, their appends
            # cast on store; acceptance as the bf16 spec drive's)
            texts, _ = report("prompt lookup (answers vs the bf16 drive's): ",
                              *await requests(), {})
            own = dict(answers)
            engine._propose_ngram = lambda: oracle_drafts(engine, own)
            before = dict(engine.stats)
            _, st = report("drafts from the first pass's answers (prefixes "
                           "cached): ", *await requests(), before)
            del engine._propose_ngram
            if st["spec_accepted"] <= 0:
                raise AssertionError(f"{name}: no proposal accepted while serving")
        else:
            # a random model's answers never repeat an n-gram of their
            # context, so prompt lookup finds nothing to propose (the
            # second pass shows it). The first pass proposes what a draft
            # that always agrees with the target would: each request's
            # plain-drive answer (as tests/test_speculative.py does), on a
            # fresh engine whose prefills match the plain drive's; its
            # acceptance is then how often the verify's argmax agrees with
            # the plain decode path's at this model's width
            engine._propose_ngram = lambda: oracle_drafts(engine, plain[1])
            texts, st = report("drafts from the plain drive's answers: ",
                               *await requests(), {})
            accepted = st["spec_accepted"]
            del engine._propose_ngram  # the engine's own prompt lookup
            before = dict(engine.stats)
            report("prompt lookup (prefixes cached by the first pass): ",
                   *await requests(), before)
            if accepted <= 0:
                raise AssertionError(f"{name}: no proposal accepted while serving")
    finally:
        await svc.close()
        await engine.close()
    launches = {k: getattr(f, attr) for k, (f, attr) in counters.items()}
    log(f"  launches during serving: {launches}; CUDA graphs "
        f"{len(engine._graphs.graphs)} ({engine._graphs.replays} replays), "
        f"pool {engine._graphs.pool_bytes()} bytes, ledger "
        f"{engine.load_metrics()['xla_compiles_total']} first dispatches")
    if planes:
        lm = engine.load_metrics()
        log("  int8 KV lane: " + ", ".join(
            f"{k} {lm[k]}" for k in ("kv_device_quant_pages", "kv_device_requants_total",
                                     "kv_device_bytes_saved_total", "lowprec_tok_s")))
        if lm["kv_device_requants_total"] <= 0:
            raise AssertionError(f"{name}: no page requantized while serving")
    missing = [k for k, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched while serving: {missing}")
    # what comes out of the big model is finite and of the expected shape
    kc, vc = llama.init_kv_cache(cfg, 8, 16, device=dev, dtype=engine.k_cache.dtype)
    small = {k: torch.full((cfg.num_layers, 8), 1e-12, device=dev) for k in planes}
    toks = torch.arange(100, 164, dtype=torch.int32, device=dev)
    logits = llama.prefill(params, cfg, toks, torch.arange(
        1, 8, dtype=torch.int32, device=dev), 0, 64, kc, vc, **small)[0]
    if logits.shape != (cfg.vocab_size,) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} prefill logits not finite [V]")
    if repeat:
        return launches, (texts, answers)
    if spec:
        if engine.k_cache.dtype == torch.float8_e4m3fn:
            # the fp8 drive: its replays and its step anatomy as the plain
            # drives', and how far fp8 pages move a prefill's logits
            check_graphs(torch, engine, name, card)
            step_anatomy(torch, dev, engine)
            fp8_logit_gap(torch, dev, card, name, params, cfg)
        verify_anatomy(torch, dev, engine)
        return launches, (texts, answers)
    if oracle:
        dense_oracle(torch, dev, card, name, params, cfg)
        step_anatomy(torch, dev, engine, decode_only=True)
        return launches, (texts, answers)
    check_graphs(torch, engine, name, card)
    step_anatomy(torch, dev, engine, planes)
    if cfg.is_mla and engine.k_cache.dtype == torch.float8_e4m3fn:
        mla_fp8_oracle(torch, dev, card, name, params, cfg)
    if cfg.attn_sinks:
        gptoss_oracle(torch, dev, card, name, params, cfg)
    if cfg.rope_local_theta:
        gemma_oracle(torch, dev, card, name, params, cfg)
    if quant != "none":
        dequant_cost(torch, params)
    else:
        determinism_probe(torch, dev, params, cfg, engine.k_cache, engine.v_cache)
        if not (cfg.is_mla or cfg.is_moe):
            dense_mm_cost(torch, dev, params, cfg)
    return launches, (texts, answers)


def anatomy(torch, label: str, fn, n: int) -> None:
    """Wall time of ``fn`` per step (``n`` steps per call, profiler off),
    the host syncs it makes (CUDA sync debug mode: each call that waits
    for the card, such as ``.tolist()`` of a device tensor), then under
    torch.profiler the card's kernel time, kernel count, the host's launch
    calls (the runtime's kernel and graph launches: one per kernel when
    eager, one per replay for a CUDA graph), the three kernels that take
    most of it and the time of each of the port's own kernels: how much of
    a step the card is busy, and with what."""
    import warnings
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, count = defaultdict(float), defaultdict(int)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    host_launches = sum(1 for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CPU
                        and re.match(r"cu\w*Launch", e.name))
    for e in kernels:
        by_name[e.name] += e.device_time_total / 1e3 / n
        count[e.name] += 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    # the port's own kernels (the __global__ functions of csrc/*.cu) by
    # name: ms and launches per step
    ours, ours_n, port = defaultdict(float), defaultdict(float), port_kernel_names()
    for name, ms in by_name.items():
        for k in port:
            if re.search(rf"\b{k}\b", name):
                ours[k] += ms
                ours_n[k] += count[name] / n
    # the host side under the profiler (which slows it): the operators
    # taking the most CPU time themselves, and the launch calls' share
    host = sorted(((a.key, a.self_cpu_time_total / 1e3 / n)
                   for a in prof.key_averages() if a.self_cpu_time_total > 0),
                  key=lambda kv: -kv[1])
    log(f"  {label}: {wall:.2f} ms wall per step, {busy:.2f} ms of kernels "
        f"({busy / wall:.0%} busy), {len(kernels) / n:.0f} kernel launches "
        f"({host_launches / n:.1f} launch calls on the host) "
        f"and {syncs / n:.2f} host syncs per step; top: "
        + "; ".join(f"{k[:48]} {v:.2f} ms" for k, v in top)
        + "; the port's kernels: "
        + "; ".join(f"{k} {v:.2f} ms ({ours_n[k]:.0f} launches)"
                    for k, v in sorted(ours.items()))
        + "; host (profiled) top: "
        + "; ".join(f"{k[:40]} {v:.2f} ms" for k, v in host[:4]))


def port_kernel_names() -> set:
    """The names of the __global__ functions in the port's CUDA sources and
    the headers they include."""
    from dynamo_tpu_torch.ops import _cuda

    names = set()
    for path in sorted(_cuda.SRC_DIR.glob("*.cu*")):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            path.read_text()))
    return names


def dequant_cost(torch, params) -> None:
    """What the plain dequantize of the dense projections costs per step:
    every quantized dense leaf of every layer widened to bf16 once (what
    ``_mm`` does per call; expert stacks excluded, the grouped kernel reads
    their codes), timed with CUDA events."""
    leaves = [(v["q"], i) for grp in ("dense_layers", "layers")
              for k, v in params.get(grp, {}).items()
              if isinstance(v, dict) and "q" in v and not k.startswith("we_")
              for i in range(v["q"].shape[0])]
    nbytes = sum(q[i].numel() for q, i in leaves)

    def run():
        for q, i in leaves:
            q[i].to(torch.bfloat16)

    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    log(f"  dense dequantize per step: {ms:.3f} ms for {len(leaves)} weight "
        f"matrices ({nbytes / 1e9:.2f} GB of codes read, "
        f"{2 * nbytes / 1e9:.2f} GB of bf16 written)")


def dense_mm_cost(torch, dev, params, cfg) -> None:
    """What the dense projections of one decode step (8 rows) cost in each
    weight form: layer 0's seven matrices as bf16, int8 and fp8_e4m3
    (``{"q", "s"}``: widen the codes, then the product) and int8_native
    (per-row activation quantization, ``torch._int_mm`` on the column-major
    codes, both scales; also its ``torch._int_mm`` calls alone), timed with
    CUDA events (median of 5 passes) and counted for every layer. No
    serving drive runs int8_native, which ``dynamo_run --quantization
    int8_native`` serves."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.quant import quantize_array

    def per_step_ms(fn):
        fn()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times) * cfg.num_layers

    keys = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    gen = torch.Generator(device=dev).manual_seed(3)
    mats = {k: params["layers"][k][0] for k in keys}
    x = {k: torch.randn(8, w.shape[0], generator=gen, device=dev,
                        dtype=torch.bfloat16) for k, w in mats.items()}
    costs = {}
    for mode in ("none", "int8", "fp8_e4m3", "int8_native"):
        ws = {k: w if mode == "none" else quantize_array(w, mode)
              for k, w in mats.items()}
        costs[mode] = per_step_ms(lambda: [llama._mm(x[k], ws[k]) for k in keys])
    # int8_native's products alone: 17 rows of codes (the padding _int_mm
    # takes for 8)
    xq = {k: torch.randint(-127, 128, (17, v.shape[1]), generator=gen, device=dev,
                           dtype=torch.int8) for k, v in x.items()}
    costs["int8_native, torch._int_mm alone"] = per_step_ms(
        lambda: [torch._int_mm(xq[k], ws[k]["qn"]) for k in keys])
    log("  dense projections per decode step (8 rows, layer 0 x "
        f"{cfg.num_layers}): " + ", ".join(f"{m} {ms:.3f} ms" for m, ms in costs.items()))


def step_anatomy(torch, dev, engine, planes=None, decode_only: bool = False) -> None:
    """The served engine's 4-step decode window (B=8 at ~1k context),
    eager and replayed (graph_anatomy), then (unless ``decode_only``) a
    lone prompt's dedicated prefill (1201 tokens in the 2048 bucket) and,
    for GQA, a fused mixed step (B=8 decode rows at ~1k and a 512-token
    segment) of the served model on its serving cache (and scale planes,
    with the int8 cache), both eager as they serve."""
    planes = planes or {}
    from dynamo_tpu_torch.models import llama

    params, cfg = engine.params, engine.cfg.model
    k_cache, v_cache = engine.k_cache, engine.v_cache
    graph_anatomy(torch, engine, "decode step (B=8, ~1k context)", "decode")
    if decode_only:
        return
    B = 8
    tables = torch.arange(1, 1 + B * 80, dtype=torch.int32, device=dev).reshape(B, 80)
    lens = torch.arange(1000, 1000 + B, dtype=torch.int32, device=dev)
    toks = torch.arange(300, 300 + B, dtype=torch.int32, device=dev)
    samp = (torch.zeros(B, device=dev), torch.zeros(B, dtype=torch.int32, device=dev),
            torch.ones(B, device=dev))
    prompt = torch.zeros(2048, dtype=torch.int32, device=dev)
    prompt[:1201] = torch.arange(1201, device=dev) % 250 + 3
    table = torch.arange(700, 828, dtype=torch.int32, device=dev)
    anatomy(torch, "dedicated prefill (1201 tokens, 2048 bucket)",
            lambda: llama.prefill(params, cfg, prompt, table, 0, 1201,
                                  k_cache, v_cache, **planes), 1)
    if cfg.is_mla:
        return
    # the fused step: the 8 decode rows plus one 512-token segment (400
    # real) on its own pages, one ragged attention launch per layer
    seg = (torch.arange(512, dtype=torch.int32, device=dev) % 250 + 3)[None]
    seg_table = torch.arange(900, 980, dtype=torch.int32, device=dev)[None]
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    anatomy(torch, "mixed step (B=8 at ~1k + a 512-token segment, 400 real)",
            lambda: llama.mixed_step(
                params, cfg, toks, lens - 1, tables, lens, [0] * B, [0] * B,
                *samp, seg, seg_table, zero, zero + 400, k_cache, v_cache,
                **planes), 1)


def dense_oracle(torch, dev, card: str, name: str, params, cfg,
                 knockout=None, T: int = 256, cut: int = 192) -> None:
    """The full-width check of the served model's forward: a ``T``-token
    prompt (256) prefilled in two chunks (``cut`` = 192, then the rest
    over the first's cached pages: paged_prefill_attention both times),
    its last logits against
    ``dense_forward``'s (plain full attention, no cache, no kernel of the
    port) on the same bf16 weights, and both against ``dense_forward`` in
    f32 on the same weights widened: the served path's distance to the
    f32 logits at most ORACLE_FACTOR times the plain bf16 forward's. A
    ``knockout`` (what, f32 params -> f32 params without it) is the
    witness that the check can see a part of the model: the f32 forward
    without it must lie further than the tolerance from the f32 forward."""
    import dataclasses

    from dynamo_tpu_torch.models import llama

    toks = ((torch.arange(T, device=dev) * 7919) % (cfg.vocab_size - 3) + 3).to(torch.int32)
    pages = -(-T // 16)
    kc, vc = llama.init_kv_cache(cfg, pages + 8, 16, device=dev)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)
    llama.prefill(params, cfg, toks[:cut].contiguous(), table, 0, cut, kc, vc)
    paged = llama.prefill(params, cfg, toks[cut:].contiguous(), table, cut,
                          T - cut, kc, vc)[0]
    dense = llama.dense_forward(params, cfg, toks)[-1]
    wide = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
                else v.float()) for k, v in params.items()}
    f32 = dataclasses.replace(cfg, dtype="float32")
    exact = llama.dense_forward(wide, f32, toks)[-1]
    seen = None
    if knockout is not None:
        seen = float((llama.dense_forward(knockout[1](wide), f32, toks)[-1]
                      - exact).abs().max())
    del wide
    err = float((paged - exact).abs().max())
    base = float((dense - exact).abs().max())
    scale = float(exact.abs().max())
    top2 = exact.topk(2).values
    log(f"  full-width oracle, last logits of a {cut} + {T - cut}-token prefill: served "
        f"bf16 vs dense_forward f32 max |dlogit| {err:.4f}, dense_forward bf16 "
        f"vs f32 {base:.4f} ({err / base:.2f}x; tolerance {ORACLE_FACTOR}x), "
        f"served vs dense_forward bf16 "
        f"{float((paged - dense).abs().max()):.4f}; max |logit| {scale:.3f}; "
        f"argmax equal to f32: served {int(paged.argmax()) == int(exact.argmax())}"
        f", dense bf16 {int(dense.argmax()) == int(exact.argmax())} (top-1 - "
        f"top-2 gap {float(top2[0] - top2[1]):.4f})  [{name}, {card}]")
    if not (bool(torch.isfinite(paged).all()) and err <= ORACLE_FACTOR * base):
        raise AssertionError(f"{name}: the served prefill's logits are {err:.4f} "
                             f"from the f32 forward's, the bf16 dense forward's "
                             f"{base:.4f} (tolerance {ORACLE_FACTOR}x)")
    if knockout is not None:
        log(f"  witness: the f32 forward with {knockout[0]} is {seen:.4f} from "
            f"the f32 forward's logits ({seen / base:.1f}x the bf16 forward's "
            f"distance; the check fails above {ORACLE_FACTOR}x)  [{name}]")
        if not seen > ORACLE_FACTOR * base:
            raise AssertionError(f"{name}: the oracle cannot tell "
                                 f"{knockout[0]} ({seen:.4f})")


def gptoss_oracle(torch, dev, card: str, name: str, params, cfg) -> None:
    """dense_oracle on the served gpt-oss weights' first GPTOSS_ORACLE_LAYERS
    layers (full width; their f32 copy fits beside the served model), two
    windowed and two full, whose sinks draw_attention_extras drew near
    ln(window) (a real share of each row's mass, where the init's N(0, 0.5)
    holds under 1% over 128 scores and a dropped sink would hide in the
    bf16 noise). The 192 + 64-token prefill windows on the sliding layers
    and folds the sinks in the bf16 tensor-core tiles; the witness knocks
    the sinks out (-1e4). The router's logit bias is set to route every
    token to the same k experts of a layer (+50 on them, 0 elsewhere;
    the combine weights still follow the tokens): with random weights a
    top-k choice is often within bf16 noise of a tie, and one choice
    flipped by the sums' order moves the last logits by ~1 (as much as
    the whole check's tolerance) in either bf16 forward (the served path
    or the dense one), which no kernel fault would need to explain."""
    import dataclasses

    L = GPTOSS_ORACLE_LAYERS
    cut = dataclasses.replace(cfg, num_layers=L,
                              layer_windows=cfg.layer_windows[:L])
    layers = {k: v[:L] for k, v in params["layers"].items()}
    g = torch.Generator(device=dev).manual_seed(13)
    bias = torch.zeros_like(layers["moe_router_bias"])
    for l in range(L):
        chosen = torch.randperm(cfg.num_experts, generator=g, device=dev)
        bias[l, chosen[:cfg.num_experts_per_tok]] = 50.0
    layers["moe_router_bias"] = bias

    def sinkless(wide):
        return {**wide, "layers": {**wide["layers"], "sinks": torch.full_like(
            wide["layers"]["sinks"], -1e4)}}

    dense_oracle(torch, dev, card, f"{name}, first {L} layers",
                 {**params, "layers": layers}, cut,
                 knockout=("the sinks knocked out", sinkless))


def mla_fp8_oracle(torch, dev, card: str, name: str, params, cfg,
                   T: int = 1201) -> None:
    """The fp8 V2-Lite drive's first prefill held to the port's plain path
    over fp8 latent pages: the served weights' first MLA_ORACLE_LAYERS
    layers (the dense one and three MoE layers, every token routed to the
    same experts of a layer by a +50 router logit, as gptoss_oracle does:
    a near-tie flipped by the sums' order would move the logits in either
    bf16 forward), one ``T``-token prompt prefilled in one chunk over fresh
    fp8 pages three ways: the served path (the latent prefill kernel), the
    same in bf16 with the kernel's plain twin in its place, and that plain
    path in f32 on the same weights widened (the pages fp8 all the same).
    The kernel path's last logits may lie at most ORACLE_FACTOR times as
    far from the f32 plain path's as the bf16 plain path's do."""
    import dataclasses

    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops import mla_attention as mla

    L = MLA_ORACLE_LAYERS
    k = cfg.first_dense_layers
    cut = dataclasses.replace(cfg, num_layers=L)
    layers = {key: v[:L - k] for key, v in params["layers"].items()}
    g = torch.Generator(device=dev).manual_seed(13)
    bias = torch.zeros(L - k, cfg.num_experts, device=dev)
    for l in range(L - k):
        chosen = torch.randperm(cfg.num_experts, generator=g, device=dev)
        bias[l, chosen[:cfg.num_experts_per_tok]] = 50.0
    layers["moe_router_bias"] = bias
    small = {**params, "layers": layers}
    prompt = torch.zeros(2048, dtype=torch.int32, device=dev)
    prompt[:T] = torch.arange(T, device=dev) % 250 + 3
    table = torch.arange(1, 129, dtype=torch.int32, device=dev)

    def prefill(p, c, plain: bool):
        kc, vc = llama.init_kv_cache(c, 130, 16, device=dev,
                                     dtype=torch.float8_e4m3fn)
        kernel = llama.mla_paged_prefill_attention
        if plain:
            llama.mla_paged_prefill_attention = mla.mla_paged_prefill_attention_plain
        try:
            return llama.prefill(p, c, prompt, table, 0, T, kc, vc)[0]
        finally:
            llama.mla_paged_prefill_attention = kernel

    served = prefill(small, cut, plain=False)
    plain_bf16 = prefill(small, cut, plain=True)
    wide = {key: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
                  else v.float()) for key, v in small.items()}
    exact = prefill(wide, dataclasses.replace(cut, dtype="float32"), plain=True)
    del wide
    err = float((served - exact).abs().max())
    base = float((plain_bf16 - exact).abs().max())
    log(f"  fp8 latent pages, first {L} layers, one {T}-token prefill: served "
        f"(kernel) vs the plain f32 path max |dlogit| {err:.4f}, the plain bf16 "
        f"path vs f32 {base:.4f} ({err / base:.2f}x; tolerance {ORACLE_FACTOR}x), "
        f"served vs plain bf16 {float((served - plain_bf16).abs().max()):.4f}; "
        f"max |logit| {float(exact.abs().max()):.3f}; argmax equal to f32: "
        f"served {int(served.argmax()) == int(exact.argmax())}  [{name}, {card}]")
    if not (bool(torch.isfinite(served).all()) and err <= ORACLE_FACTOR * base):
        raise AssertionError(f"{name}: the fp8 prefill's logits are {err:.4f} from "
                             f"the plain f32 path's, the plain bf16 path's {base:.4f}"
                             f" (tolerance {ORACLE_FACTOR}x)")


def gemma_oracle(torch, dev, card: str, name: str, params, cfg) -> None:
    """dense_oracle on the served Gemma-3 weights' first GEMMA_ORACLE_LAYERS
    layers (full width: five windowed, the first full one), over a
    1280-token prompt prefilled as 1152 + 128 tokens, so the second chunk's
    rows keep 1024 of the 1151-1279 positions before them on the windowed
    layers (window floors and the local rope) and all of them on the full
    layer (the linear rope). The witness knocks out the sandwich norms
    (their leaves dropped: each sublayer's output added unnormed)."""
    import dataclasses

    L = GEMMA_ORACLE_LAYERS
    cut = dataclasses.replace(cfg, num_layers=L,
                              layer_windows=cfg.layer_windows[:L])
    layers = {k: v[:L] for k, v in params["layers"].items()}

    def unnormed(wide):
        return {**wide, "layers": {k: v for k, v in wide["layers"].items()
                                   if "post_norm" not in k}}

    dense_oracle(torch, dev, card, f"{name}, first {L} layers",
                 {**params, "layers": layers}, cut,
                 knockout=("the sandwich norms knocked out", unnormed),
                 T=1280, cut=1152)


#: a Mistral-style [INST] chat template for the checkpoint's tokenizer
MISTRAL_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if message['role'] == 'user' %}[INST] {{ message['content'] }} [/INST]"
    "{% else %}{{ message['content'] }}{{ eos_token }}{% endif %}{% endfor %}")


async def serve_checkpoint(torch, dev, card: str, cfg, counted: dict) -> dict:
    """The checkpoint drive: Mistral-7B-Instruct-v0.2's config.json (depth
    cut to CHECKPOINT_LAYERS), bf16 random weights written by the port's
    ``save_llama_params`` into a directory beside this script with the
    repo's 32,000-piece SentencePiece vocab as ``tokenizer.model`` and a
    ``tokenizer_config.json`` naming <s> / </s>; then ``dynamo_run``'s own
    ``parse_args`` and ``build_engine`` from ``--model-path <dir>``. Every
    loaded leaf must equal the saved one and a prefill's logits from the
    loaded weights those from the saved ones, bit for bit; then the drive
    serves over HTTP with SentencePiece tokenization and streamed
    detokenization. Returns its launch counts; the directory is removed."""
    import os
    import shutil
    import tempfile

    from dynamo_tpu_torch.launch import dynamo_run
    from dynamo_tpu_torch.llm.tokenizer import SPTokenizer
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import MISTRAL_7B_V02_HF
    from dynamo_tpu_torch.models.weights import init_random_params, save_llama_params

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=root)
    try:
        ckpt = os.path.join(tmp, "mistral-7b-instruct-v0.2")
        os.mkdir(ckpt)
        log(f"  {CHECKPOINT_DRIVE}: num_hidden_layers cut from "
            f"{MISTRAL_7B_V02_HF['num_hidden_layers']} to {CHECKPOINT_LAYERS} "
            f"(disk and write time); every width as published")
        t0 = time.perf_counter()
        saved = init_random_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        save_llama_params(ckpt, saved, cfg)
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump({**MISTRAL_7B_V02_HF, "num_hidden_layers": CHECKPOINT_LAYERS}, f)
        shutil.copy(os.path.join(root, "tests", "data", "real_sp", "tinyllama.model"),
                    os.path.join(ckpt, "tokenizer.model"))
        with open(os.path.join(ckpt, "tokenizer_config.json"), "w") as f:
            json.dump({"bos_token": "<s>", "eos_token": "</s>",
                       "chat_template": MISTRAL_TEMPLATE}, f)
        size = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        t_write = time.perf_counter() - t0
        args = dynamo_run.parse_args(
            ["in=http", "out=torch", "--model-path", ckpt, "--num-blocks", "4096",
             "--block-size", "16", "--max-batch", "8", "--decode-window", "4",
             "--max-context", "8192"])
        _cfg, tok, _name, weights = dynamo_run.build_model(args)
        if not (isinstance(tok, SPTokenizer) and weights == ckpt
                and tok.vocab_size == cfg.vocab_size):
            raise AssertionError(f"{CHECKPOINT_DRIVE}: build_model gave {tok!r}, "
                                 f"weights {weights!r}")
        t0 = time.perf_counter()
        worker, engine, served = dynamo_run.build_engine(args)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        bad = [f"{g}.{k}" for g, leaves in saved.items()
               for k, t in (leaves.items() if isinstance(leaves, dict) else [("", leaves)])
               if not torch.equal(
                   (engine.params[g][k] if k else engine.params[g]), t)]
        toks = torch.arange(100, 164, dtype=torch.int32, device=dev)
        table = torch.arange(1, 5, dtype=torch.int32, device=dev)
        logits = [llama.prefill(p, cfg, toks, table, 0, 64,
                                *llama.init_kv_cache(cfg, 8, 16, device=dev))[0]
                  for p in (saved, engine.params)]
        same = torch.equal(logits[0], logits[1])
        log(f"  checkpoint: {size / 1e9:.2f} GB in {os.listdir(ckpt)} written in "
            f"{t_write:.1f} s; dynamo_run --model-path built the engine in "
            f"{t_load:.1f} s; leaves bit-equal to the saved ones: "
            f"{not bad}; prefill logits from the loaded weights bit-equal: {same}")
        if bad or not same:
            raise AssertionError(f"{CHECKPOINT_DRIVE}: loaded weights differ from "
                                 f"the saved ones: {bad[:5]}, logits equal {same}")
        del saved, logits
        # the SentencePiece encode of the drive's prompts, apart from serving
        prompts = [("The paged cache holds every token. " * 64)[:n]
                   for n in (1200, 64, 333, 700, 1100, 1500)]
        t0 = time.perf_counter()
        n_ids = sum(len(tok.encode(p, add_special_tokens=True)) for p in prompts)
        encode_ms = (time.perf_counter() - t0) * 1e3 / len(prompts)
        log(f"  SentencePiece encode (pure Python, {tok.vocab_size} pieces): "
            f"{encode_ms:.2f} ms per request over {len(prompts)} prompts of "
            f"64-1500 bytes ({n_ids} ids)")
        launches, _ = await serve(
            torch, dev, card, served, cfg, {}, counted,
            build=lambda: (engine, worker), oracle=True, encode_ms=encode_ms)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def determinism_probe(torch, dev, params, cfg, k_cache, v_cache) -> None:
    """Run to run on the card, for a bf16 model: the same dedicated prefill
    (1201 tokens) twice, and the same merged decode step (B=8 at ~1k) twice,
    on the same cache: are the logits the same bits? Then what a prefix-
    cache hit changes: the same prompt with its first 1184 tokens cached
    (74 pages, written by that prefill) and its last 17 as a chunk, against
    the one-chunk prefill's logits (other GEMM shapes, other bf16 sums)."""
    from dynamo_tpu_torch.models import llama

    B = 8
    tables = torch.arange(1, 1 + B * 80, dtype=torch.int32, device=dev).reshape(B, 80)
    lens = torch.arange(1000, 1000 + B, dtype=torch.int32, device=dev)
    toks = torch.arange(300, 300 + B, dtype=torch.int32, device=dev)
    prompt = torch.zeros(2048, dtype=torch.int32, device=dev)
    prompt[:1201] = torch.arange(1201, device=dev) % 250 + 3
    table = torch.arange(700, 828, dtype=torch.int32, device=dev)
    with torch.no_grad():
        pre = [llama.prefill(params, cfg, prompt, table, 0, 1201, k_cache,
                             v_cache)[0] for _ in range(2)]
        dec = [llama._decode_body(params, cfg, toks, lens - 1, tables, lens,
                                  k_cache, v_cache)[0] for _ in range(2)]
        hit = llama.prefill(params, cfg, prompt[1184:1216].contiguous(), table,
                            1184, 17, k_cache, v_cache)[0]
    top2 = pre[0].topk(2).values
    log(f"  run to run on the card: prefill logits bit-equal "
        f"{torch.equal(pre[0], pre[1])}, decode-step logits bit-equal "
        f"{torch.equal(dec[0], dec[1])}; 1184 cached + 17 vs one 1201-token "
        f"chunk: max |dlogit| {float((hit - pre[0]).abs().max()):.4f} (top-1 - "
        f"top-2 gap {float(top2[0] - top2[1]):.4f}), argmax equal "
        f"{int(hit.argmax()) == int(pre[0].argmax())}")


def fp8_logit_gap(torch, dev, card: str, name: str, params, cfg) -> None:
    """A quality reading, not a gate: the served weights' prefill of one
    1201-token prompt over fp8 pages against the same prefill over bf16
    pages (fresh caches, the same chunk): the largest logit gap, whether
    the argmax agrees, and the bf16 prefill's own top-1 - top-2 gap."""
    from dynamo_tpu_torch.models import llama

    prompt = torch.zeros(2048, dtype=torch.int32, device=dev)
    prompt[:1201] = torch.arange(1201, device=dev) % 250 + 3
    table = torch.arange(1, 129, dtype=torch.int32, device=dev)
    logits = {}
    for dt in (torch.bfloat16, torch.float8_e4m3fn):
        kc, vc = llama.init_kv_cache(cfg, 130, 16, device=dev, dtype=dt)
        logits[dt] = llama.prefill(params, cfg, prompt, table, 0, 1201, kc, vc)[0]
        del kc, vc
    ref, got = logits[torch.bfloat16], logits[torch.float8_e4m3fn]
    top2 = ref.topk(2).values
    log(f"  fp8 vs bf16 pages, one 1201-token prefill: max |dlogit| "
        f"{float((got - ref).abs().max()):.4f} (max |logit| "
        f"{float(ref.abs().max()):.3f}), argmax equal "
        f"{int(got.argmax()) == int(ref.argmax())} (bf16 top-1 - top-2 gap "
        f"{float(top2[0] - top2[1]):.4f})  [{name}, {card}]")


def oracle_drafts(engine, answers: dict):
    """Proposals for a spec drive's second pass: each active request's next
    ``spec_gamma`` tokens of its answer in the first pass (``answers``:
    prompt ids -> generated ids), -1 where it has none; None when no slot
    has one (the engine's ``_propose_ngram`` contract)."""
    import numpy as np

    g = engine.cfg.spec_gamma
    prop = np.full((engine.cfg.max_batch_size, g), -1, np.int64)
    for i, seq in enumerate(engine._active):
        if seq is None or seq.finished:
            continue
        ref = answers.get(tuple(seq.tokens[: seq.prompt_len]), [])
        nxt = ref[seq.generated: seq.generated + g]
        prop[i, : len(nxt)] = nxt
    return prop if (prop >= 0).any() else None


def verify_anatomy(torch, dev, engine) -> None:
    """The served engine's speculative verify (B=8 at ~1k context, T=4:
    the last token and three proposals each, greedy) on its serving cache,
    eager and replayed (graph_anatomy); first, how far its forward's t=0
    rows (the same function as a decode step's) lie from the merged
    decode step's logits on the same cache: the bf16 sums differ in order
    and shape, and a random model's top-2 logits lie close."""
    from dynamo_tpu_torch.models import llama

    params, cfg = engine.params, engine.cfg.model
    k_cache, v_cache = engine.k_cache, engine.v_cache
    B, T = 8, SPEC_GAMMA + 1
    tables = torch.arange(1, 1 + B * 80, dtype=torch.int32, device=dev).reshape(B, 80)
    lens = torch.arange(1000, 1000 + B, dtype=torch.int32, device=dev)
    window = (torch.arange(B * T, dtype=torch.int32, device=dev) % 250 + 3).reshape(B, T)
    with torch.no_grad():
        dec = llama._decode_body(params, cfg, window[:, 0], lens - 1, tables, lens,
                                 k_cache, v_cache)[0]
        ver = llama._verify_forward(params, cfg, window, lens - 1, tables, lens,
                                    k_cache, v_cache, SPEC_GAMMA)[0][:, 0]
    top2 = dec.topk(2, dim=-1).values
    log(f"  verify t=0 rows vs the decode step (B=8, same cache): max |dlogit| "
        f"{float((ver - dec).abs().max()):.4f}, logit std "
        f"{float(dec.std()):.3f}, median top-1 - top-2 gap "
        f"{float((top2[:, 0] - top2[:, 1]).median()):.4f}, argmax equal in "
        f"{int((ver.argmax(-1) == dec.argmax(-1)).sum())} of {B} rows")
    graph_anatomy(torch, engine, f"verify (B=8, T={T}, ~1k context; 4 in a row)",
                  "verify")


def graph_batch(engine, rng, lens, *, sampled: bool = False,
                penalties: bool = False, first_page: int = 1):
    """A probe batch in the served engine's host state (no request behind
    it): slot b holds ``lens[b]`` tokens (0: a free slot, its table zero)
    on consecutive pages from ``first_page``, with room for a window;
    ``sampled``: seeded rows at temperatures 0.6-1.3 (slot 0 stays greedy),
    every other one with top-k 40, every third with top-p 0.9;
    ``penalties``: frequency, presence and repetition penalties on every
    other row over drawn output counts and prompt masks. Returns the
    steps (per-row generation counters) of the dispatch."""
    import numpy as np

    B, bs = engine.cfg.max_batch_size, engine.cfg.block_size
    V = engine.cfg.model.vocab_size
    engine._block_tables[:] = 0
    page = first_page
    for b, n in enumerate(lens):
        if n:
            need = -(-(n + 8) // bs)
            engine._block_tables[b, :need] = np.arange(page, page + need)
            page += need
    engine._seq_lens[:] = lens
    engine._last_tokens[:] = rng.randint(3, V, B)
    engine._seeds[:] = rng.randint(0, 2**31 - 1, B)
    engine._temps[:] = rng.uniform(0.6, 1.3, B) if sampled else 0.0
    engine._temps[0] = 0.0
    engine._top_ks[:] = [40 if sampled and b % 2 else 0 for b in range(B)]
    engine._top_ps[:] = [0.9 if sampled and b % 3 == 0 else 1.0 for b in range(B)]
    on = np.arange(B) % 2 == 0 if penalties else np.zeros(B, bool)
    engine._freq_pens[:] = np.where(on, 0.4, 0.0)
    engine._pres_pens[:] = np.where(on, 0.3, 0.0)
    engine._rep_pens[:] = np.where(on, 1.15, 1.0)
    if penalties:
        import torch

        engine._ensure_penalty_buffers()
        g = torch.Generator(device=engine.device).manual_seed(int(rng.randint(1 << 30)))
        hot = torch.rand(engine._pen_counts.shape, generator=g,
                         device=engine.device) < 0.002
        engine._pen_counts.copy_(hot * torch.randint(
            1, 4, hot.shape, generator=g, device=engine.device, dtype=torch.int32))
        engine._pen_mask.copy_(torch.rand(hot.shape, generator=g,
                                          device=engine.device) < 0.002)
    return rng.randint(0, 64, B).astype(np.int64)


def graph_anatomy(torch, engine, label: str, kind: str) -> None:
    """The served engine's 4-step decode window or 4 verifies (gamma 3)
    in a row, B=8 at ~1k context, greedy, each dispatch loading its static
    inputs (one copy) first: eager, then replayed from its CUDA graph
    (captured on the first call), in one run."""
    import numpy as np

    B = engine.cfg.max_batch_size
    rng = np.random.RandomState(9)
    steps = graph_batch(engine, rng, [1000 + b for b in range(B)])
    if kind == "decode":
        def programs():
            return [engine._decode_program(steps, 4, False, False)]
    else:
        props = rng.randint(3, 253, (B, SPEC_GAMMA)).astype(np.int32)
        window = np.concatenate([engine._last_tokens[:, None], props], 1)

        def programs():
            return [engine._verify_program(window, props, steps, False, False)
                    for _ in range(4)]
    anatomy(torch, f"{label}, eager", lambda: [p[2]() for p in programs()], 4)
    anatomy(torch, f"{label}, CUDA graph",
            lambda: [engine._run_program(*p) for p in programs()], 4)


def _tensors(out) -> list:
    """The tensors of a program's (nested) output tuple, in order."""
    if not isinstance(out, (tuple, list)):
        return [out]
    return [t for x in out for t in _tensors(x)]


def check_replay(torch, runner, key: tuple, program, holds: tuple) -> None:
    """Hold the replayed graph of ``key`` (``runner``: the engine's
    ``engine/graphs.py GraphRunner``) against the eager ``program`` on the
    same static inputs and the same state, bit for bit: every output, and
    every tensor of ``holds`` after the step. Raises AssertionError naming
    what differs, or when the dispatch did not replay. A key not yet
    captured is captured first, and that first dispatch's writes are
    undone; the state is left as the replay wrote it."""
    before = [t.clone() for t in holds]

    def restore():
        for t, b in zip(holds, before):
            t.copy_(b)

    if key not in runner.graphs:
        runner.run(key, program, holds)
        restore()
    held = {t.data_ptr() for t in holds}
    eager = [t.clone() for t in _tensors(program()) if t.data_ptr() not in held]
    eager_state = [t.clone() for t in holds]
    restore()
    replays = runner.replays
    replay = [t for t in _tensors(runner.run(key, program, holds))
              if t.data_ptr() not in held]
    if runner.replays != replays + 1:
        raise AssertionError(f"graph {key}: the dispatch did not replay")
    bad = [f"output {i}" for i, (a, b) in enumerate(zip(eager, replay))
           if not same_bytes(torch, a, b)]
    bad += [f"state {i}" for i, (a, b) in enumerate(zip(eager_state, holds))
            if not same_bytes(torch, a, b)]
    if bad or len(eager) != len(replay):
        raise AssertionError(f"graph {key}: the replay differs from the eager "
                             f"step in {bad or 'its output count'}")


def check_graphs(torch, engine, name: str, card: str) -> None:
    """Phase 3, on the served engine at full width: every key of the
    decode-window ladder (n = 4, 2, 1) and the gamma-3 verify (not over
    int8 pages, which the verify does not take), replayed from its CUDA
    graph, against the eager step on the same static inputs and state, bit
    for bit (``check_replay``: every output and the
    caches, scale planes and penalty counts after it). Three batches of 8
    slots at ~1-1.3k context with one free slot: greedy; seeded sampled
    rows with top-k / top-p, penalties and logprobs; then one slot freed
    and the free one refilled, every table moved to other pages, replayed
    by the graphs the second batch captured. A mismatch raises."""
    import numpy as np

    B = engine.cfg.max_batch_size
    rng = np.random.RandomState(11)
    lens = [1000 + 37 * b for b in range(B)]
    lens[B - 2] = 0
    refilled = list(lens)
    refilled[2], refilled[B - 2] = 0, 1290
    # the moved tables start at page 700, or lower where the pool ends
    # sooner (Gemma-3's 1024 pages), still past the first batches' pages
    bs = engine.cfg.block_size
    moved = min(700, engine.cfg.num_blocks
                - sum(-(-(n + 8) // bs) for n in refilled if n))
    if moved <= sum(-(-(n + 8) // bs) for n in lens if n):
        raise AssertionError(f"{name}: a pool of {engine.cfg.num_blocks} pages "
                             "is too small for the replay probes")
    cases = (("greedy", lens, False, 1),
             ("seeded sampled, top-k / top-p, penalties, logprobs", lens, True, 1),
             ("a slot freed, another refilled, tables moved", refilled, True,
              moved))
    t0, checked, replays = time.perf_counter(), 0, engine._graphs.replays
    for label, case_lens, rich, first in cases:
        steps = graph_batch(engine, rng, case_lens, sampled=rich, penalties=rich,
                            first_page=first)
        makers = [lambda n=n: engine._decode_program(steps, n, rich, rich)
                  for n in (4, 2, 1)]
        if engine.k_scales is None:
            props = rng.randint(3, 253, (B, SPEC_GAMMA)).astype(np.int32)
            props[1, 2] = -1
            window = np.concatenate([engine._last_tokens[:, None],
                                     np.maximum(props, 0)], 1).astype(np.int32)
            makers.append(lambda: engine._verify_program(window, props, steps,
                                                         rich, rich))
        for make in makers:
            _key, gkey, program, holds = make()
            check_replay(torch, engine._graphs, gkey, program, holds)
            checked += 1
    torch.cuda.synchronize()
    log(f"  CUDA graphs vs the eager step, bit for bit: {checked} replays "
        f"({engine._graphs.replays - replays} counted) over "
        f"{len(cases)} batches ({'; '.join(c[0] for c in cases)}), decode n = 4, "
        f"2, 1" + (" and the verify" if engine.k_scales is None else "")
        + f", in {time.perf_counter() - t0:.1f} s: equal  [{name}, {card}]")


# ---------------- phase 3, last drive: the distributed fleet ----------------

#: the fleet: ``dynamo_run hub``, two ``in=dyn://… out=torch`` workers of
#: Llama-3-8B (full width and depth, random weights from seed 0, each with
#: a 2048-page pool: 4 GiB of KV at 2 MiB a 16-token page) and a
#: ``--router kv`` frontend that sees no card
#: the tier drive: llama3-8b-sim at full width (a block is 2 MiB of bf16
#: K + V: 32 layers x 8 heads x 16 rows x 128 x 2 B x 2), a 512-page device
#: pool (1 GiB), a 256-block host tier (512 MiB) and a 512-block disk tier
#: (1 GiB) in a temporary directory the drive removes; four prompts of 3072
#: tokens (192 blocks each) per repetition
TIER_MODEL = "llama3-8b-sim"
TIER_PROMPT = 3072
TIER_POOL = 512
TIER_HOST = 256
TIER_DISK = 512
TIER_TOKENS = 8
#: each variant runs this many times, each on fresh prompts and a fresh
#: tiered engine: every TTFT is the median and range of its repetitions
TIER_REPS = 3
#: (label, the tiered engine's KV settings, whether its round-2 answers and
#: restored pages must equal the device-resident engine's bit for bit):
#: plain bf16 pages (gather + scatter), the int8 cache with the int8 tier
#: (gather with planes + the adopting scatter: no bounce, C.15's path), and
#: the two codec landings: an int8 tier under bf16 pages (the dequantizing
#: scatter) and an fp8 tier under the int8 cache (the requantizing one)
TIER_VARIANTS = (
    ("bf16", {}, True),
    ("int8 KV + int8 tier", {"kv_cache_dtype": "int8", "kv_quant": "int8"}, True),
    ("bf16 KV + int8 tier", {"kv_quant": "int8"}, False),
    ("int8 KV + fp8 tier", {"kv_cache_dtype": "int8", "kv_quant": "fp8"}, False),
)


def tier_config():
    from dynamo_tpu_torch.launch.dynamo_run import PRESETS

    return PRESETS[TIER_MODEL]()


def tier_snapshot(torch, engine, tokens) -> list:
    """A copy of the device pages (and int8 plane scales) of every full
    block of ``tokens``' chain, found by hash, as raw bytes."""
    from dynamo_tpu_torch.engine.allocator import sequence_block_hashes

    alloc = engine.allocator
    out = []
    for _l, h in sequence_block_hashes(tokens, engine.cfg.block_size):
        idx = alloc._by_hash.get(h, alloc._reuse.get(h))
        if idx is None:
            raise AssertionError("tier drive: a block of the chain is not on "
                                 "the device")
        page = [engine.k_cache[:, :, idx], engine.v_cache[:, :, idx]]
        if engine.k_scales is not None:
            page += [engine.k_scales[:, idx], engine.v_scales[:, idx]]
        out.append([t.contiguous().view(torch.uint8).clone() for t in page])
    return out


def tier_expected(torch, variant_kv: dict, snap: list, n: int) -> list:
    """What a lossy tier codec lands for the first ``n`` blocks of a
    snapshot, from the reference's arithmetic on the CPU: an int8 tier
    under bf16 pages lands dequantize(quantize(page)); an fp8 tier under
    the int8 cache lands the requantize of the fp8 encoding of the
    dequantized device codes."""
    from dynamo_tpu_torch.engine import kvquant
    from dynamo_tpu_torch.ops import block_copy as bc

    out = []
    for page in snap[:n]:
        if variant_kv.get("kv_cache_dtype") == "int8":
            k, v = (t.cpu().view(torch.int8) for t in page[:2])
            ks, vs = (t.cpu().view(torch.float32) for t in page[2:])
            fk, fv = kvquant.dequantize_entry(k, v, ks, vs, torch.bfloat16)
            qk, qv, qks, qvs = kvquant.quantize_entry(fk, fv, "fp8")
            kc, vc = (torch.zeros_like(x).unsqueeze(2) for x in (k, v))
            kp, vp = (torch.zeros((x.shape[0], 1)) for x in (k, v))
            bc.scatter_blocks_requant_plain(
                kc, vc, kp, vp, torch.zeros(1, dtype=torch.int32),
                qk.unsqueeze(2), qv.unsqueeze(2), qks[:, None], qvs[:, None])
            want = [kc[:, :, 0], vc[:, :, 0], kp[:, 0], vp[:, 0]]
        else:
            k, v = (t.cpu().view(torch.bfloat16) for t in page[:2])
            q = kvquant.quantize_entry(k, v, "int8")
            want = list(kvquant.dequantize_entry(*q, torch.bfloat16))
        out.append([t.contiguous().view(torch.uint8) for t in want])
    return out


def tier_anatomy(torch, engine) -> dict:
    """Time ``engine``'s steps between a prompt's arrival and its first
    token, by wrapping them on the instance (the engine's code is
    unchanged and no sync is added): the record gets the host ms of each
    step under ``ms`` (prejoin, admit, preamble, chunk, sample), CUDA
    event pairs around the two that launch work (preamble, chunk) under
    ``dev``, and under ``busy`` the (kind, start, end) host-clock
    intervals of the tier work that runs on other threads: the d2h
    landings, disk demotions and h2d uploads of the offload executor and
    the disk promotions of the prejoin."""
    rec = {"ms": {}, "dev": {}, "busy": []}
    cuda = engine.device.type == "cuda"

    def add(name, t0):
        rec["ms"][name] = rec["ms"].get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def step(name, fn, on_device=False):
        def run(*a, **kw):
            ev = None
            if on_device and cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                add(name, t0)
                if ev is not None:
                    ev[1].record()
                    rec["dev"].setdefault(name, []).append(ev)
        return run

    prejoin = engine._offload_prejoin

    async def prejoin_timed(hashes):
        t0 = time.perf_counter()
        try:
            await prejoin(hashes)
        finally:
            add("prejoin", t0)

    engine._offload_prejoin = prejoin_timed
    engine._begin_prefill = step("admit", engine._begin_prefill)
    engine._offload_preamble = step("preamble", engine._offload_preamble, True)
    engine._run_one_chunk = step("chunk", engine._run_one_chunk, True)
    engine._sample_prefill = step("sample", engine._sample_prefill)

    def busy(kind, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                rec["busy"].append((kind, t0, time.perf_counter()))
        return run

    off = engine.offload
    if off is not None:
        off._land_flush = busy("d2h landing", off._land_flush)
        off._disk_demote_worker = busy("disk demotion", off._disk_demote_worker)
        off._upload_worker = busy("h2d upload", off._upload_worker)
        off.promote_chain = busy("disk promotion", off.promote_chain)
    return rec


def tier_reading(torch, rec: dict, t0: float, t1: float) -> dict:
    """One request's anatomy from ``rec`` (filled since it was cleared,
    every event completed): host ms per step, ``<step> on device`` ms
    from the events, and ``<kind> overlap`` ms of the other threads' tier
    work inside [t0, t1] (arrival to first token, perf_counter)."""
    out = dict(rec["ms"])
    for name, evs in rec["dev"].items():
        out[name + " on device"] = sum(a.elapsed_time(b) for a, b in evs)
    for kind, a, b in rec["busy"]:
        key = kind + " overlap"
        out[key] = out.get(key, 0.0) + max(0.0, min(b, t1) - max(a, t0)) * 1e3
    return out


async def tier_drive(torch, dev, card: str) -> dict:
    """The host and disk KV tiers through TorchEngine.generate at full
    width, in each of TIER_VARIANTS, TIER_REPS times on fresh prompts and a
    fresh engine. Round 1 serves the four prompts one at a time; a filler
    prompt sized from the allocator's state then takes the device pages no
    round-2 prompt owns, so each round-2 prompt's chain lies whole in one
    place: prompt 0 restores from disk (promoted through the host) and
    host, prompt 3 hits the device, prompt 2 restores from the host. Each
    round-2 answer is held to an engine on the same weights whose pool
    kept every prefix on the device (bit for bit where the tier is
    lossless), restored pages to a snapshot taken before eviction (or to
    the codec's arithmetic), and the tier counters to the path. Prints the
    TTFTs (cold, the device-resident engine's plain prefix hit, and the
    tiered engine's device, host and disk hits) as median and range over
    the repetitions, each hit's anatomy (tier_anatomy: the steps' host and
    device ms, the tier work overlapping it, a restore's pin / stack / h2d
    ms), restore_latency_hidden_frac and the cost model's host and disk
    link rates; returns the launches of each kernel counted during the
    tiered runs."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.engine.allocator import sequence_block_hashes
    from dynamo_tpu_torch.models.weights import init_random_params
    from dynamo_tpu_torch.ops import _cuda
    from dynamo_tpu_torch.ops import block_copy as bc
    from dynamo_tpu_torch.ops.kv_cache_update import (
        kv_cache_append,
        kv_cache_append_quantized,
    )
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_prefill_attention,
    )
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime import Context

    cfg = tier_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_random_params(cfg, gen, dev)
    cpu = torch.Generator().manual_seed(100)
    prompts = [[torch.randint(0, cfg.vocab_size, (TIER_PROMPT,),
                              generator=cpu).tolist() for _ in range(4)]
               for _ in range(TIER_REPS)]
    geometry = dict(block_size=16, max_batch_size=8, max_context=cfg.max_position_embeddings)
    order = ((0, "disk"), (3, "device"), (2, "host"))

    async def ask(engine, toks):
        """Greedy answer, TTFT ms (the first token's arrival: the engine
        read it back from the card), and the arrival and first-token
        times."""
        req = PreprocessedRequest(
            token_ids=list(toks),
            stop_conditions=StopConditions(max_tokens=TIER_TOKENS, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0), eos_token_ids=[])
        t0, t1, out = time.perf_counter(), None, []
        async for o in engine.generate(Context(req)):
            if o.token_ids and t1 is None:
                t1 = time.perf_counter()
            out.extend(o.token_ids)
        return out, (t1 - t0) * 1e3, t0, t1

    async def settle(engine):
        """Every task the offload executor was given has run, and every one
        those queued in turn (a landing queues the disk demotions of the
        host pool's overflow): its two workers meet at a barrier only once
        both are free, again until nothing is queued behind it."""
        off = engine.offload
        while off._exec is not None:
            barrier = threading.Barrier(2)
            futs = [off._exec.submit(barrier.wait, 120) for _ in range(2)]
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: [f.result() for f in futs])
            if off._exec._work_queue.empty():
                break
        off._reap_flushes_locked()

    def read(rec, t0, t1):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return tier_reading(torch, rec, t0, t1)

    twins = {}

    async def twin(kv: dict) -> tuple:
        """Per repetition, the round-2 answers of the device-resident
        engine (a pool holding every prompt of the repetition), and the
        TTFTs and anatomies of those plain prefix hits."""
        key = kv.get("kv_cache_dtype", "model")
        if key not in twins:
            eng = TorchEngine(EngineConfig(
                model=cfg, num_blocks=4 * TIER_POOL, kv_cache_dtype=key,
                **geometry), params=params, device=dev)
            rec = tier_anatomy(torch, eng)
            answers, hits = [], []
            for rep in prompts:
                for p in rep:
                    await ask(eng, p)
                row = []
                for i, _name in order:
                    for v in rec.values():
                        v.clear()
                    toks, ms, t0, t1 = await ask(eng, rep[i])
                    row.append(toks)
                    hits.append((ms, read(rec, t0, t1)))
                answers.append(row)
            twins[key] = (answers, hits)
            await eng.close()
            del eng
            gc.collect()
            torch.cuda.empty_cache() if dev.type == "cuda" else None
        return twins[key]

    def span(xs) -> str:
        return (f"{statistics.median(xs):.1f} [{min(xs):.1f}-{max(xs):.1f}]"
                if xs else "-")

    def anatomy(readings) -> str:
        """Median over the repetitions of each part of a hit."""
        keys = [k for k in ("prejoin", "admit", "preamble", "preamble on device",
                            "chunk", "chunk on device", "sample",
                            "d2h landing overlap", "disk demotion overlap",
                            "disk promotion overlap", "h2d upload overlap",
                            "pin_ms", "stack_ms", "h2d_ms")
                if any(k in r for r in readings)]
        return ", ".join(
            f"{k} {statistics.median(r.get(k, 0.0) for r in readings):.1f}"
            for k in keys)

    launches: dict = {}
    for label, kv, exact in TIER_VARIANTS:
        want, plain = await twin(kv)
        for f, names in _cuda.COUNTED:
            for n in names:
                setattr(f, n, 0)
        t_drive = time.perf_counter()
        ttft = {k: [] for k in ("cold", "device", "host", "disk")}
        anat = {k: [] for k in ("device", "host", "disk")}
        agree, links, hidden = 0, [], []
        adopted = None
        for r, rep in enumerate(prompts):
            tmp = tempfile.mkdtemp(prefix="chip_smoke_tiers_")
            try:
                eng = TorchEngine(EngineConfig(
                    model=cfg, num_blocks=TIER_POOL, host_cache_blocks=TIER_HOST,
                    disk_cache_blocks=TIER_DISK, disk_cache_path=tmp, **geometry,
                    **kv), params=params, device=dev)
                rec = tier_anatomy(torch, eng)
                snaps = {}
                for i, p in enumerate(rep):
                    _, ms, _t0, _t1 = await ask(eng, p)
                    if i == 1:  # prompt 0 of the first repetition paid first launches
                        ttft["cold"].append(ms)
                    if i in (0, 2):
                        snaps[i] = tier_snapshot(torch, eng, p)
                await settle(eng)
                alloc = eng.allocator
                keep = {h for i in (2, 3)
                        for _l, h in sequence_block_hashes(rep[i], 16)}
                others = sum(1 for h in alloc._reuse if h not in keep)
                fill = others + len(alloc._free) - 2
                if fill > 0:
                    await ask(eng, torch.randint(0, cfg.vocab_size, (fill * 16,),
                                                 generator=cpu).tolist())
                got, where = [], {}
                for i, name in order:
                    # the previous request's evictions landed (and demoted):
                    # no request waits on the last one's executor work
                    await settle(eng)
                    m0 = eng.load_metrics()
                    u0 = dict(eng.offload.upload_times)
                    for v in rec.values():
                        v.clear()
                    toks, ms, t0, t1 = await ask(eng, rep[i])
                    await settle(eng)
                    reading = read(rec, t0, t1)
                    m1 = eng.load_metrics()
                    u1 = eng.offload.upload_times
                    if u1["uploads"] > u0["uploads"]:
                        reading.update({k: u1[k] - u0[k] for k in
                                        ("pin_ms", "stack_ms", "h2d_ms")})
                    got.append(toks)
                    ttft[name].append(ms)
                    anat[name].append(reading)
                    where[i] = {k: m1[k] - m0[k] for k in (
                        "offload_hit_blocks_total", "disk_hit_blocks_total")}
                    if i in snaps:
                        page = tier_snapshot(torch, eng, rep[i])[:-1]
                        ref = snaps[i][:-1]
                        if exact:
                            same = all(torch.equal(a, b) for pa, pb in zip(page, ref)
                                       for a, b in zip(pa, pb))
                        else:
                            exp = tier_expected(torch, kv, ref, 8)
                            same = all(torch.equal(a.cpu(), b) for pa, pb in
                                       zip(page[:8], exp) for a, b in zip(pa, pb))
                        if not same:
                            raise AssertionError(
                                f"tier drive {label}: prompt {i}'s restored pages "
                                "differ from " + ("its snapshot before eviction"
                                                  if exact else "the codec's "
                                                  "arithmetic"))
                m = eng.load_metrics()
                if kv.get("kv_cache_dtype") == "int8" and kv.get("kv_quant") == "int8":
                    adopted = bc.scatter_blocks.adopt_launches
                    if m["kv_device_export_requant_total"] != 0:
                        raise AssertionError("tier drive: the int8 tier bounced "
                                             "blocks off the device codec")
                # an int8 tier under bf16 pages holds twice the blocks in the
                # host's bytes: its prompts need not reach the disk
                for key in (("disk_hit_blocks_total", "offload_hit_blocks_total",
                             "disk_demotions_total") if exact
                            else ("offload_hit_blocks_total",)):
                    if m[key] <= 0:
                        raise AssertionError(f"tier drive {label}: {key} = {m[key]}")
                if where[3]["offload_hit_blocks_total"] != 0:
                    raise AssertionError(f"tier drive {label}: prompt 3 restored "
                                         "from a tier instead of the device")
                full = TIER_PROMPT // 16 - 1
                if (where[2]["offload_hit_blocks_total"] != full
                        or where[0]["offload_hit_blocks_total"] != full):
                    raise AssertionError(f"tier drive {label}: not whole restores "
                                         f"({where})")
                same = sum(a == b for a, b in zip(got, want[r]))
                if exact and same != len(got):
                    raise AssertionError(
                        f"tier drive {label}: round-2 answers differ from the "
                        f"device-resident engine's: {got} vs {want[r]}")
                if not all(len(a) == TIER_TOKENS for a in got):
                    raise AssertionError(f"tier drive {label}: short answers {got}")
                if eng._chunk_events or m["kv_prefill_tok_s"] <= 0:
                    raise AssertionError(
                        f"tier drive {label}: the dedicated chunks' timings were "
                        f"not all folded ({len(eng._chunk_events)} left, "
                        f"kv_prefill_tok_s {m['kv_prefill_tok_s']})")
                agree += same
                links.append(m["kv_link_gbps"])
                hidden.append(m["restore_latency_hidden_frac"])
                log(f"  tier drive ({label}), repetition {r}: TTFT cold "
                    f"{ttft['cold'][-1]:.1f} ms, device {ttft['device'][-1]:.1f}, "
                    f"host {ttft['host'][-1]:.1f}, disk {ttft['disk'][-1]:.1f} "
                    f"({where[0]['disk_hit_blocks_total']} of prompt 0's {full} "
                    f"blocks from disk); restore_latency_hidden_frac "
                    f"{m['restore_latency_hidden_frac']}, kv_link_gbps "
                    f"{m['kv_link_gbps']}, d2h flushes {m['d2h_flush_async']}, "
                    f"h2d uploads {m['h2d_uploads_started']}, disk demotions "
                    f"{m['disk_demotions_total']}, disk hits "
                    f"{m['disk_hit_blocks_total']}, host hits "
                    f"{m['offload_hit_blocks_total']}, export requants "
                    f"{m['kv_device_export_requant_total']}, kv_prefill_tok_s "
                    f"{m['kv_prefill_tok_s']}")
                await eng.close()
                del eng, rec
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        drive_s = time.perf_counter() - t_drive
        counts = {
            # the int8 cache gathers with its planes
            "gather_blocks": (bc.gather_blocks.plane_launches
                              if kv.get("kv_cache_dtype") == "int8"
                              else bc.gather_blocks.launches),
            "scatter_blocks": bc.scatter_blocks.launches,
            "scatter_blocks_dequant": bc.scatter_blocks_dequant.launches,
            "scatter_blocks_requant": bc.scatter_blocks_requant.launches,
        }
        suffix = INT8_KV if kv.get("kv_cache_dtype") == "int8" else ""
        counts["paged_prefill_attention" + suffix] = paged_prefill_attention.launches
        counts["paged_decode_attention" + suffix] = paged_decode_attention.launches
        append = (kv_cache_append_quantized if suffix else kv_cache_append)
        counts["kv_cache_append_quantized" if suffix else "kv_cache_append"] = (
            append.launches)
        path = {"bf16": ("gather_blocks", "scatter_blocks"),
                "int8 KV + int8 tier": ("gather_blocks", "scatter_blocks"),
                "bf16 KV + int8 tier": ("gather_blocks",
                                        "scatter_blocks_dequant"),
                "int8 KV + fp8 tier": ("gather_blocks",
                                       "scatter_blocks_requant")}[label]
        idle = [k for k, n in counts.items()
                if n == 0 and (k in path or not k.startswith(("gather", "scatter")))]
        if dev.type == "cuda":  # the CPU runs the plain twins
            if idle:
                raise AssertionError(f"tier drive {label}: no launch of {idle}")
            if adopted == 0:
                raise AssertionError("tier drive: the int8 restores did not adopt")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        n_ans = TIER_REPS * len(order)
        log(f"  tier drive ({label}), {TIER_REPS} repetitions, TTFT ms median "
            f"[range]: cold {span(ttft['cold'])}, plain prefix hit (the "
            f"device-resident engine, no tiers) {span([ms for ms, _ in plain])}, "
            f"device {span(ttft['device'])}, host {span(ttft['host'])}, disk "
            f"{span(ttft['disk'])}; restore_latency_hidden_frac "
            f"{span(hidden)}; kv_link_gbps host "
            f"{span([x['host'] for x in links if 'host' in x])}, disk "
            f"{span([x['disk'] for x in links if 'disk' in x])}; round-2 answers "
            f"equal to the device-resident engine's: {agree} of {n_ans}"
            f"{' (required)' if exact else ' (lossy codec)'}; launches "
            + ", ".join(f"{k} {n}" for k, n in counts.items())
            + f"; {drive_s:.1f} s")
        log(f"    anatomy, ms, medians (host ms; 'on device': CUDA events; "
            f"'overlap': tier work on other threads between arrival and "
            f"first token): plain prefix hit: {anatomy([a for _, a in plain])}")
        for name in ("device", "host", "disk"):
            log(f"    {name} hit: {anatomy(anat[name])}")
    del params
    gc.collect()
    return launches


FLEET_MODEL = "llama3-8b-sim"
FLEET_DEVICE = "cuda"
FLEET_TARGET = "dyn://dynamo.backend.generate"
FLEET_BLOCKS = 2048
FLEET_TOKENS = 32
#: the bytes (byte-tokenizer tokens) of each of the four shared prefixes
FLEET_PREFIX = 1024
#: the primary lease's TTL (``DistributedRuntime.PRIMARY_LEASE_TTL``): a
#: killed worker leaves discovery within it; the heal has 5 s more
LEASE_TTL_S = 10.0
#: each fleet worker's host tier (blocks): it starts the worker's
#: prefetch-hint listener and peer server, the fleet pull's two ends
FLEET_HOST_BLOCKS = 512
#: migration and drain: a long greedy stream (a) cut by a SIGKILL of its
#: worker and (b) cut by a SIGTERM, whose drain hands it off at the
#: workers' ``--drain-deadline``; each is cut once MIGRATE_CUT text events
#: reached the client, and must finish on the other worker
FLEET_DRAIN_S = 2.0
MIGRATE_TOKENS = (192, 512)
MIGRATE_CUT = 32
MIGRATE_PROMPT = 600  # bytes of each long stream's prompt
#: a SIGTERM-drained process exits within the deadline plus this margin
#: (the response plane's flush, the lease's revocation, the teardown)
DRAIN_MARGIN_S = 20.0


def migrate_prompts() -> list:
    """The two long streams' prompts: fresh prefixes (no worker holds them)."""
    return [(f"Migration {i}: a stream that outlives its worker. " * 40)
            [:MIGRATE_PROMPT] + " Continue the story of the paged cache:"
            for i in ("a", "b")]


def pull_prompts(prefix: str) -> tuple:
    """(cold, pulled, seed, at_once): prompts of equal length with one
    suffix, the first over a prefix no worker holds, the second over
    ``prefix``; the last over a second prefix that ``seed`` puts on the
    holder alone."""
    suffix = " Pull question: " + "what did the peer hold? " * 4
    fresh = ("A prefix nobody served, on the transfer plane. " * 40)[:len(prefix)]
    second = ("A prefix the holder alone served, sent on at once. " * 40)[:len(prefix)]
    return (fresh + suffix, prefix + suffix,
            second + " Seed question: " + "what does the holder keep? " * 4,
            second + suffix)


def fleet_prompts() -> list:
    """Seven prompts over four long prefixes (``FLEET_PREFIX`` bytes each,
    64 pages of the byte tokenizer's tokens), each with its own suffix of
    several pages: prompts 4-6 share the prefixes of prompts 0-2."""
    topics = ("the paged cache", "the radix index", "the lease keeper",
              "the response plane")
    prefixes = [(f"Prefix {i} on {t}. " + f"Every worker of the fleet reads "
                 f"{t} the same way, block by block. " * 40)[:FLEET_PREFIX]
                for i, t in enumerate(topics)]
    return [prefixes[i] + f" Question {j}: " + f"what does request {j} ask? " * 4
            for j, i in enumerate((0, 1, 2, 3, 0, 1, 2))]


class FleetProc:
    """One ``dynamo_run`` role as a child process; a thread keeps its
    merged output."""

    def __init__(self, label: str, args: list, env=None):
        self.label = label
        self.lines: list = []
        self.p = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.launch.dynamo_run", *args],
            cwd=Path(__file__).resolve().parent, env=env or dict(os.environ),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.p.stdout:
            self.lines.append(line.rstrip())

    def tail(self, n: int = 15) -> str:
        return "\n".join(f"    [{self.label}] {x}" for x in self.lines[-n:])

    async def wait_for(self, needle: str, timeout: float) -> str:
        t_end = time.perf_counter() + timeout
        while time.perf_counter() < t_end:
            for line in self.lines:
                if needle in line:
                    return line
            if self.p.poll() is not None:
                break
            await asyncio.sleep(0.1)
        raise AssertionError(f"{self.label}: no {needle!r} (exit "
                             f"{self.p.poll()}):\n{self.tail()}")

    def stop(self) -> None:
        if self.p.poll() is None:
            self.p.kill()
        self.p.wait(timeout=30)


def compute_apps() -> list:
    """The pids nvidia-smi lists with a CUDA context on the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.split()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def fleet_pull(torch, card: str, comp, router, scrape, served, prompts,
                     body, pinned_service, token_ids) -> dict:
    """The fleet prefix cache's pull between the two workers: A holds
    prompt 0's prefix, B neither it nor a fresh one. B first serves a
    prompt over the fresh prefix, pinned (its cold TTFT); then this
    process's router, told A is loaded, routes a prompt of the same
    length over A's prefix to B and hints B with A as the deeper peer
    (``KvRouter.schedule`` -> ``emit_prefetch``). B's listener pulls the
    chain from A's KvPeerServer (the device pages: one gather launch on
    A), lands it and prefetches it onto the device; the request, pinned to
    B, claims it (the pulled TTFT). Last, as a frontend would: A serves a
    second prefix, and the prompt over it goes to B at once after the
    router's hint, racing its own pull (the at-once TTFT, with the prefix
    tokens it hit and whether its pull landed before it). Returns the
    prompts B served, their answers and the last scrape."""
    from dynamo_tpu_torch.engine.allocator import sequence_block_hashes
    from dynamo_tpu_torch.kv_router import ProcessedEndpoints, WorkerLoad
    from dynamo_tpu_torch.llm import ByteTokenizer
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import CompletionRequest

    holder = served[0][0]
    cold_p, pull_p, seed_p, now_p = pull_prompts(prompts[0][:FLEET_PREFIX])
    pre = OpenAIPreprocessor(ByteTokenizer())

    def ids(p):
        return pre.preprocess_completion(
            CompletionRequest.from_dict(body(p)))[0].token_ids

    pull_ids, now_ids = ids(pull_p), ids(now_p)
    before = await scrape()
    other = next(w for w in before if w != holder)

    async def schedule_on_other(prompt_ids):
        # the router sees A loaded and B idle: B wins; A's chain is deeper
        router.metrics.endpoints = ProcessedEndpoints([
            WorkerLoad(worker_id=holder, kv_active_blocks=95, kv_total_blocks=100,
                       active_requests=7, total_slots=8),
            WorkerLoad(worker_id=other, kv_active_blocks=5, kv_total_blocks=100,
                       active_requests=0, total_slots=8)])
        wid, overlap = await router.schedule(prompt_ids)
        router.request_finished(wid)
        if wid != other:
            raise AssertionError(f"fleet pull: the router chose {wid:x}, not {other:x}")
        return overlap

    pinned = await pinned_service(other)
    try:
        cold = await http_request(pinned.port, "/v1/completions", body(cold_p))
        t_hint = time.perf_counter()
        overlap = await schedule_on_other(pull_ids)
        landed = None
        while time.perf_counter() - t_hint < 30:
            cur = await scrape()
            if cur[other]["h2d_prefetch_blocks_total"] > before[other][
                    "h2d_prefetch_blocks_total"]:
                landed = time.perf_counter() - t_hint
                break
            await asyncio.sleep(0.05)
        if landed is None:
            raise AssertionError(f"fleet pull: nothing landed on {other:x}: "
                                 f"{ {k: v for k, v in cur[other].items() if 'peer' in k} }")
        pulled = await http_request(pinned.port, "/v1/completions", body(pull_p))
        after = await scrape()
        seeder = await pinned_service(holder)
        try:
            seed = await http_request(seeder.port, "/v1/completions", body(seed_p))
        finally:
            await seeder.close()
        b_now = (await scrape())[other]
        await schedule_on_other(now_ids)
        now = await http_request(pinned.port, "/v1/completions", body(now_p))
        b_served = (await scrape())[other]
        # a pull still in flight lands within the waited pull's time; give
        # it 5 s before the last scrape (none may come: B holds the prefix)
        t_sent = time.perf_counter()
        last = await scrape()
        while (time.perf_counter() - t_sent < 5 and last[other][
                "peer_pull_blocks_total"] == b_now["peer_pull_blocks_total"]):
            await asyncio.sleep(0.05)
            last = await scrape()
    finally:
        await pinned.close()
    for status, text, _t in (cold, pulled, seed, now):
        if status != 200 or not text:
            raise AssertionError(f"fleet pull: status {status}, text {text!r}")
    a0, a1, b0, b1 = before[holder], after[holder], before[other], after[other]

    def launches(d, name):
        return d["kernel_launches"][name]["launches"]

    keys = ("peer_pull_blocks_total", "peer_pull_blocks_claimed",
            "h2d_prefetch_blocks_total", "h2d_prefetch_hits")
    got = {k: b1[k] - b0[k] for k in keys}
    served_blocks = a1["peer_serve_d2h_blocks_total"] - a0["peer_serve_d2h_blocks_total"]
    gathers = launches(a1, "gather_blocks") - launches(a0, "gather_blocks")
    scatters = launches(b1, "scatter_blocks") - launches(b0, "scatter_blocks")
    hits = b1["prefix_cache_hits_tokens"] - b0["prefix_cache_hits_tokens"]
    log(f"  fleet pull: the router chose {other:x} (overlap {overlap}) and hinted "
        f"peer {holder:x}; {served_blocks} device blocks served by {holder:x} "
        f"({gathers} gather_blocks launches there), on {other:x}: "
        + ", ".join(f"{k} +{v}" for k, v in got.items())
        + f" ({scatters} scatter_blocks launches), the request hit {hits} "
        f"cached tokens; landed {landed * 1e3:.1f} ms after the hint")
    log(f"  fleet pull: TTFT {pulled[2][0] * 1e3:.1f} ms with the pulled prefix, "
        f"{cold[2][0] * 1e3:.1f} ms cold on the same worker (a prompt of the same "
        f"{len(pull_ids)} tokens over a prefix no worker held)  [{FLEET_MODEL}, {card}]")
    b_end = last[other]

    def grew(d, key):
        return d[key] - b_now[key]

    log(f"  fleet pull, the prompt sent at once after the hint (as a frontend "
        f"sends it): TTFT {now[2][0] * 1e3:.1f} ms, the request hit "
        f"{grew(b_served, 'prefix_cache_hits_tokens')} cached tokens "
        f"(h2d_prefetch_hits +{grew(b_served, 'h2d_prefetch_hits')}, "
        f"peer_pull_blocks_claimed +{grew(b_served, 'peer_pull_blocks_claimed')}); "
        f"its pull, 5 s on: peer_pull_blocks_total "
        f"+{grew(b_end, 'peer_pull_blocks_total')}, h2d_prefetch_blocks_total "
        f"+{grew(b_end, 'h2d_prefetch_blocks_total')}  [{FLEET_MODEL}, {card}]")
    # the CPU (a rehearsal) runs the plain twins: nothing launches
    launched = FLEET_DEVICE != "cuda" or min(gathers, scatters) > 0
    if (min(got.values()) <= 0 or not launched or served_blocks <= 0
            or hits < FLEET_PREFIX // 16 * 16):
        raise AssertionError(f"fleet pull: peer keys {got}, served {served_blocks}, "
                             f"gathers {gathers}, scatters {scatters}, hits {hits}")
    return {"prompts": (cold_p, pull_p, now_p), "answers": (cold, pulled, now),
            "scrape": last}


async def fleet_drive(torch, dev, card: str) -> dict:
    """The distributed role on the card: the hub, two Llama-3-8B workers
    (each built and warmed before it takes its lease) and a card-less
    KV-routed frontend, all ``dynamo_run`` processes; this process watches
    through the port's own runtime (a client, a ``KvRouter`` fed by the
    same events) and reads each worker's stats endpoint. Round 1 sends the
    seven prompts one at a time (each request's worker, prompt tokens and
    prefix hits from the scrapes around it): the router places a lone cold
    prompt by its cost model, which may pick one worker for all, so
    prompts 1 and 3 go through this process's own pipeline pinned to the
    worker that did not take prompt 0 (``Client.direct``, as the router
    sends); prompts 4-6, through the frontend, must each go to the worker
    holding its prefix and hit it there. Round 2 sends all seven at once:
    every request must go back to the worker that served it (each worker's
    requests and prefix hits exactly those of its round-1 prompts' whole
    cached prompts). The frontend must add no CUDA context to the card
    (nvidia-smi's count before it starts and after both rounds). Then
    SIGKILL on the worker that holds
    the most: within the lease TTL + 5 s the frontend serves again, the
    dead worker is out of discovery and the router's index, and seven
    more requests all land on the survivor, which then takes SIGTERM (its
    lease revoked, exit 0). Last, a single-process engine built as the
    workers are serves round 1's prompts one at a time: its greedy
    answers must equal the fleet's. Returns the four kernels' launches in
    the workers during the drive (their counters read just before round 1
    and after each worker's last request)."""
    from dynamo_tpu_torch.engine.allocator import sequence_block_hashes
    from dynamo_tpu_torch.http import HttpService, ModelManager
    from dynamo_tpu_torch.kv_router import KvRouter
    from dynamo_tpu_torch.launch.dynamo_run import build_engine, parse_args
    from dynamo_tpu_torch.llm import ByteTokenizer
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import CompletionRequest
    from dynamo_tpu_torch.runtime import (
        AsyncEngine,
        DistributedRuntime,
        EndpointInfo,
        NoResponders,
        link,
    )
    from dynamo_tpu_torch.runtime.hub import connect_hub

    prompts, long_prompts = fleet_prompts(), migrate_prompts()
    seams: dict = {}  # the migrated streams' widest gap between text events

    def body(prompt: str, n: int = FLEET_TOKENS) -> dict:
        return {"model": FLEET_MODEL, "prompt": prompt, "max_tokens": n,
                "temperature": 0.0, "stream": True, "nvext": {"ignore_eos": True}}

    async def frontend_migrations(port: int) -> dict:
        """The frontend's MigratingEngine counters, from its /metrics."""
        text = await http_get(port, "/metrics")
        got = {}
        for key in ("migrations_total", "requests_migrated", "migration_failures"):
            m = re.search(rf"^dynamo_tpu_torch_{key} (\d+)$", text, re.M)
            if m is None:
                raise AssertionError(f"fleet: the frontend's /metrics lacks {key}")
            got[key] = int(m[1])
        return got

    async def streaming_worker(scrape, progress: list, task) -> int:
        """The worker whose slot holds the long stream, once MIGRATE_CUT text
        events of it reached the client."""
        t_s = time.perf_counter()
        while len(progress) < MIGRATE_CUT:
            if task.done() or time.perf_counter() - t_s > 120:
                raise AssertionError(f"fleet: the long stream ended or stalled "
                                     f"after {len(progress)} events")
            await asyncio.sleep(0.01)
        busy = [w for w, d in (await scrape()).items() if d["request_active_slots"]]
        if len(busy) != 1 or task.done():
            raise AssertionError(f"fleet: the long stream's worker: {busy}")
        return busy[0]

    def migrated_stream(label, result, cut_at, t_cut, lines_at, pre, post, taker,
                        mig0, mig1):
        """The cut stream finished on ``taker``: status 200, every token, the
        taker's migration_resumes and the frontend's migrations up by one.
        Returns the seam from the frontend's log (``lines_at``: its lines
        before the cut): the tokens the client had when the last
        re-dispatch left, and that re-dispatch's wall-clock delay after
        the cut (``t_cut``, ``time.time()``)."""
        status, text, times = result
        gaps = [b - a for a, b in zip(times, times[1:])]
        redispatch = [m for m in (re.search(r"re-dispatching with (\d+) tokens so "
                                            r"far", x) for x in front.lines[lines_at:])
                      if m is not None]
        if not redispatch:
            raise AssertionError(f"fleet {label}: the frontend logged no re-dispatch"
                                 f":\n{front.tail()}")
        line = redispatch[-1].string
        at = datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()
        # the taker's prefill of the resumed request (prompt + tokens so far):
        # the only prefill it ran between the two scrapes
        prefill_ms = (post[taker]["hist_prefill_ms"]["s"]
                      - pre[taker]["hist_prefill_ms"]["s"])
        seam = {"tokens": int(redispatch[-1][1]), "redispatch_ms": (at - t_cut) * 1e3,
                "prefill_ms": prefill_ms, "times": times}
        resumed = post[taker]["migration_resumes"] - pre[taker]["migration_resumes"]
        if (status != 200 or not text or len(times) <= cut_at or resumed != 1
                or mig1["migrations_total"] - mig0["migrations_total"] < 1
                or mig1["requests_migrated"] - mig0["requests_migrated"] != 1
                or mig1["migration_failures"] != mig0["migration_failures"]):
            raise AssertionError(
                f"fleet {label}: status {status}, {len(times)} text events "
                f"({cut_at} before the cut), the taker's migration_resumes +"
                f"{resumed}, the frontend's {mig0} -> {mig1}")
        log(f"  {label} with a {len(times)}-event stream in flight ({cut_at} "
            f"events before the cut): finished on worker {taker:x} "
            f"(migration_resumes +{resumed}; frontend migrations_total "
            f"{mig0['migrations_total']} -> {mig1['migrations_total']}, "
            f"requests_migrated {mig1['requests_migrated']}); re-dispatched "
            f"with {seam['tokens']} tokens so far {seam['redispatch_ms']:.1f} ms "
            f"after the cut ({len(redispatch)} re-dispatches), the taker's prefill "
            f"of it {prefill_ms:.1f} ms, median gap "
            f"{statistics.median(gaps) * 1e3:.2f} ms  [{FLEET_MODEL}, {card}]")
        return seam

    async def direct_stats(subject: str):
        """An instance's stats through its own subject (answered while its
        ingress lives, out of discovery or not); None once it stopped."""
        try:
            raw = await drt.bus.request(subject + ".stats", b"{}", timeout=5)
        except (NoResponders, asyncio.TimeoutError):
            return None
        return json.loads(raw) if raw else None

    pre = OpenAIPreprocessor(ByteTokenizer())
    token_ids = [pre.preprocess_completion(CompletionRequest.from_dict(body(p)))[0]
                 .token_ids for p in prompts]
    hub_port, http_port = free_port(), free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    procs: list = []
    drt = conn = None
    t0 = time.perf_counter()
    try:
        hub = FleetProc("hub", ["hub", "--host", "127.0.0.1", "--hub-port",
                                str(hub_port)])
        procs.append(hub)
        await hub.wait_for("hub listening", 60)
        common = ["--hub", hub_addr, "--model-path", FLEET_MODEL, "--host", "127.0.0.1"]
        worker_args = [f"in={FLEET_TARGET}", "out=torch", "--num-blocks",
                       str(FLEET_BLOCKS), "--host-cache-blocks",
                       str(FLEET_HOST_BLOCKS), "--device", FLEET_DEVICE,
                       "--drain-deadline", str(FLEET_DRAIN_S), "--warmup"] + common
        workers = [FleetProc(f"worker {i}", worker_args) for i in range(2)]
        procs += workers
        pid_of = {}
        for w in workers:
            line = await w.wait_for("at dyn://", 600)
            pid_of[int(re.search(r"worker ([0-9a-f]+) serving", line)[1], 16)] = w
            warm = next((x for x in w.lines if x.startswith("warmup:")), "")
            log(f"  {w.label} (pid {w.p.pid}): {line.strip()}; {warm}")
        log(f"  two workers built, warmed and serving {time.perf_counter() - t0:.1f} s "
            "after the hub started")
        apps_before = compute_apps()
        front = FleetProc("frontend", ["in=http", f"out={FLEET_TARGET}", "--router",
                                       "kv", "--http-port", str(http_port)] + common,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        procs.append(front)
        await front.wait_for("OpenAI server", 120)

        store, bus, conn = await asyncio.wait_for(connect_hub(hub_addr), 30)
        drt = await DistributedRuntime.from_settings(store=store, bus=bus)
        ns, comp_name, ep = FLEET_TARGET.removeprefix("dyn://").split(".")
        comp = drt.namespace(ns).component(comp_name)
        client = await comp.endpoint(ep).client().start()
        router = await KvRouter(drt, comp, block_size=16).start()
        if sorted(await client.wait_for_instances(30)) != sorted(pid_of):
            raise AssertionError(f"fleet: discovery {client.instance_ids()} "
                                 f"against workers {sorted(pid_of)}")

        async def scrape() -> dict:
            got = {s["instance_id"]: s["data"]
                   for s in await comp.scrape_stats(timeout=10)}
            if any(not d for d in got.values()):
                raise AssertionError(f"fleet: an empty scrape: {got}")
            return got

        def stream_stats(results, label):
            for i, (status, text, _t) in enumerate(results):
                if status != 200 or not text:
                    raise AssertionError(f"fleet {label} request {i}: status "
                                         f"{status}, text {text!r}")
            ttft = [t[0] * 1e3 for _s, _x, t in results]
            itl = [(t[-1] - t[0]) * 1e3 / (len(t) - 1) for _s, _x, t in results
                   if len(t) > 1]
            return ttft, itl

        def delta(a: dict, b: dict, key: str) -> int:
            return b[key] - a[key]

        # this process's own frontend pipeline with the choice taken away:
        # each request goes to one worker, sent as KvRoutedEngine sends it
        class Pinned(AsyncEngine):
            def __init__(self, worker_id: int):
                self.worker_id = worker_id

            async def generate(self, request):
                stream = await client.direct(
                    request.transfer(request.data.to_dict()), self.worker_id)
                async for item in stream:
                    yield item

        async def alone(port: int, j: int) -> tuple:
            """Prompt j by itself through the HTTP service at ``port``: its
            worker, prompt tokens and prefix hits from the scrapes around it."""
            nonlocal prev
            r1[j] = await http_request(port, "/v1/completions", body(prompts[j]))
            cur = await scrape()
            moved = [w for w in cur if delta(prev[w], cur[w], "requests_total")]
            if len(moved) != 1 or delta(prev[moved[0]], cur[moved[0]],
                                        "requests_total") != 1:
                raise AssertionError(f"fleet round 1: requests moved on {moved}")
            w = moved[0]
            got = (w, delta(prev[w], cur[w], "prompt_tokens_total"),
                   delta(prev[w], cur[w], "prefix_cache_hits_tokens"))
            prev = cur
            return got

        base = prev = await scrape()
        served, r1 = [None] * len(prompts), [None] * len(prompts)
        t1 = time.perf_counter()
        # round 1, one request at a time: prompt 0 through the frontend,
        # prompts 1 and 3 pinned to the other worker so that both hold
        # prefixes, prompt 2 through the frontend; then prompts 4-6, which
        # share 0-2's prefixes, through the frontend: each must go to its
        # prefix's holder and hit the prefix there
        async def pinned_service(worker_id: int) -> HttpService:
            models = ModelManager()
            models.add_completion_model(FLEET_MODEL, link(
                OpenAIPreprocessor(ByteTokenizer()), Backend(ByteTokenizer()),
                Pinned(worker_id)))
            svc = HttpService(models, host="127.0.0.1", port=0)
            await svc.start()
            return svc

        served[0] = await alone(http_port, 0)
        other = next(w for w in pid_of if w != served[0][0])
        pinned = await pinned_service(other)
        try:
            for j in (1, 2, 3):
                served[j] = await alone(pinned.port if j != 2 else http_port, j)
        finally:
            await pinned.close()
        if served[1][0] != other or served[3][0] != other:
            raise AssertionError(f"fleet round 1: pinned prompts on "
                                 f"{served[1][0]:x}, {served[3][0]:x}, not {other:x}")
        for j in range(4, len(prompts)):
            served[j] = await alone(http_port, j)
            w, n, hits = served[j]
            log(f"  prompt {j} (prefix of prompt {j - 4}): worker {w:x}, {hits} of "
                f"{n} prompt tokens from its prefix cache")
            if w != served[j - 4][0] or hits < FLEET_PREFIX // 16 * 16:
                raise AssertionError(
                    f"fleet round 1: prompt {j} went to worker {w:x} hitting {hits} "
                    f"tokens; its prefix is on worker {served[j - 4][0]:x}")
        wall1 = time.perf_counter() - t1
        after1 = prev
        # round 2: the same seven at once
        t2 = time.perf_counter()
        r2 = list(await asyncio.gather(*[
            http_request(http_port, "/v1/completions", body(p)) for p in prompts]))
        wall2 = time.perf_counter() - t2
        after2 = await scrape()
        ttft1, itl1 = stream_stats(r1, "round 1")
        ttft2, itl2 = stream_stats(r2, "round 2")
        for w in after2:
            mine = [n for sw, n, _h in served if sw == w]
            want_hits = sum((n - 1) // 16 * 16 for n in mine)
            got_req = delta(after1[w], after2[w], "requests_total")
            got_hits = delta(after1[w], after2[w], "prefix_cache_hits_tokens")
            log(f"  worker {w:x}: round 1 served prompts "
                f"{[j for j, (sw, _n, _h) in enumerate(served) if sw == w]}, "
                f"round 2 {got_req} requests hitting {got_hits} cached tokens "
                f"(whole cached prompts: {want_hits})")
            if got_req != len(mine) or got_hits != want_hits:
                raise AssertionError(
                    f"fleet round 2: worker {w:x} took {got_req} requests and "
                    f"hit {got_hits} tokens; its round-1 prompts are {len(mine)} "
                    f"holding {want_hits}")
        # the router fed by the same events places each prompt where it went
        for (w, n, _h), ids in zip(served, token_ids):
            scores = router.indexer.find_matches(
                [s for _l, s in sequence_block_hashes(ids, 16)]).scores
            if max(scores, key=scores.get) != w or scores[w] < (n - 1) // 16:
                raise AssertionError(f"fleet index: {scores} for a prompt of "
                                     f"worker {w:x}")
        toks1 = sum(delta(base[w], after1[w], "tokens_generated") for w in base)
        toks2 = sum(delta(after1[w], after2[w], "tokens_generated") for w in base)
        stall = max(d["san_loop_stall_max_ms"] for d in after2.values())
        stalls = sum(d["san_loop_stalls"] for d in after2.values())
        log(f"  round 1 (one at a time; 1 and 3 pinned to worker {other:x}): TTFT ms "
            f"{[round(x, 1) for x in ttft1]}, "
            f"ITL median {statistics.median(itl1):.2f} ms, {toks1} tokens in "
            f"{wall1:.2f} s = {toks1 / wall1:.1f} tok/s  [{FLEET_MODEL}, {card}]")
        log(f"  round 2 (all at once, prefixes cached): TTFT ms "
            f"{[round(x, 1) for x in ttft2]}, ITL median "
            f"{statistics.median(itl2):.2f} ms, {toks2} tokens in {wall2:.2f} s "
            f"= {toks2 / wall2:.1f} tok/s  [{FLEET_MODEL}, {card}]")
        log(f"  the workers' event loops: longest stall {stall:.1f} ms, "
            f"{stalls} stalls of 1 s or more (lease TTL {LEASE_TTL_S:.0f} s)")
        # the frontend, having served both rounds, added no context to the
        # card (nvidia-smi may list pids of another namespace: count them)
        apps = compute_apps()
        if len(apps) != len(apps_before) or str(front.p.pid) in apps:
            raise AssertionError(f"fleet: CUDA contexts {apps_before} before the "
                                 f"frontend started, {apps} after it served")
        log(f"  CUDA contexts on the card (nvidia-smi): {len(apps_before)} before "
            f"the frontend started, {len(apps)} after it served both rounds")
        pulled = await fleet_pull(torch, card, comp, router, scrape, served,
                                  prompts, body, pinned_service, token_ids)

        # (a) SIGKILL with a stream in flight: the frontend's migration
        # resumes it on the survivor as prompt + tokens so far
        mig0 = await frontend_migrations(http_port)
        pre_a = await scrape()
        progress: list = []
        long_a = asyncio.ensure_future(http_request(
            http_port, "/v1/completions", body(long_prompts[0], MIGRATE_TOKENS[0]),
            progress=progress))
        victim = await streaming_worker(scrape, progress, long_a)
        survivor = next(w for w in after2 if w != victim)
        cut_at, lines_at, t_kill = len(progress), len(front.lines), time.time()
        pid_of[victim].p.send_signal(signal.SIGKILL)
        pid_of[victim].p.wait(timeout=30)
        r_a = await asyncio.wait_for(long_a, 120)
        post_a = await scrape()
        mig1 = await frontend_migrations(http_port)
        seams["SIGKILL"] = migrated_stream("SIGKILL", r_a, cut_at, t_kill, lines_at,
                                           pre_a, post_a, survivor, mig0, mig1)
        # heal: the killed worker leaves discovery and the router's index
        first_ok = dropped = None
        while time.time() - t_kill < LEASE_TTL_S + 5 and (
                first_ok is None or dropped is None):
            if first_ok is None:
                # a request the dead worker takes fails: only success counts
                with contextlib.suppress(Exception):
                    status, text, _t = await asyncio.wait_for(http_request(
                        http_port, "/v1/completions", body(prompts[0], 4)), 5)
                    if status == 200 and text:
                        first_ok = time.time() - t_kill
            if dropped is None and victim not in client.instance_ids() and (
                    victim not in router.indexer.index.workers()):
                dropped = time.time() - t_kill
            await asyncio.sleep(0.2)
        if first_ok is None or dropped is None:
            raise AssertionError(f"fleet heal: served again at {first_ok} s, "
                                 f"worker dropped at {dropped} s after SIGKILL")
        before = await scrape()
        r3 = list(await asyncio.gather(*[
            http_request(http_port, "/v1/completions", body(p, 8)) for p in prompts]))
        after3 = await scrape()
        stream_stats(r3, "after the kill")
        if set(after3) != {survivor} or delta(
                before[survivor], after3[survivor], "requests_total") != len(prompts):
            raise AssertionError(f"fleet heal: requests went to {sorted(after3)}")
        log(f"  SIGKILL on worker {victim:x}: served again {first_ok:.2f} s later, "
            f"out of discovery and the router's index {dropped:.2f} s later; heal "
            f"{max(first_ok, dropped):.2f} s (limit {LEASE_TTL_S + 5:.0f}); "
            f"{len(prompts)} more requests all on worker {survivor:x}  [{card}]")
        # the drive's launches: each worker's counters from just before
        # round 1 to its last scrape (the victim's before its kill)
        last = {victim: after2[victim], survivor: after3[survivor]}
        last[victim] = pulled["scrape"][victim]
        launches = {}
        for kernel in ("paged_decode_attention", "paged_prefill_attention",
                       "ragged_mixed_attention", "kv_cache_append",
                       "gather_blocks", "scatter_blocks"):
            per = {w: last[w]["kernel_launches"][kernel]["launches"]
                   - base[w]["kernel_launches"][kernel]["launches"] for w in last}
            launches[kernel] = sum(per.values())
            log(f"  {kernel}: {launches[kernel]} launches in the workers ("
                + ", ".join(f"{w:x}: {n}" for w, n in per.items()) + ")")
        missing = [k for k, n in launches.items() if n <= 0]
        if missing and FLEET_DEVICE == "cuda":  # the CPU launches nothing
            raise AssertionError(f"fleet: kernels never launched: {missing}")

        # (b) a worker relaunched beside the survivor, then SIGTERM with a
        # stream in flight: the drain leaves discovery first, hands the
        # stream off at its deadline, revokes the lease last and exits 0
        t_up = time.perf_counter()
        fresh = FleetProc("worker 2", worker_args)
        procs.append(fresh)
        line = await fresh.wait_for("at dyn://", 600)
        pid_of[int(re.search(r"worker ([0-9a-f]+) serving", line)[1], 16)] = fresh
        while len(client.instance_ids()) < 2:
            await asyncio.sleep(0.1)
        log(f"  worker 2 (pid {fresh.p.pid}) relaunched with --warmup: serving "
            f"{time.perf_counter() - t_up:.1f} s later")
        subjects = {EndpointInfo.from_json(e.value).instance_id:
                    EndpointInfo.from_json(e.value).subject
                    for e in await drt.store.kv_get_prefix(comp.etcd_root + "/")}
        mig0 = await frontend_migrations(http_port)
        pre_b = await scrape()
        progress = []
        long_b = asyncio.ensure_future(http_request(
            http_port, "/v1/completions", body(long_prompts[1], MIGRATE_TOKENS[1]),
            progress=progress))
        drained = await streaming_worker(scrape, progress, long_b)
        other_w = next(w for w in pre_b if w != drained)
        cut_at, lines_at, t_term = len(progress), len(front.lines), time.time()
        pid_of[drained].p.send_signal(signal.SIGTERM)
        t_gone, last = None, None
        while pid_of[drained].p.poll() is None:
            if t_gone is None and drained not in client.instance_ids():
                t_gone = time.time() - t_term
            if t_gone is not None:
                # out of discovery, still serving its stats: the lease holds
                got = await direct_stats(subjects[drained])
                if got is not None:
                    last = (time.time() - t_term, got)
            await asyncio.sleep(0.05)
        code = pid_of[drained].p.wait(timeout=60)
        t_exit = time.time() - t_term
        r_b = await asyncio.wait_for(long_b, 120)
        post_b = await scrape()
        mig1 = await frontend_migrations(http_port)
        seams["SIGTERM"] = migrated_stream("SIGTERM", r_b, cut_at, t_term, lines_at,
                                           pre_b, post_b, other_w, mig0, mig1)
        if (code != 0 or t_gone is None or last is None
                or not last[1]["draining"] or t_exit > FLEET_DRAIN_S + DRAIN_MARGIN_S
                or t_exit < FLEET_DRAIN_S):
            raise AssertionError(
                f"fleet drain: exit {code} {t_exit:.2f} s after SIGTERM, out of "
                f"discovery at {t_gone}, its stats while out of discovery "
                f"{None if last is None else {k: last[1][k] for k in ('draining', 'drain_handoffs')}}")
        log(f"  SIGTERM on worker {drained:x} with the stream in flight: out of "
            f"discovery {t_gone:.2f} s after the signal, still answering stats "
            f"(draining {last[1]['draining']}, drain_handoffs "
            f"{last[1]['drain_handoffs']}) until {last[0]:.2f} s, exit 0 at "
            f"{t_exit:.2f} s (deadline {FLEET_DRAIN_S:g} s)  [{card}]")

        # SIGTERM on the last worker, nothing in flight: exit 0, out of
        # discovery at once
        pid_of[other_w].p.send_signal(signal.SIGTERM)
        code = pid_of[other_w].p.wait(timeout=60)
        for _ in range(50):
            if not client.instance_ids():
                break
            await asyncio.sleep(0.1)
        if code != 0 or client.instance_ids():
            raise AssertionError(f"fleet: SIGTERM left exit {code}, discovery "
                                 f"{client.instance_ids()}")
        log(f"  SIGTERM on worker {other_w:x}: exit 0, out of discovery at once")
    except BaseException:
        for p in procs:
            log(p.tail())
        raise
    finally:
        if drt is not None:
            await drt.shutdown()
        if conn is not None:
            await conn.close()
        for p in reversed(procs):
            p.stop()
    # the single-process engine, built as the workers are, one at a time
    args = parse_args(["in=http", "out=torch", "--model-path", FLEET_MODEL,
                       "--num-blocks", str(FLEET_BLOCKS), "--device", FLEET_DEVICE])
    worker, engine, name = build_engine(args)
    await engine.warmup()
    manager = ModelManager()
    manager.add_completion_model(name, worker)
    svc = HttpService(manager, host="127.0.0.1", port=0)
    await svc.start()
    try:
        alone = [await http_request(svc.port, "/v1/completions", body(p))
                 for p in prompts + list(pulled["prompts"])]
        # the migrated streams against the same engine: undisturbed, and
        # given the request the survivor got (prompt + the tokens the
        # client had at the seam, the resume annotation)
        resumed = [await engine_resume(engine, pre, body(p, n), r, seams[label])
                   for label, p, n, r in zip(("SIGKILL", "SIGTERM"), long_prompts,
                                             MIGRATE_TOKENS, (r_a, r_b))]
        long_alone = [await http_request(svc.port, "/v1/completions", body(p, n))
                      for p, n in zip(long_prompts, MIGRATE_TOKENS)]
    finally:
        await svc.close()
        await engine.close()
    fleet_answers = r1 + list(pulled["answers"])
    same = sum(a[1] == b[1] for a, b in zip(alone, fleet_answers))
    log(f"  one engine in this process, the same prompts one at a time: "
        f"{same} of {len(fleet_answers)} greedy answers equal to the fleet's "
        f"(round 1, the pull's cold, pulled and at-once prompts); TTFT ms "
        f"{[round(t[0] * 1e3, 1) for _s, _x, t in alone]}  [{card}]")
    one_itl = statistics.median(
        (t[-1] - t[0]) * 1e3 / (len(t) - 1) for _s, _x, t in long_alone)
    for (label, seam), (k, n, equal, first, gap), got, undisturbed in zip(
            seams.items(), resumed, (r_a, r_b), long_alone):
        log(f"  migration after the {label}: the client's {n} tokens equal this "
            f"engine's answer to the resumed request (prompt + the {k} tokens "
            f"before the seam, the resume annotation) token for token: {equal}; "
            f"equal to its undisturbed answer: {undisturbed[1] == got[1]}"
            + ("" if undisturbed[1] == got[1] else
               f" (first different token {first}, {first - k} after the seam)")
            + f"; the seam's gap {gap:.1f} ms between two text events (the "
            f"re-dispatch left {seam['redispatch_ms']:.1f} ms after the cut) "
            f"against this engine's mean ITL {one_itl:.2f} ms on the same "
            f"streams: {gap - one_itl:.1f} ms added  [{FLEET_MODEL}, {card}]")
        if not equal:
            raise AssertionError(f"fleet {label}: the migrated stream is not the "
                                 "engine's continuation of the resumed request")
    if same != len(fleet_answers):
        raise AssertionError("fleet: answers differ from the single-process engine's")
    del worker, engine
    gc.collect()
    if FLEET_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return launches


# ---------------- phase 3: the disaggregated roles ----------------

DISAGG_MODEL = "llama3-8b-sim"
DISAGG_DEVICE = "cuda"
DISAGG_TARGET = "dyn://dynamo.backend.generate"
#: the decode worker's pool (two rounds of ten prompts and their decode);
#: the prefill worker's and the in-process engines'
DISAGG_BLOCKS = 4096
DISAGG_PREFILL_BLOCKS = 1024
DISAGG_TOKENS = 16
DISAGG_LOCAL = 512
DISAGG_PROMPTS = 10
#: the prompts' byte lengths (BOS makes them 1500-3072 tokens) and the
#: short local one's
DISAGG_LENGTHS = (1499, 3071)
DISAGG_SHORT = 300
#: the faulted prefill worker's segment cap, so that its stream has three
#: segments (a 3072-token prompt: 192 pages in chunks of 128 and 64)
DISAGG_KILL_SEGMENT = 64
#: a 3072-token prompt's pages (phase 2 checks the block copies there)
DISAGG_PAGES = 192
#: (label, decode role flags, prefill role flags, the prompt sets' tag)
DISAGG_VARIANTS = (
    ("streamed, bf16 wire", [], [], "S"),
    ("streamed, int8 wire", [], ["--kv-quant", "int8"], "Q"),
    ("bulk, bf16 wire", ["--no-kv-stream"], ["--no-kv-stream"], "S"),
)
#: the fault that holds a prefill worker's second segment (its third
#: mid_kv_transfer hit: the stream's open, then one per segment) while the
#: drive kills it
DISAGG_KILL_FAULT = "mid_kv_transfer:delay=60@3"


def disagg_prompts(tag: str) -> list:
    """Ten prompts of 1500-3072 byte tokens (BOS included), each distinct
    from its first block on; ``tag`` names the round."""
    out = []
    lo, hi = DISAGG_LENGTHS
    for i in range(DISAGG_PROMPTS):
        n = lo + (hi - lo) * i // (DISAGG_PROMPTS - 1)
        head = f"{tag}{i} handoff {i * 7919 % 1000:03d}: "
        out.append((head + f"the prefill worker ships request {i}'s pages. "
                    * 80)[:n])
    return out


def disagg_body(prompt: str) -> dict:
    return {"model": DISAGG_MODEL, "prompt": prompt, "max_tokens": DISAGG_TOKENS,
            "temperature": 0.0, "stream": True, "nvext": {"ignore_eos": True}}


def median_range(xs: list) -> str:
    return (f"{statistics.median(xs):.1f} [{min(xs):.1f}-{max(xs):.1f}]"
            if xs else "—")


async def disagg_reference(torch, sets: dict, codec: set) -> dict:
    """Answers and TTFTs of one aggregated engine in this process, each
    prompt alone and cold; for the prompt sets in ``codec``, the answers of
    the int8 wire's arithmetic instead: the prompt prefilled on that engine
    (``prefill_extract``), its KV through ``kvquant``'s int8 round trip on
    the host, landed full width on a second engine (``begin_remote`` /
    ``complete_remote``, one ``scatter_blocks``) that decodes it."""
    from dynamo_tpu_torch.engine import kvquant
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.http import HttpService, ModelManager
    from dynamo_tpu_torch.launch.dynamo_run import build_engine, parse_args
    from dynamo_tpu_torch.llm import ByteTokenizer
    from dynamo_tpu_torch.llm.openai_engine import OpenAIWorkerEngine
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.engine import AsyncEngine, AsyncEngineContext

    args = parse_args(["in=http", "out=torch", "--model-path", DISAGG_MODEL,
                       "--num-blocks", str(DISAGG_PREFILL_BLOCKS),
                       "--device", DISAGG_DEVICE])
    worker, engine, name = build_engine(args)
    await engine.warmup()
    landing = TorchEngine(engine.cfg, params=engine.params, device=engine.device)

    class CodecLanding(AsyncEngine):
        async def generate(self, request):
            req = request.data
            if isinstance(req, dict):
                req = PreprocessedRequest.from_dict(req)
            first, lp, k, v = await engine.prefill_extract(
                req, AsyncEngineContext(request.id))
            k, v = kvquant.dequantize_stack(*kvquant.quantize_stack(k, v, "int8"),
                                            k.dtype)
            handle = landing.begin_remote(request.transfer(req))
            landing.start()
            q = await landing.complete_remote(handle, first, k, v, first_lp=lp)
            while (out := await q.get()) is not None:
                yield out
                if out.is_final():
                    return

    models = ModelManager()
    models.add_completion_model(name, worker)
    codec_models = ModelManager()
    codec_models.add_completion_model(name, OpenAIWorkerEngine(ByteTokenizer(),
                                                               CodecLanding()))
    svc = HttpService(models, host="127.0.0.1", port=0)
    codec_svc = HttpService(codec_models, host="127.0.0.1", port=0)
    await svc.start()
    await codec_svc.start()
    out = {}
    try:
        for tag, prompts in sets.items():
            port = codec_svc.port if tag in codec else svc.port
            for p in prompts:
                out[p] = await http_request(port, "/v1/completions", disagg_body(p))
    finally:
        await svc.close()
        await codec_svc.close()
        await landing.close()
        await engine.close()
    del worker, engine, landing
    gc.collect()
    if DISAGG_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


async def disagg_drive(torch, dev, card: str) -> dict:
    """The disaggregated roles on the card, each a ``dynamo_run`` process:
    the hub, a ``--disagg decode`` worker, an ``in=prefill`` worker and a
    card-less frontend; this process scrapes both workers' stats (the
    decode worker's at its endpoint, the prefill worker's at
    ``dynamo.prefill.status``). For each variant, ten prompts one at a
    time, then ten more at once, every answer equal to the aggregated
    reference's; the first variant adds a short prompt (local prefill) and
    the last-but-one a prefill worker killed mid-stream. Returns the
    drive's launches of the GQA kernels and the block copies, summed over
    both workers."""
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import connect_hub

    sets = {}
    for _label, _d, _p, tag in DISAGG_VARIANTS:
        sets.setdefault(tag + "1", disagg_prompts(tag + "1"))
        sets.setdefault(tag + "2", disagg_prompts(tag + "2"))
    kill_prompt = disagg_prompts("K")[-1]
    short = ("A short question the decode worker prefills itself. " * 9)[:DISAGG_SHORT]
    sets["K"], sets["short"] = [kill_prompt], [short]
    t0 = time.perf_counter()
    ref = await disagg_reference(torch, sets, codec={"Q1", "Q2"})
    log(f"  disagg: the aggregated reference in this process, {len(ref)} prompts "
        f"one at a time, {time.perf_counter() - t0:.1f} s")
    hub_port, http_port = free_port(), free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    common = ["--hub", hub_addr, "--model-path", DISAGG_MODEL, "--host", "127.0.0.1",
              "--device", DISAGG_DEVICE, "--drain-deadline", str(FLEET_DRAIN_S)]
    procs: list = []
    drt = conn = None
    launches: dict = {}

    def start_decode(flags):
        p = FleetProc("decode", [f"in={DISAGG_TARGET}", "out=torch", "--disagg",
                                 "decode", "--max-local-prefill", str(DISAGG_LOCAL),
                                 "--num-blocks", str(DISAGG_BLOCKS), "--warmup"]
                      + common + flags)
        procs.append(p)
        return p

    def start_prefill(flags, label="prefill", env=None, warmup=True):
        p = FleetProc(label, ["in=prefill", "out=torch", "--num-blocks",
                              str(DISAGG_PREFILL_BLOCKS)]
                      + (["--warmup"] if warmup else []) + common + flags,
                      env=env)
        procs.append(p)
        return p

    async def stop(p, sig=signal.SIGTERM) -> int:
        p.p.send_signal(sig)
        code = await asyncio.get_running_loop().run_in_executor(
            None, p.p.wait, 60)
        procs.remove(p)
        return code

    try:
        hub = FleetProc("hub", ["hub", "--host", "127.0.0.1", "--hub-port",
                                str(hub_port)])
        procs.append(hub)
        await hub.wait_for("hub listening", 60)
        store, bus, conn = await asyncio.wait_for(connect_hub(hub_addr), 30)
        drt = await DistributedRuntime.from_settings(store=store, bus=bus)
        ns, comp_name, _ep = DISAGG_TARGET.removeprefix("dyn://").split(".")
        dcomp = drt.namespace(ns).component(comp_name)
        pcomp = drt.namespace(ns).component("prefill")
        front = FleetProc("frontend", ["in=http", f"out={DISAGG_TARGET}",
                                       "--http-port", str(http_port), "--hub",
                                       hub_addr, "--host", "127.0.0.1"],
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        procs.append(front)
        await front.wait_for("OpenAI server", 120)

        async def one(comp) -> dict:
            got = [s["data"] for s in await comp.scrape_stats(timeout=10)]
            if len(got) != 1 or not got[0]:
                raise AssertionError(f"disagg: want one instance's stats, got {got}")
            return got[0]

        async def ready(decode, prefill) -> None:
            t_s = time.perf_counter()
            await decode.wait_for("at dyn://", 600)
            await prefill.wait_for("prefill worker", 600)
            # the frontend serves once it discovered the decode worker
            while time.perf_counter() - t_s < 600:
                status, text, _t = await http_request(
                    http_port, "/v1/completions", dict(disagg_body("hello"),
                                                      max_tokens=1))
                if status == 200:
                    return
                await asyncio.sleep(0.5)
            raise AssertionError("disagg: the frontend never served")

        def delta(a, b, key):
            return b[key] - a[key]

        def kernel_delta(a, b, name):
            return (b["kernel_launches"][name]["launches"]
                    - a["kernel_launches"][name]["launches"])

        def check(label, results, prompts):
            bad = [i for i, (r, p) in enumerate(zip(results, prompts))
                   if r[0] != 200 or not r[1] or r[1] != ref[p][1]]
            if bad:
                raise AssertionError(f"disagg {label}: answers {bad} differ from "
                                     f"the aggregated reference's")
            return [r[2][0] * 1e3 for r in results]

        decode = prefill = None
        for v, (label, dflags, pflags, tag) in enumerate(DISAGG_VARIANTS):
            t_v = time.perf_counter()
            if decode is None or dflags:
                if decode is not None:
                    await stop(decode)
                decode = start_decode(dflags)
            if prefill is not None:
                await stop(prefill)
            prefill = start_prefill(pflags)
            await ready(decode, prefill)
            d0, p0 = await one(dcomp), await one(pcomp)
            n_rec_d, n_rec_p = len(d0["handoffs"]), len(p0["handoffs"])
            ones = [await http_request(http_port, "/v1/completions", disagg_body(p))
                    for p in sets[tag + "1"]]
            d1, p1 = await one(dcomp), await one(pcomp)
            t_all = time.perf_counter()
            alls = list(await asyncio.gather(*[
                http_request(http_port, "/v1/completions", disagg_body(p))
                for p in sets[tag + "2"]]))
            wall_all = time.perf_counter() - t_all
            d2, p2 = await one(dcomp), await one(pcomp)
            ttft1 = check(f"{label}, one at a time", ones, sets[tag + "1"])
            ttft2 = check(f"{label}, all at once", alls, sets[tag + "2"])
            # the aggregated engine's cold TTFT: on these prompts, or (the
            # int8 wire's, whose reference lands through the codec) on the
            # bf16 set, of the same lengths
            ref_ttft = [ref[p][2][0] * 1e3 for p in sets[
                tag + "1" if tag == DISAGG_VARIANTS[0][3] else
                DISAGG_VARIANTS[0][3] + "1"]]
            remote = delta(d0, d2, "remote_prefills")
            flavor = "bulk_deliveries" if dflags else "streamed_deliveries"
            if remote != 2 * DISAGG_PROMPTS or delta(d0, d2, flavor) != remote:
                raise AssertionError(f"disagg {label}: {remote} remote prefills, "
                                     f"{delta(d0, d2, flavor)} {flavor}")
            # the handoff's anatomy, one-at-a-time requests (both sides'
            # records of the round, matched by request id)
            precs = {r["request_id"]: r for r in p1["handoffs"][n_rec_p:]}
            drecs = [r for r in d1["handoffs"][n_rec_d:] if r["request_id"] in precs]
            precs = [precs[r["request_id"]] for r in drecs]
            if len(drecs) != DISAGG_PROMPTS:
                raise AssertionError(f"disagg {label}: {len(drecs)} matched handoff "
                                     "records")

            def med(recs, key):
                return statistics.median(r[key] for r in recs)

            send = sum(r["send_ms"] for r in precs)
            hidden = sum(r["hidden_ms"] for r in precs)
            log(f"  disagg {label}: TTFT ms one at a time {median_range(ttft1)} "
                f"(the aggregated engine's cold TTFT on prompts of these lengths "
                f"{median_range(ref_ttft)}); {DISAGG_PROMPTS} more at once "
                f"{median_range(ttft2)}, {wall_all:.2f} s; answers "
                f"{2 * DISAGG_PROMPTS} of {2 * DISAGG_PROMPTS} equal  "
                f"[{DISAGG_MODEL}, {card}]")
            log(f"  disagg {label} anatomy (medians, ms, one at a time): queue "
                f"wait {med(precs, 'queue_wait_ms'):.1f}, prefill "
                f"{med(precs, 'compute_ms'):.1f}, gather + d2h {med(precs, 'gather_ms'):.1f}, "
                f"quantize {med(precs, 'quant_ms'):.1f}, wire {med(precs, 'send_ms'):.1f} "
                f"for {med(precs, 'nbytes') / 2**20:.1f} MiB "
                f"({med(precs, 'segments'):.0f} segments), "
                f"exposed {med(precs, 'exposed_ms'):.1f}; hidden behind prefill "
                f"{hidden:.1f} of {send:.1f} ms of wire time "
                f"({hidden / max(send, 1e-9):.1%}); the decode side's handoff "
                f"(enqueue to delivery) {med(drecs, 'handoff_ms'):.1f}, landing "
                f"scatter {med(drecs, 'scatter_ms'):.1f}")
            wants = {"decode": ("paged_decode_attention", "kv_cache_append",
                                "scatter_blocks_dequant" if "int8" in label
                                else "scatter_blocks"),
                     "prefill": ("paged_prefill_attention", "gather_blocks")}
            got = {}
            for side, (a, b) in (("decode", (d0, d2)), ("prefill", (p0, p2))):
                for name in ("paged_decode_attention", "paged_prefill_attention",
                             "ragged_mixed_attention", "kv_cache_append",
                             "gather_blocks", "scatter_blocks",
                             "scatter_blocks_dequant"):
                    n = kernel_delta(a, b, name)
                    got[(side, name)] = n
                    launches[name] = launches.get(name, 0) + n
            log(f"  disagg {label} launches: " + ", ".join(
                f"{side} {name} {n}" for (side, name), n in got.items() if n))
            missing = [(side, k) for side, ks in wants.items() for k in ks
                       if got[(side, k)] <= 0]
            # the CPU (a rehearsal) runs the plain twins: nothing launches
            if missing and DISAGG_DEVICE == "cuda":
                raise AssertionError(f"disagg {label}: never launched: {missing}")
            if v == 0:
                d3 = await one(dcomp)
                status, text, tt = await http_request(http_port, "/v1/completions",
                                                      disagg_body(short))
                d4 = await one(dcomp)
                if (text != ref[short][1] or delta(d3, d4, "local_prefills") != 1
                        or delta(d3, d4, "remote_prefills")):
                    raise AssertionError("disagg: the short prompt did not serve "
                                         "locally with the reference's answer")
                log(f"  disagg: a {len(short)}-byte prompt prefilled on the decode "
                    f"worker (local_prefills +1), TTFT {tt[0] * 1e3:.1f} ms")
            if v == 1:
                await disagg_kill(decode, prefill, start_prefill, stop, one, dcomp,
                                  pcomp, http_port, kill_prompt, ref, card)
                prefill = None
            log(f"  disagg {label}: {time.perf_counter() - t_v:.1f} s")
        # SIGTERM on the prefill worker after the last answer: its drain
        # stops consuming the queue, revokes the lease and exits 0
        t_term = time.perf_counter()
        code = await stop(prefill)
        took = time.perf_counter() - t_term
        if (code != 0 or took > FLEET_DRAIN_S + DRAIN_MARGIN_S
                or not any(x.endswith("stopped") for x in prefill.lines)):
            raise AssertionError(f"disagg: the prefill worker's SIGTERM: exit "
                                 f"{code} after {took:.2f} s:\n{prefill.tail()}")
        log(f"  disagg: SIGTERM on the prefill worker: stopped consuming, exit 0 "
            f"{took:.2f} s later (drain deadline {FLEET_DRAIN_S:g} s + "
            f"{DRAIN_MARGIN_S:.0f} s margin)  [{card}]")
        await stop(decode)
    except BaseException:
        for p in procs:
            log(p.tail())
        raise
    finally:
        if drt is not None:
            await drt.shutdown()
        if conn is not None:
            await conn.close()
        for p in reversed(procs):
            p.stop()
    return launches


async def disagg_kill(decode, prefill, start_prefill, stop, one, dcomp, pcomp,
                      http_port, prompt, ref, card) -> None:
    """The prefill worker killed mid-stream: a worker whose fault delays its
    second segment takes the request; once the decode worker landed the
    first, SIGKILL; a fresh worker then gets the redelivered item once, and
    the answer equals the reference's."""
    await stop(prefill)
    victim = start_prefill(["--kv-segment-blocks", str(DISAGG_KILL_SEGMENT)],
                           "prefill (faulted)",
                           env=dict(os.environ, DYN_FAULTPOINTS=DISAGG_KILL_FAULT))
    await victim.wait_for("prefill worker", 600)
    d0 = await one(dcomp)
    t0 = time.perf_counter()
    req = asyncio.ensure_future(http_request(http_port, "/v1/completions",
                                             disagg_body(prompt)))
    while time.perf_counter() - t0 < 60:
        d = await one(dcomp)
        if d["kv_stream_segments"] > d0["kv_stream_segments"]:
            break
        await asyncio.sleep(0.1)
    else:
        raise AssertionError("disagg kill: no segment landed before the kill")
    landed = d["kv_stream_segments"] - d0["kv_stream_segments"]
    code = await stop(victim, signal.SIGKILL)
    t_kill = time.perf_counter()
    fresh = start_prefill([], "prefill (fresh)", warmup=False)
    await fresh.wait_for("prefill worker", 600)
    status, text, _t = await asyncio.wait_for(req, 120)
    t_done = time.perf_counter()
    d1, p1 = await one(dcomp), await one(pcomp)
    if (status != 200 or text != ref[prompt][1]
            or d1["remote_prefills"] - d0["remote_prefills"] != 1
            or d1["streamed_deliveries"] - d0["streamed_deliveries"] != 1
            or p1["prefills_total"] != 1 or p1["kv_stream_sends"] != 1):
        raise AssertionError(
            f"disagg kill: status {status}, answer equal {text == ref[prompt][1]}, "
            f"decode {d1['remote_prefills'] - d0['remote_prefills']} remote / "
            f"{d1['streamed_deliveries'] - d0['streamed_deliveries']} delivered, "
            f"fresh worker {p1['prefills_total']} prefills")
    log(f"  disagg kill: the prefill worker SIGKILLed (exit {code}) after "
        f"{landed} of its segments landed; a fresh worker took the redelivered "
        f"item once (the queue's visibility timeout, 60 s): the answer "
        f"{t_done - t_kill:.1f} s after the kill, equal to the reference's  "
        f"[{card}]")
    await stop(fresh)


# ---------------- phase 4: timing ----------------


def time_ms(torch, fn, reps: int, flush, setup=None) -> float:
    """Median ms per call, L2 flushed before each (CUDA events). A
    device-side spin after the flush keeps the card busy while the host
    enqueues the call, so the time of a kernel or of a library call of a
    few ops excludes the host's launch path (a plain version's many small
    ops still pay their host gaps). ``setup``, when given, runs before
    each call, outside the timed span (an in-place call's inputs reset)."""
    for _ in range(2):
        if setup:
            setup()
        fn()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # ~1 ms at the H100's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_calls(torch, inp: KernelInputs):
    """PyTorch library calls computing each kernel's function on the same
    inputs, K/V laid out contiguously: the yardstick (timed only). One call
    each, except ragged: one for the decode rows plus one per live segment,
    timed together."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.paged_attention import gather_pages

    dev = inp.kc.device
    gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)

    def contiguous(tables, S):
        k = gather_pages(inp.kc, tables).transpose(0, 1)[:, :, :S]  # [R,Hkv,S,D]
        v = gather_pages(inp.vc, tables).transpose(0, 1)[:, :, :S]
        if not gqa:
            G = inp.H // inp.Hkv
            k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
        return k.contiguous(), v.contiguous()

    def sdpa(q, k, v, mask):
        kw = {"enable_gqa": True} if gqa else {}
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=inp.scale, **kw)

    def causal(q, table, hist):
        """q ``[T, H, D]`` at positions hist..hist+T-1 over its own prefix."""
        T = q.shape[0]
        k, v = contiguous(table[None], hist + T)
        mask = (torch.arange(hist + T, device=dev)[None]
                <= hist + torch.arange(T, device=dev)[:, None])
        return q.transpose(0, 1)[None], k, v, mask

    S = int(inp.d_lens.max())
    dk, dv = contiguous(inp.d_tables, S)
    dq = inp.q_dec[:, :, None]  # [B, H, 1, D]
    dmask = (torch.arange(S, device=dev)[None] < inp.d_lens[:, None])[:, None, None]
    pre = causal(inp.q_pre, inp.p_table, int(inp.hist))
    # ragged: the decode rows' call plus one call per live segment over
    # its real rows at its own horizon (a dead segment attends nothing)
    segs = [causal(inp.q_chunks[m, :n], inp.r_tables[m], int(inp.r_hists[m]))
            for m, n in enumerate(inp.r_valids.tolist()) if n > 0]

    def ragged():
        sdpa(dq, dk, dv, dmask)
        for seg in segs:
            sdpa(*seg)

    idx = (inp.a_blk.long(), inp.a_off.long())
    kvals = inp.k_new.permute(0, 2, 1, 3).contiguous()
    vvals = inp.v_new.permute(0, 2, 1, 3).contiguous()

    def append():
        inp.a_kc[:, :, idx[0], idx[1]] = kvals
        inp.a_vc[:, :, idx[0], idx[1]] = vvals

    # the verify's history pass: each sequence's T tokens as T query
    # positions over its history (no causal part inside the history)
    vq = inp.q_ver.transpose(1, 2).contiguous()  # [B, H, T, D]
    return {
        "paged_decode_attention": lambda: sdpa(dq, dk, dv, dmask),
        "paged_prefill_attention": lambda: sdpa(*pre),
        "ragged_mixed_attention": ragged,
        "kv_cache_append": append,
        "paged_decode_attention" + VERIFY: lambda: sdpa(vq, dk, dv, dmask),
    }


def work(inp: KernelInputs, tag=None) -> dict:
    """(bytes, flops) each kernel must move/compute on these inputs: each
    input it needs read once, each output written once. Counted from this
    run's data: only the queries of rows that attend something, the cached
    positions they attend and the table entries that reach them. ``tag``:
    the rows' name suffix (default: by the pages' type)."""
    H, Hkv, D, bs = inp.H, inp.Hkv, inp.D, inp.bs
    elem = inp.kc.element_size()  # 2 (bf16), or 1 (int8 or fp8 pages)
    kv_row = Hkv * D * elem * 2  # K and V bytes of one position
    q_row = H * D * 2  # one token's queries (read) or output (written)
    entry = 4 + (8 if inp.sc else 0)  # a table entry, plus the page's scales

    def pages(n):  # table entries (and page scales) read to reach n positions
        return -(-n // bs) * entry / 4

    lens = [int(x) for x in inp.d_lens]
    live = sum(1 for n in lens if n > 0)  # an empty slot reads no q
    dec_bytes = (live * q_row + len(lens) * q_row + sum(lens) * kv_row
                 + sum(pages(n) for n in lens) * 4 + len(lens) * 4)
    dec_stats = len(lens) * H * 4 * 2  # (m, l) f32 written
    dec_flops = 4 * H * D * sum(lens)
    hist, T = int(inp.hist), inp.q_pre.shape[0]
    pre_bytes = (2 * T * q_row + (hist + T) * kv_row + pages(hist + T) * 4)
    pre_flops = 4 * H * D * sum(hist + t + 1 for t in range(T))
    # ragged: every segment row is written, only the real ones are read
    MP, seg_T = inp.q_chunks.shape[:2]
    segs = list(zip(inp.r_hists.tolist(), inp.r_valids.tolist()))
    rag_bytes = (dec_bytes + sum(n for _, n in segs) * q_row + MP * seg_T * q_row
                 + sum((h + n) * kv_row + pages(h + n) * 4 for h, n in segs if n)
                 + MP * 2 * 4)
    rag_flops = dec_flops + sum(4 * H * D * sum(h + t + 1 for t in range(n))
                                for h, n in segs)
    # the append: bf16 rows read, the cache's type written, K and V, and
    # the B page and row indices
    app_bytes = 2 * inp.k_new.numel() * (2 + elem) + 8 * 4 * 2
    fp8 = inp.kc.dtype == inp.torch.float8_e4m3fn
    if tag is None:
        tag = INT8_KV if inp.sc else (FP8_KV if fp8 else "")
    out = {
        "paged_decode_attention" + tag: (dec_bytes + dec_stats, dec_flops),
        "paged_prefill_attention" + tag: (pre_bytes, pre_flops),
        "ragged_mixed_attention" + tag: (rag_bytes, rag_flops),
    }
    if not inp.sc:  # the int8 append is the quantized one (quant_work)
        out["kv_cache_append" + tag] = (app_bytes, 0)
    return out


def window_spans(inp: KernelInputs) -> dict:
    """Each windowed call's rows as (first, last) attended positions, from
    this run's data: the merged decode's rows one past the cache (the
    in-flight token merges outside the kernel), the ragged call's decode
    rows at seq_len - 1, every real prefill / segment row at its own
    position; empty rows left out."""
    W = inp.window
    dec = [(max(0, n + 1 - W), n - 1) for n in inp.d_lens.tolist() if n]
    rag_dec = [(max(0, n - W), n - 1) for n in inp.d_lens.tolist() if n]
    hist, T = int(inp.hist), inp.q_pre.shape[0]
    pre = [(max(0, q - W + 1), q) for q in range(hist, hist + T)]
    segs = [[(max(0, q - W + 1), q) for q in range(h, h + n)]
            for h, n in zip(inp.r_hists.tolist(), inp.r_valids.tolist())]
    return {"decode": dec, "ragged decode": rag_dec, "prefill": pre,
            "segments": segs}


def window_work(inp: KernelInputs, names=(WINDOW, WINDOW_SINKS)) -> dict:
    """(bytes, flops) of the windowed calls on these inputs, counting only
    what the window needs: the K/V rows of the positions some row of a
    sequence attends (each read once), the table entries (and page scales)
    that reach them, the queries of real rows read, every output row
    written, the sink logits; 4 * D flops per head per attended
    position."""
    H, Hkv, D, bs = inp.H, inp.Hkv, inp.D, inp.bs
    kv_row = Hkv * D * inp.kc.element_size() * 2
    q_row = H * D * 2
    entry = 4 + (8 if inp.sc else 0)
    sink_bytes = 0 if inp.sinks is None else H * 4
    sp = window_spans(inp)

    def seq(spans):  # one sequence's K/V bytes + table entries
        lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
        return (hi - lo + 1) * kv_row + (hi // bs - lo // bs + 1) * entry

    def flops(spans):
        return 4 * H * D * sum(b - a + 1 for a, b in spans)

    B = inp.d_lens.numel()
    dec_bytes = (len(sp["decode"]) * q_row + B * q_row + B * 4
                 + sum(seq([r]) for r in sp["decode"]) + B * H * 4 * 2)
    T = inp.q_pre.shape[0]
    pre_bytes = 2 * T * q_row + seq(sp["prefill"]) + sink_bytes
    MP, seg_T = inp.q_chunks.shape[:2]
    rag_bytes = (len(sp["ragged decode"]) * q_row + B * q_row + B * 4
                 + sum(seq([r]) for r in sp["ragged decode"])
                 + sum(len(s) * q_row + seq(s) for s in sp["segments"] if s)
                 + MP * seg_T * q_row + MP * 2 * 4 + sink_bytes)
    return {
        "paged_decode_attention" + names[0]: (dec_bytes, flops(sp["decode"])),
        "paged_prefill_attention" + names[1]: (pre_bytes, flops(sp["prefill"])),
        "ragged_mixed_attention" + names[1]: (
            rag_bytes, flops(sp["ragged decode"])
            + sum(flops(s) for s in sp["segments"])),
    }


def window_library_calls(torch, inp: KernelInputs,
                         names=(WINDOW, WINDOW_SINKS)) -> dict:
    """SDPA over each windowed call's window only (no sink: SDPA has
    none), K/V laid out contiguously outside the timed span: the decode
    rows over their W - 1 cached positions, prefill and each live segment
    over their band of positions with a banded causal mask. Timed only."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.paged_attention import gather_pages

    dev = inp.kc.device
    kw = ({"enable_gqa": True}
          if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
          else None)
    G = inp.H // inp.Hkv
    sp = window_spans(inp)

    def kv(table, first, S):
        """K/V of positions first .. first + S - 1 of each row's table:
        [R, Hkv(, x G), S, D]."""
        idx = (first[:, None] + torch.arange(S, device=dev)).clamp(
            max=table.shape[-1] * inp.bs - 1)
        out = []
        for c in (inp.kc, inp.vc):
            full = gather_pages(c, table)  # [Hkv, R, M*bs, D]
            g = torch.gather(full, 2, idx[None, :, :, None].expand(
                inp.Hkv, -1, -1, inp.D)).transpose(0, 1)
            out.append((g if kw else g.repeat_interleave(G, 1)).contiguous())
        return out

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=inp.scale, **(kw or {}))

    def rows(spans, table, q):
        """Decode rows: q [B, H, D], one span per live row (the empty one
        masked off)."""
        S = max(b - a + 1 for a, b in spans)
        lens = inp.d_lens.tolist()
        first, n = [], []
        it = iter(spans)
        for L in lens:
            a, b = next(it) if L else (0, -1)
            first.append(a)
            n.append(b - a + 1)
        first = torch.tensor(first, device=dev)
        k, v = kv(table, first, S)
        mask = (torch.arange(S, device=dev)[None]
                < torch.tensor(n, device=dev)[:, None])[:, None, None]
        return q[:, :, None], k, v, mask

    def band(q, table, spans):
        lo = spans[0][0]
        hi = spans[-1][1]
        S = hi - lo + 1
        k, v = kv(table[None], torch.tensor([lo], device=dev), S)
        pos = lo + torch.arange(S, device=dev)
        qpos = torch.tensor([b for _a, b in spans], device=dev)
        mask = (pos[None] <= qpos[:, None]) & (qpos[:, None] - pos[None]
                                               < inp.window)
        return q[: len(spans)].transpose(0, 1)[None], k, v, mask

    dec = rows(sp["decode"], inp.d_tables, inp.q_dec)
    rdec = rows(sp["ragged decode"], inp.d_tables, inp.q_dec)
    pre = band(inp.q_pre, inp.p_table, sp["prefill"])
    segs = [band(inp.q_chunks[m], inp.r_tables[m], s)
            for m, s in enumerate(sp["segments"]) if s]

    def ragged():
        sdpa(*rdec)
        for seg in segs:
            sdpa(*seg)

    return {"paged_decode_attention" + names[0]: lambda: sdpa(*dec),
            "paged_prefill_attention" + names[1]: lambda: sdpa(*pre),
            "ragged_mixed_attention" + names[1]: ragged}


def quant_work(torch, qi: QuantInputs) -> dict:
    """(bytes, flops) of the two quantized-path kernels on these inputs.
    ragged_int8_gmm (int8 codes, gate/up shape): the rows read (bf16) and
    written (f32), the codes and scales of the experts that own a row (the
    others are never read), 2 flops per multiply-add of the owned rows;
    the operations count at the bf16 rate (the reference widens the codes
    to the rows' bf16). kv_cache_append_quantized, the whole function
    (one launch): blk/off read; per cache the new rows read (bf16), the
    old scale of each written (layer, page) read and the grown ones
    written, each row written in int8, and each page whose scale grew (not
    the trash page) read and written but for the row it replaces;
    n_requants written."""
    from dynamo_tpu_torch.ops.kv_cache_update import quant_scale_update

    out = {key: gmm_work(qi, label) for label, key in (
        ("decode", "ragged_int8_gmm"), ("prefill", "ragged_int8_gmm (prefill rows)"))}
    L, B, Hkv, D = qi.k_new.shape
    bs = qi.caches.shape[4]
    row = Hkv * D
    pages = len(set(qi.blk.tolist()))  # distinct pages written per layer
    nbytes = 2 * B * 4 + 4
    for x, s in ((qi.k_new, qi.scales[0]), (qi.v_new, qi.scales[1])):
        new, _, _ = quant_scale_update(x, s, qi.blk)
        grown = new > s  # [L, N]
        rmw = int(grown[:, 1:].sum())
        nbytes += (x.numel() * x.element_size() + L * pages * 4
                   + int(grown.sum()) * 4 + L * B * row
                   + rmw * 2 * (bs - 1) * row)
    out["kv_cache_append_quantized"] = (nbytes, 0)
    return out


def gmm_work(qi: QuantInputs, label: str, proj: str = "gate"):
    """(bytes, flops) of one ragged_int8_gmm launch (int8 codes): the rows
    read (bf16) and written (f32), the codes and scales of the experts
    that own a row (the others are never read), the int64 group sizes, 2
    flops per multiply-add of the owned rows."""
    q, _ = qi.codes["int8", proj]
    X, K, N = q.shape
    _, sizes = qi.rows[label]
    R = int(sizes.sum()) + 16
    owned, experts = int(sizes.sum()), int((sizes > 0).sum())
    nbytes = owned * K * 2 + R * N * 4 + experts * (K * N + N * 4) + X * 8
    return nbytes, 2 * owned * K * N


def grouped_mm_call(torch, qi: QuantInputs, label: str, proj: str = "gate"):
    """torch._grouped_mm over the bf16 experts dequantized OUTSIDE the
    timed span, on the owned rows (the yardstick; never called by the
    port)."""
    q, sc = qi.codes["int8", proj]
    w = (q.float() * sc[:, None, :]).bfloat16()
    lhs, sizes = qi.rows[label]
    x = lhs[q.shape[1]][: int(sizes.sum())]
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    return lambda: torch._grouped_mm(x, w, offs=offs)


def quant_library_calls(torch, qi: QuantInputs) -> dict:
    """torch._grouped_mm over the bf16 experts dequantized OUTSIDE the
    timed span (the yardstick of ragged_int8_gmm; timed only, never called
    by the port). No single PyTorch call computes the quantized append."""
    return {key: grouped_mm_call(torch, qi, label) for label, key in (
        ("decode", "ragged_int8_gmm"), ("prefill", "ragged_int8_gmm (prefill rows)"))}


def mla_work(mi: MlaInputs) -> dict:
    """(bytes, flops) of the two latent kernels on these inputs, counted
    like :func:`work`: queries of rows that attend something, every output
    row (decode in the inputs' dtype with f32 (m, l); prefill in f32), the
    latent rows (C + R values) of the positions attended, the table entries
    that reach them; 2 flops per multiply-add of the scores (C + R) and of
    the value product (C)."""
    H, C, R, bs = mi.H, mi.C, mi.R, mi.bs
    es = mi.qe_dec.element_size()  # queries and the decode output
    row = (C + R) * mi.cc.element_size()  # one position's latents (fp8: 1 B)

    def pages(n):
        return -(-n // bs)

    lens = [int(x) for x in mi.d_lens]
    live = sum(1 for n in lens if n > 0)
    dec_bytes = (live * H * (C + R) * es + len(lens) * H * (C * es + 8)
                 + sum(lens) * row + sum(pages(n) for n in lens) * 4 + len(lens) * 4)
    dec_flops = 2 * H * (2 * C + R) * sum(lens)
    hist, T = int(mi.hist), mi.qe_pre.shape[0]
    pre_bytes = (T * H * (C + R) * es + T * H * C * 4 + (hist + T) * row
                 + pages(hist + T) * 4)
    pre_flops = 2 * H * (2 * C + R) * sum(hist + t + 1 for t in range(T))
    return {
        "mla_paged_decode_attention": (dec_bytes, dec_flops),
        "mla_paged_prefill_attention": (pre_bytes, pre_flops),
    }


def mla_library_calls(torch, mi: MlaInputs) -> dict:
    """One scaled_dot_product_attention call per latent kernel over the
    latents gathered contiguous: q = [q_eff | q_pe], k = [c | pe], v = c,
    one shared kv head (timed only; the port never calls it)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.mla_attention import gather_latents

    dev = mi.cc.device

    def kv(table, S):
        c = gather_latents(mi.cc, table)[..., :S, :]
        pe = gather_latents(mi.pc, table)[..., :S, :]
        return torch.cat([c, pe], -1).unsqueeze(-3), c.unsqueeze(-3).contiguous()

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=mi.scale, enable_gqa=True)

    S = int(mi.d_lens.max())
    dk, dv = kv(mi.d_tables, S)  # [B, 1, S, C+R], [B, 1, S, C]
    dq = torch.cat([mi.qe_dec, mi.qp_dec], -1)[:, :, None]  # [B, H, 1, C+R]
    dmask = (torch.arange(S, device=dev)[None] < mi.d_lens[:, None])[:, None, None]
    hist, T = int(mi.hist), mi.qe_pre.shape[0]
    pk, pv = kv(mi.p_table, hist + T)
    pq = torch.cat([mi.qe_pre, mi.qp_pre], -1).transpose(0, 1)[None]  # [1, H, T, C+R]
    pmask = (torch.arange(hist + T, device=dev)[None]
             <= hist + torch.arange(T, device=dev)[:, None])
    # the verify's history pass: T*H rows per sequence, one shared kv head
    B, Tv, H = mi.qe_ver.shape[:3]
    vq = torch.cat([mi.qe_ver, mi.qp_ver], -1).reshape(B, Tv * H, 1, -1)
    return {
        "mla_paged_decode_attention": lambda: sdpa(dq, dk, dv, dmask),
        "mla_paged_prefill_attention": lambda: sdpa(pq, pk[None], pv[None], pmask),
        "mla_paged_decode_attention" + VERIFY: lambda: sdpa(vq, dk, dv, dmask),
    }


def spec_work(inp: KernelInputs, mi: MlaInputs, ta: TokenAppendInputs) -> dict:
    """(bytes, flops) of the speculative path's kernels on these inputs.
    The multi-token append: the new rows read and written once, the
    [B, T] page and row indices read. The verify's history pass, counted
    like :func:`work` / :func:`mla_work` with T tokens' query rows per
    sequence: queries of sequences that attend something, every output row
    and its (m, l), the cached rows attended and the table entries that
    reach them, 2 flops per multiply-add."""
    out = {}
    for width, name, cache_elem in (
            ("gqa", "kv_cache_append_tokens", 2),
            ("mla", "kv_cache_append_tokens (MLA widths)", 2),
            ("gqa", "kv_cache_append_tokens" + FP8_KV, 1)):
        k_new, v_new = ta.new[width, SPEC_GAMMA + 1]
        nbytes = (k_new.numel() + v_new.numel()) * (k_new.element_size()
                                                     + cache_elem)
        out[name] = (nbytes + 2 * ta.idx[SPEC_GAMMA + 1][0].numel() * 4, 0)
    B, T, H, D = inp.q_ver.shape
    bs = inp.bs
    lens = [int(x) for x in inp.d_lens]
    live = sum(1 for n in lens if n > 0)
    pages = sum(-(-n // bs) for n in lens)
    kv_row = inp.Hkv * D * 2 * 2
    out["paged_decode_attention" + VERIFY] = (
        live * T * H * D * 2 + B * T * H * (D * 2 + 8) + sum(lens) * kv_row
        + pages * 4 + B * 4, 4 * T * H * D * sum(lens))
    C, R = mi.C, mi.R
    Hm = mi.qe_ver.shape[2]
    lens = [int(x) for x in mi.d_lens]
    live = sum(1 for n in lens if n > 0)
    pages = sum(-(-n // mi.bs) for n in lens)
    out["mla_paged_decode_attention" + VERIFY] = (
        live * T * Hm * (C + R) * 2 + B * T * Hm * (C * 2 + 8)
        + sum(lens) * (C + R) * 2 + pages * 4 + B * 4,
        2 * T * Hm * (2 * C + R) * sum(lens))
    return out


def sdpa_backend(torch, fn) -> str:
    """Which SDPA backend PyTorch picked for ``fn``, from the kernel names
    of one profiled call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.name.lower() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    for key, backend in (("flash", "flash"), ("cudnn", "cudnn"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if key in names:
            return backend
    return "math"


def block_timing(torch, dev) -> dict:
    """Phase 4's block copies at Llama-3-8B's widths, BLOCK_PAGES real
    pages out of order: the gather and scatter of bf16 pages, the
    dequantizing scatter of int8 codes into bf16 pages (an int8 tier under
    the bf16 cache) and the requantizing scatter of e4m3 codes into the int8
    cache (an fp8 tier under it); each call's kernel, plain twin, library
    yardstick (index_select / index_copy_ on K and V, timed only; the codec
    landings have none) and (bytes, flops) moved."""
    from dynamo_tpu_torch.ops import block_copy as bc

    w = BLOCK_WIDTHS["Llama-3-8B"]
    b16 = BlockInputs(torch, dev, w, torch.bfloat16, BLOCK_PAGES, trash=False)
    i8 = BlockInputs(torch, dev, w, torch.int8, BLOCK_PAGES, trash=False)
    f8 = BlockInputs(torch, dev, w, torch.float8_e4m3fn, BLOCK_PAGES, trash=False)
    deq = (b16.kc.clone(), b16.vc.clone())
    req = i8.caches()
    idx = b16.idxs.long()
    L, n = w[0], BLOCK_PAGES
    pages = n * L * (b16.kc[0, :, 0].numel() + b16.vc[0, :, 0].numel())
    return {
        "kernel": {
            "gather_blocks": lambda: b16.gather(bc.gather_blocks),
            "scatter_blocks": lambda: b16.scatter(bc.scatter_blocks, b16.kc, b16.vc, ()),
            "scatter_blocks_dequant": lambda: i8.dequant(bc.scatter_blocks_dequant, *deq),
            "scatter_blocks_requant":
                lambda: i8.requant(bc.scatter_blocks_requant, req[0], req[1], req[2],
                                   (f8.kd, f8.vd), (f8.ks, f8.vs)),
        },
        "plain": {
            "gather_blocks": lambda: b16.gather(bc.gather_blocks_plain),
            "scatter_blocks":
                lambda: b16.scatter(bc.scatter_blocks_plain, b16.kc, b16.vc, ()),
            "scatter_blocks_dequant":
                lambda: i8.dequant(bc.scatter_blocks_dequant_plain, *deq),
            "scatter_blocks_requant":
                lambda: i8.requant(bc.scatter_blocks_requant_plain, req[0], req[1],
                                   req[2], (f8.kd, f8.vd), (f8.ks, f8.vs)),
        },
        "library": {
            "gather_blocks": lambda: (b16.kc.index_select(2, idx),
                                      b16.vc.index_select(2, idx)),
            "scatter_blocks": lambda: (b16.kc.index_copy_(2, idx, b16.kd),
                                       b16.vc.index_copy_(2, idx, b16.vd)),
        },
        # each page read once and written once (2 B a value), the index
        # vector; the codec landings read 1-byte codes and the [L, n]
        # scales, and write bf16 pages or int8 pages and plane scales
        "bounds": {
            "gather_blocks": (2 * 2 * pages + 4 * n, 0),
            "scatter_blocks": (2 * 2 * pages + 4 * n, 0),
            "scatter_blocks_dequant": (pages + 2 * pages + 8 * L * n + 4 * n,
                                       pages),
            "scatter_blocks_requant": (pages + pages + 16 * L * n + 4 * n,
                                       5 * pages),
        },
    }


def timing(torch, dev, inp: KernelInputs, mi: MlaInputs, qi: QuantInputs,
           ta: TokenAppendInputs, winp: KernelInputs, gin: KernelInputs,
           gwinp: KernelInputs, errs: dict, launches: dict) -> list:
    from dynamo_tpu_torch.ops import kv_cache_update as kvu
    from dynamo_tpu_torch.ops import mla_attention as mla
    from dynamo_tpu_torch.ops import moe_gmm
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import ragged_paged_attention as rpa

    from dynamo_tpu_torch.models.quant import to_e4m3

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    sinp = inp.scaled()
    finp = inp.fp8()
    m8 = mi.fp8()
    # fp8 copies of the append caches (ta's GQA caches are inp's)
    f_caches = (to_e4m3(inp.a_kc), to_e4m3(inp.a_vc))
    app_caches, app_planes = qi.caches.clone(), qi.scales.clone()

    def reset_planes():  # every timed call grows the same pages
        app_planes.copy_(qi.scales)

    kernel = {
        "paged_decode_attention": lambda: inp.decode(pa.paged_decode_attention),
        "paged_prefill_attention": lambda: inp.prefill(pa.paged_prefill_attention),
        "ragged_mixed_attention": lambda: inp.ragged(rpa.ragged_mixed_attention),
        "kv_cache_append": lambda: inp.append(kvu.kv_cache_append),
        "mla_paged_decode_attention": lambda: mi.decode(mla.mla_paged_decode_attention),
        "mla_paged_prefill_attention": lambda: mi.prefill(mla.mla_paged_prefill_attention),
        "ragged_int8_gmm": lambda: qi.gmm(moe_gmm.ragged_int8_gmm),
        "ragged_int8_gmm (prefill rows)":
            lambda: qi.gmm(moe_gmm.ragged_int8_gmm, "prefill"),
        "kv_cache_append_quantized":
            lambda: qi.append_in_place(kvu.append_quantized_rows, app_caches,
                                       app_planes),
        "paged_decode_attention" + INT8_KV: lambda: sinp.decode(pa.paged_decode_attention),
        "paged_prefill_attention" + INT8_KV:
            lambda: sinp.prefill(pa.paged_prefill_attention),
        "ragged_mixed_attention" + INT8_KV:
            lambda: sinp.ragged(rpa.ragged_mixed_attention),
        "kv_cache_append_tokens": lambda: ta.append(kvu.kv_cache_append_tokens),
        "kv_cache_append_tokens (MLA widths)":
            lambda: ta.append(kvu.kv_cache_append_tokens, "mla"),
        "paged_decode_attention" + VERIFY:
            lambda: inp.verify_rows(pa.paged_decode_attention),
        "mla_paged_decode_attention" + VERIFY:
            lambda: mi.verify_rows(mla.mla_paged_decode_attention),
        "paged_decode_attention" + WINDOW:
            lambda: winp.decode(pa.paged_decode_attention),
        "paged_prefill_attention" + WINDOW_SINKS:
            lambda: winp.prefill(pa.paged_prefill_attention),
        "ragged_mixed_attention" + WINDOW_SINKS:
            lambda: winp.ragged(rpa.ragged_mixed_attention),
        "paged_decode_attention" + FP8_KV: lambda: finp.decode(pa.paged_decode_attention),
        "paged_prefill_attention" + FP8_KV:
            lambda: finp.prefill(pa.paged_prefill_attention),
        "ragged_mixed_attention" + FP8_KV:
            lambda: finp.ragged(rpa.ragged_mixed_attention),
        "kv_cache_append" + FP8_KV: lambda: inp.append(kvu.kv_cache_append, *f_caches),
        "kv_cache_append_tokens" + FP8_KV:
            lambda: ta.append(kvu.kv_cache_append_tokens, caches=f_caches),
        "mla_paged_decode_attention" + FP8_KV:
            lambda: m8.decode(mla.mla_paged_decode_attention),
        "mla_paged_prefill_attention" + FP8_KV:
            lambda: m8.prefill(mla.mla_paged_prefill_attention),
        "kv_cache_append (MLA widths, fp8 KV)": lambda: m8.append(kvu.kv_cache_append),
        # Gemma-3-12B's heads (D = 256), bf16 pages, unwindowed and with its
        # 1024-token window
        "paged_decode_attention" + WIDE: lambda: gin.decode(pa.paged_decode_attention),
        "paged_prefill_attention" + WIDE:
            lambda: gin.prefill(pa.paged_prefill_attention),
        "ragged_mixed_attention" + WIDE:
            lambda: gin.ragged(rpa.ragged_mixed_attention),
        "kv_cache_append" + WIDE: lambda: gin.append(kvu.kv_cache_append),
        "paged_decode_attention" + WIDE_WINDOW:
            lambda: gwinp.decode(pa.paged_decode_attention),
        "paged_prefill_attention" + WIDE_WINDOW:
            lambda: gwinp.prefill(pa.paged_prefill_attention),
        "ragged_mixed_attention" + WIDE_WINDOW:
            lambda: gwinp.ragged(rpa.ragged_mixed_attention),
    }
    plain = {
        "paged_decode_attention": lambda: inp.decode(pa.paged_decode_attention_plain),
        "paged_prefill_attention": lambda: inp.prefill(pa.paged_prefill_attention_plain),
        "ragged_mixed_attention": lambda: inp.ragged(rpa.ragged_mixed_attention_plain),
        "kv_cache_append": lambda: inp.append(kvu.kv_cache_append_plain),
        "mla_paged_decode_attention":
            lambda: mi.decode(mla.mla_paged_decode_attention_plain),
        "mla_paged_prefill_attention":
            lambda: mi.prefill(mla.mla_paged_prefill_attention_plain),
        "ragged_int8_gmm": lambda: qi.gmm(moe_gmm.ragged_int8_plain),
        "ragged_int8_gmm (prefill rows)":
            lambda: qi.gmm(moe_gmm.ragged_int8_plain, "prefill"),
        "kv_cache_append_quantized":
            lambda: qi.append_in_place(kvu.append_quantized_rows_plain,
                                       app_caches, app_planes),
        "paged_decode_attention" + INT8_KV:
            lambda: sinp.decode(pa.paged_decode_attention_plain),
        "paged_prefill_attention" + INT8_KV:
            lambda: sinp.prefill(pa.paged_prefill_attention_plain),
        "ragged_mixed_attention" + INT8_KV:
            lambda: sinp.ragged(rpa.ragged_mixed_attention_plain),
        "kv_cache_append_tokens":
            lambda: ta.append(kvu.kv_cache_append_tokens_plain),
        "kv_cache_append_tokens (MLA widths)":
            lambda: ta.append(kvu.kv_cache_append_tokens_plain, "mla"),
        "paged_decode_attention" + VERIFY:
            lambda: inp.verify_rows(pa.paged_decode_attention_plain),
        "mla_paged_decode_attention" + VERIFY:
            lambda: mi.verify_rows(mla.mla_paged_decode_attention_plain),
        "paged_decode_attention" + WINDOW:
            lambda: winp.decode(pa.paged_decode_attention_plain),
        "paged_prefill_attention" + WINDOW_SINKS:
            lambda: winp.prefill(pa.paged_prefill_attention_plain),
        "ragged_mixed_attention" + WINDOW_SINKS:
            lambda: winp.ragged(rpa.ragged_mixed_attention_plain),
        "paged_decode_attention" + FP8_KV:
            lambda: finp.decode(pa.paged_decode_attention_plain),
        "paged_prefill_attention" + FP8_KV:
            lambda: finp.prefill(pa.paged_prefill_attention_plain),
        "ragged_mixed_attention" + FP8_KV:
            lambda: finp.ragged(rpa.ragged_mixed_attention_plain),
        "kv_cache_append" + FP8_KV:
            lambda: inp.append(kvu.kv_cache_append_plain, *f_caches),
        "kv_cache_append_tokens" + FP8_KV:
            lambda: ta.append(kvu.kv_cache_append_tokens_plain, caches=f_caches),
        "mla_paged_decode_attention" + FP8_KV:
            lambda: m8.decode(mla.mla_paged_decode_attention_plain),
        "mla_paged_prefill_attention" + FP8_KV:
            lambda: m8.prefill(mla.mla_paged_prefill_attention_plain),
        "kv_cache_append (MLA widths, fp8 KV)":
            lambda: m8.append(kvu.kv_cache_append_plain),
        "paged_decode_attention" + WIDE:
            lambda: gin.decode(pa.paged_decode_attention_plain),
        "paged_prefill_attention" + WIDE:
            lambda: gin.prefill(pa.paged_prefill_attention_plain),
        "ragged_mixed_attention" + WIDE:
            lambda: gin.ragged(rpa.ragged_mixed_attention_plain),
        "kv_cache_append" + WIDE: lambda: gin.append(kvu.kv_cache_append_plain),
        "paged_decode_attention" + WIDE_WINDOW:
            lambda: gwinp.decode(pa.paged_decode_attention_plain),
        "paged_prefill_attention" + WIDE_WINDOW:
            lambda: gwinp.prefill(pa.paged_prefill_attention_plain),
        "ragged_mixed_attention" + WIDE_WINDOW:
            lambda: gwinp.ragged(rpa.ragged_mixed_attention_plain),
    }
    scaled_library = {k + INT8_KV: f for k, f in
                      library_calls(torch, sinp.dequantized()).items()
                      if k + INT8_KV in KERNELS}
    # SDPA over the fp8 pages widened to bf16 (outside the span); the fp8
    # appends have none (no one PyTorch call casts with the reference's
    # overflow and scatters)
    fp8_library = {k + FP8_KV: f for k, f in
                   library_calls(torch, finp.widened()).items()
                   if k + FP8_KV in KERNELS and not k.startswith("kv_cache")}
    wide_library = {k + WIDE: f for k, f in library_calls(torch, gin).items()
                    if k + WIDE in KERNELS}
    # SDPA over the fp8 latent pages widened to bf16 (outside the span)
    mla_fp8_library = {k + FP8_KV: f for k, f in
                       mla_library_calls(torch, m8.widened()).items()
                       if k + FP8_KV in KERNELS}
    library = {**library_calls(torch, inp), **mla_library_calls(torch, mi),
               **scaled_library, **quant_library_calls(torch, qi),
               "kv_cache_append_tokens": ta.index_put("gqa"),
               "kv_cache_append_tokens (MLA widths)": ta.index_put("mla"),
               **window_library_calls(torch, winp), **fp8_library,
               **wide_library, **mla_fp8_library,
               **window_library_calls(torch, gwinp, (WIDE_WINDOW, WIDE_WINDOW))}
    L8, B8 = m8.c_new.shape[:2]
    bounds = {**work(inp), **mla_work(mi), **work(sinp), **quant_work(torch, qi),
              **spec_work(inp, mi, ta), **window_work(winp), **work(finp),
              **work(gin, WIDE), **window_work(gwinp, (WIDE_WINDOW, WIDE_WINDOW)),
              **{k + FP8_KV: v for k, v in mla_work(m8).items()},
              # the bf16 rows read once, their codes written once, the slots
              "kv_cache_append (MLA widths, fp8 KV)": (
                  (m8.c_new.numel() + m8.pe_new.numel()) * 3 + B8 * 4 * 2, 0)}
    blocks = block_timing(torch, dev)
    kernel.update(blocks["kernel"])
    plain.update(blocks["plain"])
    library.update(blocks["library"])
    bounds.update(blocks["bounds"])
    setups = {"kv_cache_append_quantized": reset_planes}
    # the floor of every row: an empty kernel (a spin of 0 cycles) under
    # the same flush and spin
    floor_ms = time_ms(torch, lambda: torch.cuda._sleep(0), 30, flush)
    log(f"  empty launch (torch.cuda._sleep(0)): {floor_ms:.4f} ms")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        nbytes, flops = bounds[name]
        b_ms, b_by = bound_ms(nbytes, flops)
        setup = setups.get(name)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": time_ms(torch, kernel[name], 30, flush, setup),
            "plain_ms": time_ms(torch, plain[name], 5, flush, setup),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": (time_ms(torch, library[name], 10, flush)
                           if name in library else None),
        }
        extra = ""
        if name.startswith("mla_") and name in library:
            extra = f", SDPA backend {sdpa_backend(torch, library[name])}"
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        log(f"  {name}: {row['ms']:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"plain {row['plain_ms']:.3f} ms, library {lib}{extra})")
        rows.append(row)
    # the append at MLA widths (all 27 layers of c_kv / k_pe, B=8): its own
    # line, the kernels line keeps one row per kernel
    L, B = mi.c_new.shape[:2]
    a_bytes = 2 * (mi.c_new.numel() + mi.pe_new.numel()) * 2 + B * 4 * 2
    a_ms, a_by = bound_ms(a_bytes, 0)
    idx = (mi.a_blk.long(), mi.a_off.long())
    cvals = mi.c_new.permute(0, 2, 1, 3).contiguous()
    pvals = mi.pe_new.permute(0, 2, 1, 3).contiguous()

    def index_put():
        mi.a_kc[:, :, idx[0], idx[1]] = cvals
        mi.a_vc[:, :, idx[0], idx[1]] = pvals

    log(f"  kv_cache_append at MLA widths (L={L}, B={B}, C={mi.C}, R={mi.R}): "
        f"{time_ms(torch, lambda: mi.append(kvu.kv_cache_append), 30, flush):.4f} ms "
        f"(bound {a_ms:.4f} ms by {a_by}, plain "
        f"{time_ms(torch, lambda: mi.append(kvu.kv_cache_append_plain), 5, flush):.3f}"
        f" ms, library {time_ms(torch, index_put, 10, flush):.4f} ms)")
    # the decode rows at the down projection's shape (K = 1408, N = 2048)
    d_ms, d_by = bound_ms(*gmm_work(qi, "decode", "down"))
    log("  ragged_int8_gmm decode rows, down shape (K=1408, N=2048, "
        f"{int(qi.rows['decode'][1].sum())} rows): "
        f"{time_ms(torch, lambda: qi.gmm(moe_gmm.ragged_int8_gmm, proj='down'), 30, flush):.4f}"
        f" ms (bound {d_ms:.4f} ms by {d_by}, plain "
        f"{time_ms(torch, lambda: qi.gmm(moe_gmm.ragged_int8_plain, proj='down'), 5, flush):.3f}"
        " ms, library "
        f"{time_ms(torch, grouped_mm_call(torch, qi, 'decode', 'down'), 10, flush):.4f} ms)")
    # the latent kernels' CUDA-core body, at phase 2's shapes: bf16 at
    # C = 1024, R = 64, wider than the tensor-core tiles (C.8), and f32 at
    # V2-Lite's widths (the body of the f32 models)
    wide = MlaInputs(torch, dev, C=1024, R=64)
    for label, inputs in (("C=1024, R=64, bf16", wide),
                          ("C=1024, R=64, fp8 pages", wide.fp8()),
                          ("C=512, R=64, f32",
                           MlaInputs(torch, dev, dtype=torch.float32))):
        # the yardstick: SDPA over the same latents gathered and widened
        # contiguous, as at the tensor-core widths (timed only)
        lib = mla_library_calls(
            torch, inputs.widened() if "fp8" in label else inputs)
        for name, fn, plain_fn in (
                ("mla_paged_decode_attention", mla.mla_paged_decode_attention,
                 mla.mla_paged_decode_attention_plain),
                ("mla_paged_prefill_attention", mla.mla_paged_prefill_attention,
                 mla.mla_paged_prefill_attention_plain)):
            call = inputs.decode if "decode" in name else inputs.prefill
            w_ms, w_by = bound_ms(*mla_work(inputs)[name],
                                  F32_FLOPS if "f32" in label else BF16_FLOPS)
            log(f"  {name} at {label} (CUDA-core body): "
                f"{time_ms(torch, lambda: call(fn), 10, flush):.4f} ms (bound "
                f"{w_ms:.4f} ms by {w_by}, plain "
                f"{time_ms(torch, lambda: call(plain_fn), 3, flush):.3f} ms, "
                f"library {time_ms(torch, lib[name], 5, flush):.4f} ms, SDPA "
                f"backend {sdpa_backend(torch, lib[name])})")
        del lib
        del inputs
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from dynamo_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the dynamo_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi_line()
    t_all = time.perf_counter()
    log(f"[1/4] environment: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    build_s = _cuda.build_all()
    log(f"  kernel build: {build_s:.1f} s ({len(_cuda.SOURCES)} sources in parallel)")
    for src, text in _cuda.build_logs().items():
        for entry, regs, spills in ptxas_entries(text):
            log(f"  {src}: {entry}: {regs} registers, spill stores / loads "
                f"{spills} bytes")
    log(f"[2/4] at {time.perf_counter() - t_all:.1f} s: kernels against their "
        "plain versions (Llama-3-8B and "
        "DeepSeek-V2-Lite shapes, bf16)")
    inp = KernelInputs(torch, dev)
    errs = check_kernels(torch, dev, inp)
    check_e4m3_store(torch, dev)
    check_odd_group(torch, dev)
    check_decode_rows(torch, inp)
    check_moe_deterministic(torch, dev)
    mi = MlaInputs(torch, dev)
    errs.update(check_mla_kernels(torch, mi))
    check_mla_widths(torch, dev)
    ta = TokenAppendInputs(torch, dev, inp, mi)
    errs.update(check_spec_kernels(torch, inp, mi, ta))
    errs.update(check_mla_fp8(torch, dev, mi, ta))
    # gpt-oss-20b's attention shapes with its sliding window and sinks
    winp = KernelInputs(torch, dev, H=64, Hkv=8, D=64, window=GPTOSS_WINDOW,
                        sinks=True)
    errs.update(check_windowed(torch, winp, card))
    # Gemma-3-12B's head width (and D=192): the wide kernels' library
    wide_errs, gin, gwinp = check_wide_heads(torch, dev, card)
    errs.update(wide_errs)
    for label, cfg, quantization, kv in tiny_models():
        check_model_on_card(torch, dev, label, cfg, quantization, kv)
        if quantization == "none" and kv is None:
            check_verify_on_card(torch, dev, label, cfg)
    check_engine_spec_on_card(torch, dev)
    qi = QuantInputs(torch, dev)
    errs.update(check_quant_kernels(torch, qi))
    check_gmm_tiles(torch, dev)
    check_int8_native_mm(torch, dev)
    errs.update(check_block_copy(torch, dev))
    log(f"[3/4] at {time.perf_counter() - t_all:.1f} s: serving over HTTP: "
        "llama3-8b-sim twice on fresh engines, deepseek-v2-lite-sim, "
        "deepseek-v2-lite-sim (int8 weights), deepseek-v2-lite-sim (fp8 KV), "
        "llama3-8b-sim (fp8 weights, int8 KV), llama3-8b-sim (fp8 KV, "
        f"spec_gamma={SPEC_GAMMA}), llama3-8b-sim and "
        f"deepseek-v2-lite-sim (spec_gamma={SPEC_GAMMA}), qwen2.5-7b-sim, "
        f"qwen3-8b-sim, a {CHECKPOINT_LAYERS}-layer Mistral-7B-v0.2 "
        f"checkpoint through dynamo_run --model-path, {GPTOSS_DRIVE}, "
        f"{GEMMA_DRIVE}, a distributed {FLEET_MODEL} fleet with a peer pull, "
        f"migration and drain, and disaggregated {DISAGG_MODEL} prefill and "
        "decode workers")
    launches, plain = {}, {}
    for name, cfg, geometry, counted in drives():
        log(f"  drive {name} from {time.perf_counter() - t_all:.1f} s")
        if name == CHECKPOINT_DRIVE:
            got = asyncio.run(serve_checkpoint(torch, dev, card, cfg, counted))
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
            continue
        # the first (bf16) drive of the Llama and V2-Lite models runs
        # twice, the second time on a fresh engine (C.4)
        for repeat in ((False, True) if name in REPEATED and name not in plain
                       else (False,)):
            got, answers = asyncio.run(serve(
                torch, dev, card, name, cfg, geometry, counted,
                plain.get(name), repeat=repeat,
                oracle=name in ("qwen2.5-7b-sim", "qwen3-8b-sim")))
            plain.setdefault(name, answers)
            # a kernel shared by several drives (the append) counts them all
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
    log(f"  drive: the host and disk KV tiers ({TIER_MODEL}: "
        f"{', '.join(v[0] for v in TIER_VARIANTS)}) from "
        f"{time.perf_counter() - t_all:.1f} s")
    for k, n in asyncio.run(tier_drive(torch, dev, card)).items():
        launches[k] = launches.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  drive: the distributed fleet ({FLEET_MODEL}: hub, two workers, a "
        f"KV-routed frontend) from {time.perf_counter() - t_all:.1f} s")
    for k, n in asyncio.run(fleet_drive(torch, dev, card)).items():
        launches[k] = launches.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  drive: the disaggregated roles ({DISAGG_MODEL}: hub, a prefill and a "
        f"decode worker, a frontend; {', '.join(v[0] for v in DISAGG_VARIANTS)}) "
        f"from {time.perf_counter() - t_all:.1f} s")
    for k, n in asyncio.run(disagg_drive(torch, dev, card)).items():
        launches[k] = launches.get(k, 0) + n
    log(f"[4/4] at {time.perf_counter() - t_all:.1f} s: timing (median per "
        "launch, L2 flushed)  [" + card + "]")
    rows = timing(torch, dev, inp, mi, qi, ta, winp, gin, gwinp, errs, launches)
    torch.cuda.synchronize()
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
