#!/usr/bin/env python3
"""Drive the PyTorch port (dynamo_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, the way to check the port

Phases, in order; any failure raises and the script exits non-zero:

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the build of every CUDA kernel from csrc/ (one
     nvcc per source, in parallel) with its ptxas register report;
  2. kernel vs plain: each kernel entry point against its plain PyTorch
     version on the same inputs, the GQA kernels at the Llama-3-8B shapes
     (H=32, Hkv=8, D=128, bs=16, bf16) and the MLA latent kernels at the
     DeepSeek-V2-Lite shapes (H=16, C=512, R=64, bs=16, bf16); attention
     outputs within atol=rtol=2e-2 (bf16 output, sums in another order),
     (m, l) within rtol=1e-3 (f32, the order of the sums only), the KV
     append bit-exact at both the GQA and the MLA widths; plus two tiny
     models (dense GQA, and MLA + MoE) through prefill / mixed step /
     decode window on the card against the same functions on the CPU
     (f32, TF32 off);
  3. serving: the port's OpenAI HTTP service in-process, first on
     llama3-8b-sim, then (after its memory is freed) on
     deepseek-v2-lite-sim (random weights from a seed, byte tokenizer,
     full width and depth) at the reference defaults — one request alone
     (the dedicated prefill), then several more of 64-1500 bytes while it
     decodes (fused mixed steps), one of them a streaming chat; every
     response must be 200 and non-empty, and every kernel of the model's
     path, its launch counter zeroed just before the drive, must have
     launched;
  4. timing: median time per launch of each kernel with L2 flushed
     between launches, its plain version's and a library yardstick's
     (scaled_dot_product_attention / index_put_, timed only, never used by
     the port), and the least time the card could take (bytes over
     3.35 TB/s or operations over 989 TFLOP/s, from this run's inputs).

The second-to-last lines are the ``{"kernels": [...]}`` JSON and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside this file, it prints no result and exits non-zero.
"""

from __future__ import annotations

import asyncio
import gc
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak

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
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------- phase 2: kernels against their plain versions ----------------


class KernelInputs:
    """Synthetic paged caches and queries at the Llama-3-8B shapes."""

    def __init__(self, torch, dev):
        self.torch = torch
        g = torch.Generator(device=dev).manual_seed(0)
        self.H, self.Hkv, self.D, self.bs = 32, 8, 128, 16
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

    # one call of each entry point, kernel or plain
    def decode(self, fn):
        return fn(self.q_dec, self.kc, self.vc, self.d_tables, self.d_lens,
                  self.scale, return_stats=True)

    def prefill(self, fn):
        return fn(self.q_pre, self.kc, self.vc, self.p_table, self.hist, self.scale)

    def ragged(self, fn):
        return fn(self.q_dec, self.q_chunks, self.kc, self.vc, self.d_tables,
                  self.d_lens, self.r_tables, self.r_hists, self.r_valids,
                  self.scale)

    # (m, l) of a prefill / ragged launch against the plain softmax
    # statistics: o within 2e-2 cannot tell a dropped page or a causal edge
    # moved by a few positions from bf16 rounding; l at rtol 1e-3 can
    def launch_stats(self, q, T, **tables):
        from dynamo_tpu_torch.ops import paged_attention as pa

        G = self.H // self.Hkv
        _, m, l = pa.launch_paged_attention(
            q.reshape(-1, self.Hkv, G, self.D), self.kc, self.vc, self.scale,
            T=T, Tq=pa.prefill_q_tile(G), stats=True, **tables)
        return m, l

    def plain_stats(self, q, table, limit):
        """Rows ``q [R, H, D]`` through ``table`` ([M] shared or [R, M]),
        row r attending positions ``0..limit[r]``."""
        from dynamo_tpu_torch.ops import paged_attention as pa

        k, v = pa.gather_pages(self.kc, table), pa.gather_pages(self.vc, table)
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


class MlaInputs:
    """Synthetic latent caches and queries at the DeepSeek-V2-Lite shapes:
    H=16 heads, kv_lora_rank C=512, rope dims R=64, bs=16, the model's own
    softmax scale; decode B=8 over lengths up to 2048 with one empty slot,
    prefill T=512 on 1000 cached tokens, the append over all 27 layers."""

    def __init__(self, torch, dev):
        from dynamo_tpu_torch.models.config import deepseek_v2_lite

        self.torch = torch
        g = torch.Generator(device=dev).manual_seed(1)
        cfg = deepseek_v2_lite()
        self.H, self.C, self.R, self.bs = (cfg.num_heads, cfg.kv_lora_rank,
                                           cfg.qk_rope_head_dim, 16)
        self.M, self.N = 128, 2048
        self.scale = cfg.mla_softmax_scale()
        H, C, R, bs, M, N = self.H, self.C, self.R, self.bs, self.M, self.N

        def randn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

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

    def decode(self, fn):
        return fn(self.qe_dec, self.qp_dec, self.cc, self.pc, self.d_tables,
                  self.d_lens, self.scale, return_stats=True)

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


def check_kernels(torch, dev, inp: KernelInputs) -> dict:
    from dynamo_tpu_torch.ops import kv_cache_update as kvu
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import ragged_paged_attention as rpa

    errs = {}
    o, m, l = inp.decode(pa.paged_decode_attention)
    ro, rm, rl = inp.decode(pa.paged_decode_attention_plain)
    torch.cuda.synchronize()
    errs["paged_decode_attention"] = close("decode o", o, ro, 2e-2, 2e-2)
    close_stats("decode", (m, l), (rm, rl))
    if not (bool((o[7] == 0).all()) and bool((m[7] == -1e30).all())
            and bool((l[7] == 0).all())):
        raise AssertionError("decode: the empty slot must give o=0, m=-1e30, l=0")
    got = inp.prefill(pa.paged_prefill_attention)
    ref = inp.prefill(pa.paged_prefill_attention_plain)
    torch.cuda.synchronize()
    errs["paged_prefill_attention"] = close("prefill", got, ref, 2e-2, 2e-2)
    close_stats("prefill", *inp.prefill_stats())
    got = inp.ragged(rpa.ragged_mixed_attention)
    ref = inp.ragged(rpa.ragged_mixed_attention_plain)
    torch.cuda.synchronize()
    errs["ragged_mixed_attention"] = max(
        close("ragged decode rows", got[0], ref[0], 2e-2, 2e-2),
        close("ragged segments", got[1], ref[1], 2e-2, 2e-2),
    )
    close_stats("ragged", *inp.ragged_stats())
    kc, vc = inp.a_kc.clone(), inp.a_vc.clone()
    inp.append(kvu.kv_cache_append, kc, vc)
    inp.append(kvu.kv_cache_append_plain)
    torch.cuda.synchronize()
    if not (torch.equal(kc, inp.a_kc) and torch.equal(vc, inp.a_vc)):
        raise AssertionError("kv_cache_append: not bit-exact with index_put_")
    errs["kv_cache_append"] = 0.0
    for name, e in errs.items():
        log(f"  {name}: kernel vs plain max |err| {e:.3e}  OK")
    return errs


def tiny_models():
    """(label, config) of the two tiny models held on the card to the CPU:
    dense GQA, and MLA (q-lora, the kernel's R=64 and smallest C=128) with
    one dense layer then MoE (8 experts top-2, one shared)."""
    from dynamo_tpu_torch.models.config import ModelConfig

    return [
        ("tiny GQA", ModelConfig.tiny(dtype="float32", head_dim=64, num_heads=8,
                                      num_kv_heads=2, hidden_size=128)),
        ("tiny MLA+MoE", ModelConfig.tiny_mla(
            dtype="float32", kv_lora_rank=128, qk_rope_head_dim=64,
            num_layers=3, first_dense_layers=1, num_experts=8,
            num_experts_per_tok=2, num_shared_experts=1,
            moe_intermediate_size=32)),
    ]


def check_model_on_card(torch, dev, label, cfg):
    """A tiny model's three main-path functions on the card (kernels)
    against the same functions on the CPU (plain versions), f32."""
    from dynamo_tpu_torch.models import llama

    params = llama.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    # weights x5 (std 0.1): decisive logits and expert routing, so a token
    # or an expert choice is never a near-tie that the sum order can flip
    params = {k: ({kk: vv * (5.0 if vv.dim() > 1 else 1.0) for kk, vv in v.items()}
                  if isinstance(v, dict) else v * (5.0 if v.dim() > 1 else 1.0))
              for k, v in params.items()}
    gparams = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                   else v.to(dev)) for k, v in params.items()}
    kc, vc = llama.init_kv_cache(cfg, 64, 16)
    gkc, gvc = kc.to(dev), vc.to(dev)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (64,), generator=gen, dtype=torch.int32)
    table = torch.arange(1, 9, dtype=torch.int32)
    lc, _, _ = llama.prefill(params, cfg, toks, table, 0, 50, kc, vc)
    lg, _, _ = llama.prefill(gparams, cfg, toks.to(dev), table.to(dev), 0, 50,
                             gkc, gvc)
    err = float((lg.cpu() - lc).abs().max())
    if not (bool(torch.isfinite(lg).all()) and err < 1e-3):
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
    for where, p, k, v in (("cpu", params, kc, vc), (dev, gparams, gkc, gvc)):
        mv = lambda t: t.to(where)  # noqa: E731
        nxt, pl, _, _ = llama.mixed_step(
            p, cfg, *map(mv, args), z["seeds"], z["steps"], *map(mv, samp),
            *map(mv, pre), k, v)
        toks_w = llama.decode_window(
            p, cfg, nxt, mv(d_lens), mv(d_tables), mv(d_lens + 1),
            z["seeds"], z["steps"], *map(mv, samp), k, v, n_steps=3)[0]
        outs.append((nxt.cpu(), pl.cpu(), toks_w.cpu()))
    (n0, p0, w0), (n1, p1, w1) = outs
    perr = float((p1 - p0).abs().max())
    if not (torch.equal(n0, n1) and torch.equal(w0[:, 0], w1[:, 0]) and perr < 1e-3):
        raise AssertionError(
            f"{label} mixed step / decode window on the card disagree with the "
            f"CPU: tokens {n1.tolist()} vs {n0.tolist()}, windows "
            f"{w1[:, 0].tolist()} vs {w0[:, 0].tolist()}, max |dlogit| {perr}"
        )
    log(f"  {label} on the card vs CPU: prefill max |dlogit| {err:.2e}, "
        f"mixed-step max |dlogit| {perr:.2e}, tokens equal  OK")


# ---------------- phase 3: serving llama3-8b-sim over HTTP ----------------


async def http_request(port: int, path: str, body: dict):
    """POST ``body``; returns (status, text, token event times). For a
    streaming request the times are when each SSE event with text
    arrived."""
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
    times, text = [], ""
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


def drives():
    """The serving drives in order: (served name, config, engine geometry,
    the kernel wrappers the model's path must launch)."""
    from dynamo_tpu_torch.models.config import ModelConfig, deepseek_v2_lite
    from dynamo_tpu_torch.ops.kv_cache_update import kv_cache_append
    from dynamo_tpu_torch.ops.mla_attention import (
        mla_paged_decode_attention,
        mla_paged_prefill_attention,
    )
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_prefill_attention,
    )
    from dynamo_tpu_torch.ops.ragged_paged_attention import ragged_mixed_attention

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
        ("deepseek-v2-lite-sim", deepseek_v2_lite(),
         dict(num_blocks=4096, block_size=16, max_batch_size=8, decode_window=4,
              max_context=8192),
         {"mla_paged_decode_attention": mla_paged_decode_attention,
          "mla_paged_prefill_attention": mla_paged_prefill_attention,
          "kv_cache_append": kv_cache_append}),
    ]


async def serve(torch, dev, card: str, name: str, cfg, geometry: dict,
                counted: dict) -> dict:
    """One serving drive of ``name`` over HTTP; returns the launch count of
    each kernel of its path during the drive (counters zeroed just
    before it)."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.http import HttpService, ModelManager
    from dynamo_tpu_torch.llm import ByteTokenizer
    from dynamo_tpu_torch.llm.openai_engine import OpenAIWorkerEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.weights import init_random_params

    t0 = time.perf_counter()
    params = init_random_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    engine = TorchEngine(EngineConfig(model=cfg, **geometry), params=params,
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    log(f"  {name}: {n_params / 1e9:.2f}B params, {cfg.num_layers} layers, KV "
        f"pool {(engine.k_cache.nbytes + engine.v_cache.nbytes) / 2**30:.2f} "
        f"GiB, ready in {time.perf_counter() - t0:.3f} s")
    manager = ModelManager()
    worker = OpenAIWorkerEngine(ByteTokenizer(), engine)
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

    for f in counted.values():
        f.launches = 0
    try:
        t_start = time.perf_counter()
        # one request alone: the dedicated prefill program
        first = asyncio.create_task(http_request(svc.port, *completion(1200, True)))
        while engine.stats["tokens_generated"] < 2 and not first.done():
            await asyncio.sleep(0.01)
        # more while it decodes: fused mixed steps
        more = [completion(n, n % 2 == 0) for n in (64, 333, 700, 1100, 1500)]
        more.append(("/v1/chat/completions", {
            "model": name, "max_tokens": 32, "temperature": 0.0,
            "stream": True, "nvext": {"ignore_eos": True},
            "messages": [{"role": "user", "content": "Describe paged attention. " * 8}],
        }))
        results = [await first] + list(await asyncio.gather(
            *[http_request(svc.port, p, b) for p, b in more]))
        wall = time.perf_counter() - t_start
    finally:
        await svc.close()
        await engine.close()
    launches = {k: f.launches for k, f in counted.items()}
    for i, (status, text, times) in enumerate(results):
        if status != 200 or not text:
            raise AssertionError(f"{name} request {i}: status {status}, text {text!r}")
    streamed = [t for _s, _x, t in results if len(t) > 1]
    ttft = [t[0] * 1e3 for t in streamed]
    # per request: the mean gap from its first to its last text event (a
    # decode window emits its tokens together, so single gaps are bursty)
    itl = [(t[-1] - t[0]) * 1e3 / (len(t) - 1) for t in streamed]
    tokens = engine.stats["tokens_generated"]
    log(f"  {len(results)} requests answered 200 with text; engine: "
        f"{engine.stats['prefill_chunks']} dedicated prefill chunks, "
        f"{engine.stats['mixed_steps']} mixed steps, "
        f"{engine.stats['decode_windows']} decode windows "
        f"({engine.stats['decode_steps']} decode steps)")
    log(f"  TTFT ms (streamed requests): {[round(x, 1) for x in ttft]}; "
        f"ITL (per request, mean) median {statistics.median(itl):.2f} ms; "
        f"{tokens} tokens in "
        f"{wall:.2f} s = {tokens / wall:.1f} tok/s  [{name}, {card}]")
    log(f"  launches during serving: {launches}")
    missing = [k for k, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched while serving: {missing}")
    # what comes out of the big model is finite and of the expected shape
    kc, vc = llama.init_kv_cache(cfg, 8, 16, device=dev)
    toks = torch.arange(100, 164, dtype=torch.int32, device=dev)
    logits, _, _ = llama.prefill(params, cfg, toks, torch.arange(
        1, 8, dtype=torch.int32, device=dev), 0, 64, kc, vc)
    if logits.shape != (cfg.vocab_size,) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} prefill logits not finite [V]")
    step_anatomy(torch, dev, params, cfg, engine.k_cache, engine.v_cache)
    return launches


def anatomy(torch, label: str, fn, n: int) -> None:
    """Wall time of ``fn`` per step (``n`` steps per call, profiler off),
    the host syncs it makes (CUDA sync debug mode: each call that waits
    for the card, such as ``.tolist()`` of a device tensor), then under
    torch.profiler the card's kernel time, launch count and the three
    kernels that take most of it: how much of a step the card is busy, and
    with what."""
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
    by_name = defaultdict(float)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in kernels:
        by_name[e.name] += e.device_time_total / 1e3 / n
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    log(f"  {label}: {wall:.2f} ms wall per step, {busy:.2f} ms of kernels "
        f"({busy / wall:.0%} busy), {len(kernels) / n:.0f} kernel launches "
        f"and {syncs / n:.2f} host syncs per step; top: "
        + "; ".join(f"{k[:48]} {v:.2f} ms" for k, v in top))


def step_anatomy(torch, dev, params, cfg, k_cache, v_cache) -> None:
    """A 4-step decode window (B=8 at ~1k context) and a lone prompt's
    dedicated prefill (1201 tokens in the 2048 bucket) of the served model
    on its serving cache."""
    from dynamo_tpu_torch.models import llama

    B = 8
    tables = torch.arange(1, 1 + B * 80, dtype=torch.int32, device=dev).reshape(B, 80)
    lens = torch.arange(1000, 1000 + B, dtype=torch.int32, device=dev)
    toks = torch.arange(300, 300 + B, dtype=torch.int32, device=dev)
    samp = (torch.zeros(B, device=dev), torch.zeros(B, dtype=torch.int32, device=dev),
            torch.ones(B, device=dev))
    anatomy(torch, "decode step (B=8, ~1k context)", lambda: llama.decode_window(
        params, cfg, toks, lens - 1, tables, lens, [0] * B, [0] * B, *samp,
        k_cache, v_cache, n_steps=4), 4)
    prompt = torch.zeros(2048, dtype=torch.int32, device=dev)
    prompt[:1201] = torch.arange(1201, device=dev) % 250 + 3
    table = torch.arange(700, 828, dtype=torch.int32, device=dev)
    anatomy(torch, "dedicated prefill (1201 tokens, 2048 bucket)",
            lambda: llama.prefill(params, cfg, prompt, table, 0, 1201,
                                  k_cache, v_cache), 1)


# ---------------- phase 4: timing ----------------


def time_ms(torch, fn, reps: int, flush) -> float:
    """Median ms per call, L2 flushed before each (CUDA events). A
    device-side spin after the flush keeps the card busy while the host
    enqueues the call, so the time of a kernel or of a library call of a
    few ops excludes the host's launch path (a plain version's many small
    ops still pay their host gaps)."""
    fn()
    fn()
    times = []
    for _ in range(reps):
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


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
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

    return {
        "paged_decode_attention": lambda: sdpa(dq, dk, dv, dmask),
        "paged_prefill_attention": lambda: sdpa(*pre),
        "ragged_mixed_attention": ragged,
        "kv_cache_append": append,
    }


def work(inp: KernelInputs) -> dict:
    """(bytes, flops) each kernel must move/compute on these inputs: each
    input it needs read once, each output written once. Counted from this
    run's data: only the queries of rows that attend something, the cached
    positions they attend and the table entries that reach them."""
    H, Hkv, D, bs = inp.H, inp.Hkv, inp.D, inp.bs
    kv_row = Hkv * D * 2 * 2  # K and V bytes of one position
    q_row = H * D * 2  # one token's queries (read) or output (written)

    def pages(n):  # table entries read to reach n positions
        return -(-n // bs)

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
    app_bytes = 2 * (inp.k_new.numel() * 2) * 2 + 8 * 4 * 2
    return {
        "paged_decode_attention": (dec_bytes + dec_stats, dec_flops),
        "paged_prefill_attention": (pre_bytes, pre_flops),
        "ragged_mixed_attention": (rag_bytes, rag_flops),
        "kv_cache_append": (app_bytes, 0),
    }


def mla_work(mi: MlaInputs) -> dict:
    """(bytes, flops) of the two latent kernels on these inputs, counted
    like :func:`work`: queries of rows that attend something, every output
    row (decode in bf16 with f32 (m, l); prefill in f32), the latent rows
    (C + R values) of the positions attended, the table entries that reach
    them; 2 flops per multiply-add of the scores (C + R) and of the value
    product (C)."""
    H, C, R, bs = mi.H, mi.C, mi.R, mi.bs
    row = (C + R) * 2  # one position's latents, bf16

    def pages(n):
        return -(-n // bs)

    lens = [int(x) for x in mi.d_lens]
    live = sum(1 for n in lens if n > 0)
    dec_bytes = (live * H * (C + R) * 2 + len(lens) * H * (C * 2 + 8)
                 + sum(lens) * row + sum(pages(n) for n in lens) * 4 + len(lens) * 4)
    dec_flops = 2 * H * (2 * C + R) * sum(lens)
    hist, T = int(mi.hist), mi.qe_pre.shape[0]
    pre_bytes = (T * H * (C + R) * 2 + T * H * C * 4 + (hist + T) * row
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
    return {
        "mla_paged_decode_attention": lambda: sdpa(dq, dk, dv, dmask),
        "mla_paged_prefill_attention": lambda: sdpa(pq, pk[None], pv[None], pmask),
    }


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


def timing(torch, dev, inp: KernelInputs, mi: MlaInputs, errs: dict,
           launches: dict) -> list:
    from dynamo_tpu_torch.ops import kv_cache_update as kvu
    from dynamo_tpu_torch.ops import mla_attention as mla
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import ragged_paged_attention as rpa

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    kernel = {
        "paged_decode_attention": lambda: inp.decode(pa.paged_decode_attention),
        "paged_prefill_attention": lambda: inp.prefill(pa.paged_prefill_attention),
        "ragged_mixed_attention": lambda: inp.ragged(rpa.ragged_mixed_attention),
        "kv_cache_append": lambda: inp.append(kvu.kv_cache_append),
        "mla_paged_decode_attention": lambda: mi.decode(mla.mla_paged_decode_attention),
        "mla_paged_prefill_attention": lambda: mi.prefill(mla.mla_paged_prefill_attention),
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
    }
    library = {**library_calls(torch, inp), **mla_library_calls(torch, mi)}
    bounds = {**work(inp), **mla_work(mi)}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        nbytes, flops = bounds[name]
        b_ms, b_by = bound_ms(nbytes, flops)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": time_ms(torch, kernel[name], 30, flush),
            "plain_ms": time_ms(torch, plain[name], 5, flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, library[name], 10, flush),
        }
        extra = ""
        if name.startswith("mla_"):
            extra = f", SDPA backend {sdpa_backend(torch, library[name])}"
        log(f"  {name}: {row['ms']:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.4f} ms"
            f"{extra})")
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
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    log("[2/4] kernels against their plain versions (Llama-3-8B and "
        "DeepSeek-V2-Lite shapes, bf16)")
    inp = KernelInputs(torch, dev)
    errs = check_kernels(torch, dev, inp)
    mi = MlaInputs(torch, dev)
    errs.update(check_mla_kernels(torch, mi))
    for label, cfg in tiny_models():
        check_model_on_card(torch, dev, label, cfg)
    log("[3/4] serving over HTTP: llama3-8b-sim, then deepseek-v2-lite-sim")
    launches = {}
    for name, cfg, geometry, counted in drives():
        got = asyncio.run(serve(torch, dev, card, name, cfg, geometry, counted))
        # a kernel shared by both paths (the append) counts both drives
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
    log("[4/4] timing (median per launch, L2 flushed)  [" + card + "]")
    rows = timing(torch, dev, inp, mi, errs, launches)
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
