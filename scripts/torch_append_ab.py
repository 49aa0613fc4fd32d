#!/usr/bin/env python3
"""A/B timing of the port's KV-append kernels on one NVIDIA GPU.

    python3 scripts/torch_append_ab.py [--parent DIR] [--other FILE] [--reps 50]

Times, in turns (parent, change, change, parent) under ``chip_smoke.py``'s
method (L2 flushed and the card held by a spin before each call, CUDA
events, median): an empty launch; the row store at Llama-3-8B's widths
(L=32, Hkv=8, D=128) and DeepSeek-V2-Lite's latent widths (L=27, C=512,
R=64), B=8, T=1 and T=4 windows crossing a page; the quantized append at
Llama's widths (B=8, two padded rows, a 256-page int8 pool), the whole
function. ``--parent`` names the root of another checkout whose
``dynamo_tpu_torch/csrc/kv_cache_append.cu`` has the row-store entry of
the same C signature and the page read-modify-write entry of the earlier
quantized append (its scale math ran in PyTorch, as
``ops/kv_cache_update.quant_scale_update`` still computes it).

``--other`` names another ``kv_cache_append.cu`` with this tree's C
interface, timed beside this tree's on the quantized append. The empty
launch and the row store are timed again with L2 flushed by reading 64 MB
instead of writing it (the lines the flush leaves are then clean, so the
timed kernel writes back none of them).

Knockouts: variants of this tree's source with one part of the fused
quantized append removed by a text substitution (built beside the real
library, never used by the port), timed on the same inputs, to say what
each part costs. Builds go to ``dynamo_tpu_torch/_build/ab``. Prints one
line per measurement, the card's name and power limit, then a JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: knockout name -> substitutions applied to this tree's source
KNOCKOUTS = {
    # the page read-modify-write skipped: rows and planes only
    "no page RMW": [("if (p != 0 && r != 1.f) {", "if (false) {")],
    # the ticket skipped: no block sums the flags
    "no ticket": [("s_last = atomicAdd(ticket, 1) == nblocks - 1;",
                   "s_last = false;")],
    # the ownership scan skipped: every block owns its row's page (wrong
    # on page 0, fine for timing)
    "no ownership scan": [("const bool owner = !__syncthreads_or(dup);",
                           "const bool owner = !__syncthreads_or(false);")],
}

_P, _I = ctypes.c_void_p, ctypes.c_int


def build(src_text: str, tag: str) -> ctypes.CDLL:
    """nvcc ``src_text`` with the port's flags into a library of its own."""
    from dynamo_tpu_torch.ops import _cuda

    out_dir = _cuda.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(src_text.encode()).hexdigest()[:12]
    src = out_dir / f"{tag}-{digest}.cu"
    lib = src.with_suffix(".so")
    if not lib.exists():
        src.write_text(src_text)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(src)],
                       check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def ptrs(*ts):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_append_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import nvidia_smi_line, time_ms
    from dynamo_tpu_torch.ops import _cuda
    from dynamo_tpu_torch.ops import kv_cache_update as kvu

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    class ReadFlush:
        """``time_ms``'s flush, by a read of the same 64 MB."""

        def zero_(self):
            flush.max()

    bs, N, B = 16, 256, 8

    # ---- the row store: (label, L, Hkv, Dk, Dv, T)
    rows = {}
    starts = torch.tensor([14, 16, 3, 29, 0, 45, 8, 0], device=dev)[:, None]
    pages = (torch.randperm(N - 1, generator=g, device=dev)[: B * 4] + 1).reshape(B, 4)
    for label, L, Hkv, Dk, Dv, T in (("GQA T=1", 32, 8, 128, 128, 1),
                                     ("MLA T=1", 27, 1, 512, 64, 1),
                                     ("GQA T=4", 32, 8, 128, 128, 4),
                                     ("MLA T=4", 27, 1, 512, 64, 4)):
        pos = starts + torch.arange(T, device=dev)[None, :]
        blk = torch.gather(pages, 1, pos // bs).to(torch.int32)
        blk[[4, 7]] = 0
        off = (pos % bs).to(torch.int32)
        kn = torch.randn(L, B, T, Hkv, Dk, generator=g, device=dev).bfloat16()
        vn = torch.randn(L, B, T, Hkv, Dv, generator=g, device=dev).bfloat16()
        kc = torch.randn(L, Hkv, N, bs, Dk, generator=g, device=dev).bfloat16()
        vc = torch.randn(L, Hkv, N, bs, Dv, generator=g, device=dev).bfloat16()
        rows[label] = (kn, vn, kc, vc, blk.contiguous(), off.contiguous())

    # ---- the quantized append (L=32, B=8, two padded rows)
    L, Hkv, D = 32, 8, 128
    pool = torch.randn(2, L, Hkv, N, bs, D, generator=g, device=dev)
    scales = (pool.abs().amax(dim=(2, 4, 5)) / 127.0).contiguous()
    caches = torch.clamp(torch.round(pool / scales[:, :, None, :, None, None]),
                         -127, 127).to(torch.int8)
    del pool
    k_new = torch.randn(L, B, Hkv, D, generator=g, device=dev).bfloat16()
    v_new = torch.randn(L, B, Hkv, D, generator=g, device=dev).bfloat16()
    qblk = torch.randperm(N - 1, generator=g, device=dev)[:B] + 1
    qblk[[2, 6]] = 0
    qblk = qblk.to(torch.int32)
    qoff = torch.randint(0, bs, (B,), generator=g, device=dev, dtype=torch.int32)
    planes = scales.clone()

    def reset():
        planes.copy_(scales)

    def fused(lib):
        """This tree's C entry (or a knockout's) with a ticket of its own
        (a knockout may leave it set) and the wrapper's flags."""
        flags = _cuda.device_buffer("append_flags", dev, 2 * L * B, torch.int32)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        n = torch.empty((), dtype=torch.int32, device=dev)

        def call():
            lib.kv_cache_append_quantized_launch(
                *ptrs(k_new, v_new, caches[0], caches[1], planes[0], planes[1],
                      qblk, qoff, flags, ticket, n),
                L, B, Hkv, N, bs, D, D, 1, stream())
        return call

    calls = {"empty launch": {"change": lambda: torch.cuda._sleep(0)}}
    for label, (kn, vn, kc, vc, blk, off) in rows.items():
        calls[f"row store {label}"] = {"change": (
            lambda kn=kn, vn=vn, kc=kc, vc=vc, blk=blk, off=off:
            kvu.kv_cache_append_tokens(kn, vn, kc, vc, blk, off))}
    clean = {f"{name}, L2 flushed by reads": dict(sides)
             for name, sides in calls.items()}
    calls["quantized append, whole function"] = {"change": (
        lambda: kvu.append_quantized_rows(k_new, v_new, caches[0], caches[1],
                                          planes[0], planes[1], qblk, qoff))}
    src = (_cuda.SRC_DIR / "kv_cache_append.cu").read_text()
    for name, subs in KNOCKOUTS.items():
        text = src
        for old, new in subs:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        lib = build(text, name.replace(" ", "_"))
        for fn in ("kv_cache_append_quantized_launch",):
            getattr(lib, fn).argtypes = [_P] * 11 + [_I] * 8 + [_P]
        calls[f"quantized append, {name}"] = {"change": fused(lib)}

    if args.other is not None:
        olib = build(args.other.read_text(), "other")
        olib.kv_cache_append_quantized_launch.argtypes = [_P] * 11 + [_I] * 8 + [_P]
        calls["quantized append, whole function"]["other"] = fused(olib)
    if args.parent is not None:
        plib = build((args.parent / "dynamo_tpu_torch/csrc/kv_cache_append.cu")
                     .read_text(), "parent")
        plib.kv_cache_append_tokens_launch.argtypes = [_P] * 6 + [_I] * 9 + [_P]
        plib.kv_cache_append_quantized_launch.argtypes = [_P] * 8 + [_I] * 7 + [_P]
        for label, (kn, vn, kc, vc, blk, off) in rows.items():
            Lr, _, T, H, Dk = kn.shape

            def prow(kn=kn, vn=vn, kc=kc, vc=vc, blk=blk, off=off, Lr=Lr, T=T,
                     H=H, Dk=Dk):
                plib.kv_cache_append_tokens_launch(
                    *ptrs(kn, vn, kc, vc, blk, off), Lr, B, T, H, N, bs, Dk,
                    vn.shape[-1], 1, stream())
            calls[f"row store {label}"]["parent"] = prow

        def prmw(kq, vq, rk, rv):
            plib.kv_cache_append_quantized_launch(
                *ptrs(kq, vq, caches[0], caches[1], rk, rv, qblk, qoff),
                L, B, Hkv, N, bs, D, D, stream())

        def pwhole():
            new_ks, rk, kq = kvu.quant_scale_update(k_new, planes[0], qblk)
            new_vs, rv, vq = kvu.quant_scale_update(v_new, planes[1], qblk)
            prmw(kq, vq, rk, rv)
            return ((new_ks > planes[0]).sum()
                    + (new_vs > planes[1]).sum()).to(torch.int32)
        calls["quantized append, whole function"]["parent"] = pwhole
        _, rk, kq = kvu.quant_scale_update(k_new, scales[0], qblk)
        _, rv, vq = kvu.quant_scale_update(v_new, scales[1], qblk)
        calls["quantized append, page kernel alone"] = {
            "parent": lambda: prmw(kq, vq, rk, rv)}

    card = nvidia_smi_line()
    result = {}
    for name, sides in {**calls, **clean}.items():
        setup = reset if name.startswith("quantized") else None
        how = ReadFlush() if name in clean else flush
        order = ["parent", "other", "change", "change", "other", "parent"]
        got = {side: [] for side in sides}
        for side in order:
            if side in sides:
                got[side].append(time_ms(torch, sides[side], args.reps, how, setup))
        result[name] = {side: statistics.median(ts) for side, ts in got.items()}
        print(f"{name}: " + ", ".join(
            f"{side} {' / '.join(f'{t:.4f}' for t in ts)} ms"
            for side, ts in got.items()), flush=True)
    print(card)
    print(json.dumps({"ab": result, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
