"""Each CUDA kernel against its plain PyTorch version on the card.

Marked ``cuda``: skips without a CUDA device. This file imports torch and
the port only (no JAX), so it runs on a GPU machine as it stands:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: the suite's conftest configures JAX, which a GPU
machine need not have.)
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops.kv_cache_update import kv_cache_append
from dynamo_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)
from dynamo_tpu_torch.ops.ragged_paged_attention import ragged_mixed_attention


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: every kernel against its plain version on the same
    inputs (bf16 outputs, sums in another order: 2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.ops.kv_cache_update import kv_cache_append_plain
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_decode_attention_plain,
        paged_prefill_attention_plain,
    )
    from dynamo_tpu_torch.ops.ragged_paged_attention import (
        ragged_mixed_attention_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    Hkv, G, D, bs, M, N = 8, 4, 128, 16, 16, 160
    H = Hkv * G
    kc = torch.randn(Hkv, N, bs, D, generator=g, device=dev).bfloat16()
    vc = torch.randn(Hkv, N, bs, D, generator=g, device=dev).bfloat16()
    tables = torch.randperm(N - 1, generator=g, device=dev)[: 9 * M].add(1)
    tables = tables.reshape(9, M).to(torch.int32)
    lens = torch.tensor([0, 1, 17, 100, 256, 31, 64, 200], dtype=torch.int32,
                        device=dev)
    q = torch.randn(8, H, D, generator=g, device=dev).bfloat16()
    tol = dict(atol=2e-2, rtol=2e-2)
    got = paged_decode_attention(q, kc, vc, tables[:8], lens, D ** -0.5,
                                 return_stats=True)
    ref = paged_decode_attention_plain(q, kc, vc, tables[:8], lens, D ** -0.5,
                                       return_stats=True)
    torch.testing.assert_close(got[0].float(), ref[0].float(), **tol)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-3, atol=1e-3)
    qp = torch.randn(64, H, D, generator=g, device=dev).bfloat16()
    hist = torch.tensor([100], dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        paged_prefill_attention(qp, kc, vc, tables[8], hist, D ** -0.5).float(),
        paged_prefill_attention_plain(qp, kc, vc, tables[8], hist,
                                      D ** -0.5).float(), **tol)
    qc = torch.randn(2, 32, H, D, generator=g, device=dev).bfloat16()
    p_tab = torch.stack([tables[8], torch.zeros_like(tables[8])])
    p_h = torch.tensor([40, 0], dtype=torch.int32, device=dev)
    p_v = torch.tensor([30, 0], dtype=torch.int32, device=dev)
    args = (q, qc, kc, vc, tables[:8], lens, p_tab, p_h, p_v, D ** -0.5)
    for a, b in zip(ragged_mixed_attention(*args),
                    ragged_mixed_attention_plain(*args)):
        torch.testing.assert_close(a.float(), b.float(), **tol)
    new = torch.randn(2, 4, 8, Hkv, D, generator=g, device=dev).bfloat16()
    caches = torch.randn(2, 4, Hkv, 12, bs, D, generator=g,
                         device=dev).bfloat16()
    plain = caches.clone()
    blk = torch.arange(1, 9, dtype=torch.int32, device=dev)
    off = torch.arange(8, dtype=torch.int32, device=dev)
    kv_cache_append(new[0], new[1], caches[0], caches[1], blk, off)
    kv_cache_append_plain(new[0], new[1], plain[0], plain[1], blk, off)
    torch.cuda.synchronize()
    assert torch.equal(caches, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 24, 32])
@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("pages", ["bf16", "int8", "fp8"])
def test_cuda_tensor_core_tiles_match_plain(pages, D, G, bs):
    """On the card: the tensor-core segment tiles of a bf16 launch (bf16,
    int8 or fp8 pages) against the plain versions, prefill and ragged: a history
    of 333 (no multiple of 16 or 64), valid 77 of T = 100 (padded rows
    zero), a dead segment, decode rows beside them (CUDA-core body, split);
    block sizes that divide a 64-position step (16, 32) and one that does
    not (24); o within 2e-2, (m, l) within rtol 1e-3 of the plain f32
    softmax, the dead rows' o = 0, m = -1e30, l = 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops.paged_attention import paged_prefill_attention_plain
    from dynamo_tpu_torch.ops.ragged_paged_attention import (
        ragged_mixed_attention_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    Hkv, M, N = 4, 32, 200
    H, T, valid, hist = Hkv * G, 100, 77, 333
    if pages == "int8":
        kc, vc = (torch.randint(-127, 128, (Hkv, N, bs, D), generator=g,
                                device=dev, dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(N, generator=g, device=dev) * 0.02 + 0.002
                  for _ in range(2))
        sc = dict(k_scales=ks, v_scales=vs)
    elif pages == "fp8":
        from dynamo_tpu_torch.models.quant import to_e4m3

        kc, vc = (to_e4m3(torch.randn(Hkv, N, bs, D, generator=g, device=dev) * 2)
                  for _ in range(2))
        ks = vs = None
        sc = {}
    else:
        kc, vc = (torch.randn(Hkv, N, bs, D, generator=g, device=dev).bfloat16()
                  for _ in range(2))
        ks = vs = None
        sc = {}
    tables = torch.randperm(N - 1, generator=g, device=dev)[: 6 * M].add(1)
    tables = tables.reshape(6, M).to(torch.int32)
    q = torch.randn(T, H, D, generator=g, device=dev).bfloat16()
    scale = D ** -0.5
    tol = dict(atol=2e-2, rtol=2e-2)
    hist_t = torch.tensor([hist], dtype=torch.int32, device=dev)
    got = paged_prefill_attention(q, kc, vc, tables[0], hist_t, scale,
                                  valid_len=valid, **sc)
    ref = paged_prefill_attention_plain(q, kc, vc, tables[0], hist_t, scale,
                                        valid, ks, vs)
    torch.testing.assert_close(got.float(), ref.float(), **tol)

    def plain_stats(rows, table, limit):
        qg = rows.reshape(rows.shape[0], Hkv, G, D).float() * scale
        k = pa.gather_pages(kc, table, ks).float()
        v = pa.gather_pages(vc, table, vs).float()
        if table.dim() == 1:
            k, v = k[:, None], v[:, None]
        return pa.masked_attention(qg, k, v, limit)[1:]

    # the ragged launch: 3 decode rows (one inactive), the prefill rows as
    # segment 0, a dead segment 1
    lens = torch.tensor([0, 17, 411], dtype=torch.int32, device=dev)
    qd = torch.randn(3, H, D, generator=g, device=dev).bfloat16()
    qc = torch.stack([q, torch.randn(T, H, D, generator=g, device=dev).bfloat16()])
    p_tab = torch.stack([tables[0], torch.zeros_like(tables[0])])
    p_h = torch.tensor([hist, 0], dtype=torch.int32, device=dev)
    p_v = torch.tensor([valid, 0], dtype=torch.int32, device=dev)
    args = (qd, qc, kc, vc, tables[1:4], lens, p_tab, p_h, p_v, scale)
    o_dec, o_chunks = ragged_mixed_attention(*args, **sc)
    r_dec, r_chunks = ragged_mixed_attention_plain(*args, ks, vs)
    torch.testing.assert_close(o_dec.float(), r_dec.float(), **tol)
    torch.testing.assert_close(o_chunks.float(), r_chunks.float(), **tol)
    o, m, l = pa.launch_paged_attention(
        torch.cat([qd, qc.reshape(2 * T, H, D)]).reshape(-1, Hkv, G, D), kc, vc,
        scale, d_tables=tables[1:4], d_seq_lens=lens, p_tables=p_tab,
        p_hists=p_h, p_valids=p_v, T=T, stats=True, **sc)
    t = torch.arange(T, device=dev)
    limit = torch.where(t < valid, hist + t, -1)
    parts = [plain_stats(qd, tables[1:4], lens.long() - 1),
             plain_stats(q, tables[0], limit),
             plain_stats(qc[1], p_tab[1], torch.full_like(t, -1))]
    rm, rl = (torch.cat(x) for x in zip(*parts))
    torch.testing.assert_close(m, rm, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l, rl, rtol=1e-3, atol=1e-3)
    dead = [0] + list(range(3 + valid, 3 + 2 * T))
    assert (o[dead] == 0).all() and (m[dead] == -1e30).all() and (l[dead] == 0).all()


@pytest.mark.cuda
def test_cuda_wide_head_dims_match_plain():
    """On the card: the head widths above 128 (csrc/paged_attention_wide.cu)
    against the plain versions, as chip_smoke.py phase 2 holds them
    (check_wide_heads): Gemma-3-12B's attention (H=16, Hkv=8, D=256) over
    bf16, int8 and fp8 pages (decode with (m, l), prefill, ragged, verify
    rows), with its 1024-token window (the pages below every walk's first
    step made NaN), the three appends at D=256, and D=192 over the three
    page types; o within 2e-2, (m, l) within rtol 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from chip_smoke import WIDE, WIDE_WINDOW, check_wide_heads

    errs, _inp, _winp = check_wide_heads(torch, torch.device("cuda"), "test")
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "ragged_mixed_attention"):
        assert errs[name + WIDE] <= 2e-2 and errs[name + WIDE_WINDOW] <= 2e-2


@pytest.mark.cuda
def test_cuda_head_dim_gate():
    """On the card: the three GQA entry points launch their kernels at
    head_dim 256 (counted), and refuse a width the kernels do not take
    (D = 96, no multiple of 64, and 320, a multiple the TPU kernels take)
    with a ValueError naming ROADMAP B.7, before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    for D in (256, 96, 320):
        kc, vc = (torch.randn(2, 12, 16, D, generator=g, device=dev).bfloat16()
                  for _ in range(2))
        table = torch.arange(1, 5, dtype=torch.int32, device=dev)
        lens = torch.tensor([40], dtype=torch.int32, device=dev)
        q = torch.randn(1, 4, D, generator=g, device=dev).bfloat16()
        qp = torch.randn(8, 4, D, generator=g, device=dev).bfloat16()
        calls = (
            lambda: paged_decode_attention(q, kc, vc, table[None], lens, 0.1),
            lambda: paged_prefill_attention(qp, kc, vc, table, lens, 0.1),
            lambda: ragged_mixed_attention(
                q, qp[None], kc, vc, table[None], lens, table[None], lens,
                torch.tensor([8], dtype=torch.int32, device=dev), 0.1),
        )
        for fn, call in zip((paged_decode_attention, paged_prefill_attention,
                             ragged_mixed_attention), calls):
            before = fn.launches
            if D == 256:
                out = call()
                torch.cuda.synchronize()
                assert fn.launches == before + 1
                assert all(bool(torch.isfinite(o.float()).all())
                           for o in (out if isinstance(out, tuple) else (out,)))
            else:
                with pytest.raises(ValueError, match="B.7"):
                    call()
                assert fn.launches == before


@pytest.mark.cuda
def test_cuda_moe_ffn_is_bit_equal_run_to_run():
    """On the card: one bf16 MoE layer at DeepSeek-V2-Lite's widths (64
    experts top-6 + 2 shared, hidden 2048, expert width 1408), random
    weights, 512 tokens: two calls of moe_ffn give the same bits (the
    combine adds in a fixed order; no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import deepseek_v2_lite

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    cfg = deepseek_v2_lite()
    E, X, Fm = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    Fs = cfg.shared_expert_size or Fm * cfg.num_shared_experts
    shapes = dict(moe_gate=(E, X), we_gate=(X, E, Fm), we_up=(X, E, Fm),
                  we_down=(X, Fm, E), shared_gate=(E, Fs), shared_up=(E, Fs),
                  shared_down=(Fs, E))
    lp = {n: (torch.randn(v, generator=g, device=dev) * 0.02).bfloat16()
          for n, v in shapes.items()}
    x = torch.randn(512, E, generator=g, device=dev).bfloat16()
    a, b = llama.moe_ffn(lp, cfg, x), llama.moe_ffn(lp, cfg, x)
    torch.cuda.synchronize()
    assert torch.isfinite(a.float()).all() and torch.equal(a, b)


# the latent widths of C.7: DeepSeek-V2/V3, MiniCPM3-4B, and kv_lora_rank
# % 128 == 0 beyond them with narrow and unaligned rope widths
MLA_WIDTHS = pytest.mark.parametrize(
    "C,R", [(512, 64), (256, 32), (384, 16), (640, 64), (128, 8)],
    ids=["C512-R64", "C256-R32", "C384-R16", "C640-R64", "C128-R8"])
# C.8: widths the tensor-core tiles cannot hold (C >= 768, R > 128), which
# bf16 launches run on the CUDA-core body
MLA_WIDTHS_ALL = pytest.mark.parametrize(
    "C,R", [(512, 64), (256, 32), (384, 16), (640, 64), (128, 8), (768, 64),
            (1024, 64), (512, 160)],
    ids=["C512-R64", "C256-R32", "C384-R16", "C640-R64", "C128-R8", "C768-R64",
         "C1024-R64", "C512-R160"])
# bf16 runs the tensor-core body where it holds the widths, f32 the
# CUDA-core one
MLA_DTYPES = pytest.mark.parametrize(
    "dtype,body", [(torch.bfloat16, "mla_tc_kernel"),
                   (torch.float32, "mla_core_kernel")], ids=["bf16", "f32"])


def _cuda_kernels(fn):
    """The names of the CUDA kernels one call of ``fn`` launches. A trace
    that caught no kernel at all says nothing (the profiler, run many
    times in one process, now and then records no device events): it is
    taken again, up to five times, each after the device is idle."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def _mla_caches(g, dev, C, R, dtype, N=160, bs=16):
    cc = torch.randn(1, N, bs, C, generator=g, device=dev).to(dtype)
    pc = torch.randn(1, N, bs, R, generator=g, device=dev).to(dtype)
    return cc, pc


@pytest.mark.cuda
@MLA_WIDTHS_ALL
@MLA_DTYPES
def test_cuda_mla_kernels_match_plain_versions(C, R, dtype, body):
    """On the card: the latent decode (with stats and an empty slot; one
    launch, of the body the dtype and widths choose, and no combine
    kernel) and prefill kernels and the append at these widths against
    their plain versions (H=16; bf16 outputs 2e-2, (m, l) rtol 1e-3; f32
    2e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.ops import mla_attention as mla
    from dynamo_tpu_torch.ops.kv_cache_update import kv_cache_append_plain

    if not mla.tc_takes(C, R):
        body = "mla_core_kernel"  # the width dispatch (C.8)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(C + R)
    H, bs, M = 16, 16, 16
    cc, pc = _mla_caches(g, dev, C, R, dtype)
    tables = torch.randperm(159, generator=g, device=dev)[: 9 * M].add(1)
    tables = tables.reshape(9, M).to(torch.int32)
    lens = torch.tensor([0, 1, 17, 100, 256, 31, 64, 200], dtype=torch.int32,
                        device=dev)
    qe = torch.randn(8, H, C, generator=g, device=dev).to(dtype)
    qp = torch.randn(8, H, R, generator=g, device=dev).to(dtype)
    scale = (128 + R) ** -0.5
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
           else dict(atol=2e-5, rtol=2e-5))

    def decode():
        return mla.mla_paged_decode_attention(qe, qp, cc, pc, tables[:8], lens,
                                              scale, return_stats=True)

    got = decode()
    ref = mla.mla_paged_decode_attention_plain(qe, qp, cc, pc, tables[:8], lens,
                                               scale, return_stats=True)
    torch.testing.assert_close(got[0].float(), ref[0].float(), **tol)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-3, atol=1e-3)
    assert (got[0][0] == 0).all() and (got[1][0] == -1e30).all()
    names = _cuda_kernels(decode)
    assert len(names) == 1 and body in names[0], names
    qe = torch.randn(64, H, C, generator=g, device=dev).to(dtype)
    qp = torch.randn(64, H, R, generator=g, device=dev).to(dtype)
    hist = torch.tensor([100], dtype=torch.int32, device=dev)
    for valid in (None, 50):
        got = mla.mla_paged_prefill_attention(qe, qp, cc, pc, tables[8], hist,
                                              scale, valid_len=valid)
        assert got.dtype == torch.float32
        torch.testing.assert_close(
            got, mla.mla_paged_prefill_attention_plain(
                qe, qp, cc, pc, tables[8], hist, scale, valid), **tol)
    c_new = torch.randn(3, 8, 1, C, generator=g, device=dev).to(dtype)
    pe_new = torch.randn(3, 8, 1, R, generator=g, device=dev).to(dtype)
    kc = torch.randn(3, 1, 12, bs, C, generator=g, device=dev).to(dtype)
    vc = torch.randn(3, 1, 12, bs, R, generator=g, device=dev).to(dtype)
    kp, vp = kc.clone(), vc.clone()
    blk = torch.arange(1, 9, dtype=torch.int32, device=dev)
    off = torch.arange(8, dtype=torch.int32, device=dev)
    kv_cache_append(c_new, pe_new, kc, vc, blk, off)
    kv_cache_append_plain(c_new, pe_new, kp, vp, blk, off)
    torch.cuda.synchronize()
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


@pytest.mark.cuda
def test_cuda_ragged_int8_gmm_matches_its_plain_twin():
    """On the card: the quantized grouped GEMM against ragged_int8_plain
    (the kernel's formula) for int8 and fp8 codes, f32 and bf16 rows,
    empty experts and unowned rows (exact zeros); f32 sums in another
    order: rtol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.models.quant import quantize_array
    from dynamo_tpu_torch.ops.moe_gmm import ragged_int8_gmm, ragged_int8_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    X, K, N = 8, 160, 96
    sizes = torch.tensor([5, 0, 70, 1, 0, 33, 2, 9], dtype=torch.int64, device=dev)
    R = int(sizes.sum()) + 7  # seven rows no expert owns
    w = torch.randn(X, K, N, generator=g, device=dev)
    for mode in ("int8", "fp8_e4m3"):
        qw = quantize_array(w, mode)
        for dt in (torch.float32, torch.bfloat16):
            lhs = torch.randn(R, K, generator=g, device=dev).to(dt)
            got = ragged_int8_gmm(lhs, qw["q"], qw["s"], sizes)
            ref = ragged_int8_plain(lhs, qw["q"], qw["s"], sizes)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
            assert (got[R - 7:] == 0).all()


@pytest.mark.cuda
def test_cuda_quantized_append_and_scaled_attention_match_plain():
    """On the card: the quantized append bit-exact with its plain twin
    (page 0 excluded: padded rows race there), and the three attention
    entry points over int8 pages with per-page scales against their plain
    versions (bf16 outputs 2e-2, (m, l) 1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.ops import kv_cache_update as kvu
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_decode_attention_plain,
        paged_prefill_attention_plain,
    )
    from dynamo_tpu_torch.ops.ragged_paged_attention import (
        ragged_mixed_attention_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    L, B, Hkv, D, N, bs = 3, 6, 8, 128, 40, 16
    k_new = torch.randn(L, B, Hkv, D, generator=g, device=dev).bfloat16()
    v_new = torch.randn(L, B, Hkv, D, generator=g, device=dev).bfloat16()
    caches = torch.randint(-127, 128, (2, L, Hkv, N, bs, D), generator=g,
                           device=dev, dtype=torch.int8)
    planes = torch.rand(2, L, N, generator=g, device=dev) * 0.03
    blk = torch.tensor([3, 0, 9, 0, 17, 30], dtype=torch.int32, device=dev)
    off = torch.tensor([0, 4, 15, 4, 7, 1], dtype=torch.int32, device=dev)
    plain = caches.clone()
    got = kvu.kv_cache_append_quantized(k_new, v_new, caches[0], caches[1],
                                        planes[0], planes[1], blk, off)
    ref = kvu.kv_cache_append_quantized_plain(k_new, v_new, plain[0], plain[1],
                                              planes[0], planes[1], blk, off)
    torch.cuda.synchronize()
    assert torch.equal(caches[:, :, :, 1:], plain[:, :, :, 1:])
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    assert int(got[4]) == int(ref[4]) > 0 and got[4].device.type == "cuda"
    # attention over the int8 pages of layer 0
    kc, vc, ks, vs = caches[0, 0], caches[1, 0], got[2][0], got[3][0]
    G, M = 4, 2
    H = Hkv * G
    tables = torch.randperm(N - 1, generator=g, device=dev)[: 9 * M].add(1)
    tables = tables.reshape(9, M).to(torch.int32)
    lens = torch.tensor([0, 1, 17, 32, 5, 31, 20, 9], dtype=torch.int32,
                        device=dev)
    q = torch.randn(8, H, D, generator=g, device=dev).bfloat16()
    tol = dict(atol=2e-2, rtol=2e-2)
    sc = dict(k_scales=ks, v_scales=vs)
    o, m, l = paged_decode_attention(q, kc, vc, tables[:8], lens, D ** -0.5,
                                     return_stats=True, **sc)
    ro, rm, rl = paged_decode_attention_plain(q, kc, vc, tables[:8], lens,
                                              D ** -0.5, True, ks, vs)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(m, rm, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l, rl, rtol=1e-3, atol=1e-3)
    qp = torch.randn(16, H, D, generator=g, device=dev).bfloat16()
    hist = torch.tensor([10], dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        paged_prefill_attention(qp, kc, vc, tables[8], hist, D ** -0.5,
                                **sc).float(),
        paged_prefill_attention_plain(qp, kc, vc, tables[8], hist, D ** -0.5,
                                      None, ks, vs).float(), **tol)
    qc = torch.randn(2, 16, H, D, generator=g, device=dev).bfloat16()
    p_tab = torch.stack([tables[8], torch.zeros_like(tables[8])])
    p_h = torch.tensor([12, 0], dtype=torch.int32, device=dev)
    p_v = torch.tensor([14, 0], dtype=torch.int32, device=dev)
    args = (q, qc, kc, vc, tables[:8], lens, p_tab, p_h, p_v, D ** -0.5)
    for a, b in zip(ragged_mixed_attention(*args, **sc),
                    ragged_mixed_attention_plain(*args, ks, vs)):
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.cuda
def test_cuda_int8_native_mm_matches_cpu():
    """On the card ``_mm``'s int8_native product is ``torch._int_mm`` (rows
    padded past 16): exact int32 sums, so equal to the CPU's to f32
    rounding of the epilogue."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.models.llama import _mm
    from dynamo_tpu_torch.models.quant import quantize_array

    g = torch.Generator().manual_seed(2)
    w = quantize_array(torch.randn(64, 40, generator=g), "int8_native")
    for rows in (3, 40):
        x = torch.randn(rows, 64, generator=g)
        got = _mm(x.cuda(), {k: v.cuda() for k, v in w.items()})
        torch.testing.assert_close(got.cpu(), _mm(x, w), rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_cuda_append_tokens_and_verify_rows_match_plain():
    """On the card: kv_cache_append_tokens bit-exact with its plain twin
    at GQA widths (bf16 and f32, 16-byte and element stores) and at MLA's
    Dk != Dv, windows crossing pages and of T = bs rows (page 0 excluded:
    padded rows race there); the verify's attention (T*G rows per kv head,
    T*H latent rows per token) against the plain twins (2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import kv_cache_update as kvu
    from dynamo_tpu_torch.ops import mla_attention as mla

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    bs, N = 16, 40
    for T, dt, (Hkv, Dk, Dv) in ((4, torch.bfloat16, (8, 128, 128)),
                                 (bs, torch.bfloat16, (1, 512, 64)),
                                 (3, torch.float32, (2, 6, 6))):
        L, B = 3, 4
        k_new = torch.randn(L, B, T, Hkv, Dk, generator=g, device=dev).to(dt)
        v_new = torch.randn(L, B, T, Hkv, Dv, generator=g, device=dev).to(dt)
        kc = torch.randn(L, Hkv, N, bs, Dk, generator=g, device=dev).to(dt)
        vc = torch.randn(L, Hkv, N, bs, Dv, generator=g, device=dev).to(dt)
        start = torch.tensor([bs - 2, bs, 5, 0], device=dev)[:, None]
        pos = start + torch.arange(T, device=dev)[None, :]
        tables = torch.tensor([[3, 7, 9], [5, 2, 11], [20, 21, 22], [0, 0, 0]],
                              dtype=torch.int32, device=dev)
        blk = torch.gather(tables, 1, pos // bs).to(torch.int32)
        off = (pos % bs).to(torch.int32)
        kp, vp = kc.clone(), vc.clone()
        kvu.kv_cache_append_tokens(k_new, v_new, kc, vc, blk, off)
        kvu.kv_cache_append_tokens_plain(k_new, v_new, kp, vp, blk, off)
        torch.cuda.synchronize()
        assert torch.equal(kc[:, :, 1:], kp[:, :, 1:])
        assert torch.equal(vc[:, :, 1:], vp[:, :, 1:])
    tol = dict(atol=2e-2, rtol=2e-2)
    B, T, Hkv, G, D, M = 4, 4, 8, 4, 128, 8
    kc = torch.randn(Hkv, N, bs, D, generator=g, device=dev).bfloat16()
    vc = torch.randn(Hkv, N, bs, D, generator=g, device=dev).bfloat16()
    tables = torch.randperm(N - 1, generator=g, device=dev)[: B * M].add(1)
    tables = tables.reshape(B, M).to(torch.int32)
    hist = torch.tensor([-1, 0, 37, 120], dtype=torch.int32, device=dev)
    q = torch.randn(B, T, Hkv * G, D, generator=g, device=dev).bfloat16()
    kw = torch.randn(B, T, Hkv, D, generator=g, device=dev).bfloat16()
    vw = torch.randn(B, T, Hkv, D, generator=g, device=dev).bfloat16()
    args = (q, kw, vw, kc, vc, tables, hist, D ** -0.5)
    ref = att.verify_attention(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    torch.testing.assert_close(att.verify_attention(*args).float().cpu(),
                               ref.float(), **tol)
    H, C, R = 16, 512, 64
    cc = torch.randn(1, N, bs, C, generator=g, device=dev).bfloat16()
    pc = torch.randn(1, N, bs, R, generator=g, device=dev).bfloat16()
    margs = (torch.randn(B, T, H, C, generator=g, device=dev).bfloat16(),
             torch.randn(B, T, H, R, generator=g, device=dev).bfloat16(),
             torch.randn(B, T, C, generator=g, device=dev).bfloat16(),
             torch.randn(B, T, R, generator=g, device=dev).bfloat16(),
             cc, pc, tables, hist.clamp_min(0), 0.05)
    torch.testing.assert_close(mla.mla_verify_attention(*margs),
                               mla.mla_verify_attention_xla(*margs), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 4, 16])
@pytest.mark.parametrize("widths", [(8, 128, 128), (1, 512, 64)], ids=["gqa", "mla"])
def test_cuda_row_store_matches_index_put(widths, T):
    """On the card: the row store (``kv_rows_kernel``, one launch) bit-exact
    with ``index_put_`` at Llama-3-8B's GQA widths and DeepSeek-V2-Lite's
    latent widths (Dk != Dv), bf16, T = 1 (``kv_cache_append``), 4 and bs
    rows per sequence, windows crossing a page, a padded slot on page 0
    (excluded: its rows race there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.ops import kv_cache_update as kvu

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(T)
    Hkv, Dk, Dv = widths
    L, B, N, bs = 4, 5, 40, 16
    k_new = torch.randn(L, B, T, Hkv, Dk, generator=g, device=dev).bfloat16()
    v_new = torch.randn(L, B, T, Hkv, Dv, generator=g, device=dev).bfloat16()
    kc = torch.randn(L, Hkv, N, bs, Dk, generator=g, device=dev).bfloat16()
    vc = torch.randn(L, Hkv, N, bs, Dv, generator=g, device=dev).bfloat16()
    start = torch.tensor([bs - 2, bs - 1, 5, 0, bs], device=dev)[:, None]
    pos = start + torch.arange(T, device=dev)[None, :]
    tables = torch.tensor([[3, 7, 9], [5, 2, 11], [20, 21, 22], [0, 0, 0],
                           [30, 31, 32]], dtype=torch.int32, device=dev)
    blk = torch.gather(tables, 1, pos // bs).to(torch.int32)
    off = (pos % bs).to(torch.int32)
    kp, vp = kc.clone(), vc.clone()
    if T == 1:
        def call():
            kvu.kv_cache_append(k_new[:, :, 0], v_new[:, :, 0], kc, vc,
                                blk[:, 0].contiguous(), off[:, 0].contiguous())
    else:
        def call():
            kvu.kv_cache_append_tokens(k_new, v_new, kc, vc, blk, off)
    names = _cuda_kernels(call)
    kvu.kv_cache_append_tokens_plain(k_new, v_new, kp, vp, blk, off)
    torch.cuda.synchronize()
    assert len(names) == 1 and "kv_rows_kernel" in names[0], names
    assert torch.equal(kc[:, :, 1:], kp[:, :, 1:])
    assert torch.equal(vc[:, :, 1:], vp[:, :, 1:])


# (B, padded rows) of the fused quantized append on the card
_QUANT_BATCHES = [(1, 0), (8, 0), (8, 2), (8, 7), (64, 0), (64, 2), (64, 63)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,padded", _QUANT_BATCHES)
def test_cuda_fused_quantized_append_matches_plain(B, padded, dtype):
    """On the card, at Llama-3-8B's widths (L=32, Hkv=8, D=128, bs=16): the
    in-place quantized append is ONE kernel launch, bit-exact with its
    plain twin (codes off page 0, both planes grown in place, n_requants),
    with pages whose scale grows and pages whose scale holds; two launches
    bit-equal, page 0 included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.ops import kv_cache_update as kvu

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(100 * B + padded)
    L, Hkv, D, N, bs = 32, 8, 128, 160, 16
    k_new = torch.randn(L, B, Hkv, D, generator=g, device=dev).to(dtype)
    v_new = (torch.randn(L, B, Hkv, D, generator=g, device=dev) * 0.3).to(dtype)
    caches = torch.randint(-127, 128, (2, L, Hkv, N, bs, D), generator=g,
                           device=dev, dtype=torch.int8)
    planes = torch.rand(2, L, N, generator=g, device=dev) * 0.03 + 0.001
    blk = torch.randperm(N - 1, generator=g, device=dev)[:B] + 1
    planes[:, :, blk[::2]] = 1.0  # these pages keep their scale
    blk[torch.randperm(B, generator=g, device=dev)[:padded]] = 0
    blk = blk.to(torch.int32)
    off = torch.randint(0, bs, (B,), generator=g, device=dev, dtype=torch.int32)
    pc, pp = caches.clone(), planes.clone()
    n_ref = kvu.append_quantized_rows_plain(k_new, v_new, pc[0], pc[1], pp[0],
                                            pp[1], blk, off)
    runs = []
    for _ in range(2):
        c, pl = caches.clone(), planes.clone()
        before = kvu.kv_cache_append_quantized.launches
        n = kvu.append_quantized_rows(k_new, v_new, c[0], c[1], pl[0], pl[1],
                                      blk, off)
        assert kvu.kv_cache_append_quantized.launches == before + 1
        runs.append((c, pl, n))
    torch.cuda.synchronize()
    c, pl, n = runs[0]
    assert torch.equal(c[:, :, :, 1:], pc[:, :, :, 1:])
    assert torch.equal(pl, pp)
    assert n.dtype == torch.int32 and n.device.type == "cuda"
    assert int(n) == int(n_ref) == int((pl > planes).sum())
    live = blk[blk != 0].long()
    if live.numel() > 1:
        held = pl[:, :, live] == planes[:, :, live]
        assert held.any() and not held.all()
    assert torch.equal(runs[1][0], c) and torch.equal(runs[1][1], pl)
    assert int(runs[1][2]) == int(n)
    names = _cuda_kernels(lambda: kvu.append_quantized_rows(
        k_new, v_new, c[0], c[1], pl[0], pl[1], blk, off))
    assert len(names) == 1 and "kv_append_quant_kernel" in names[0], names


@pytest.mark.cuda
def test_cuda_ragged_int8_gmm_tiles_and_wide_k():
    """On the card: the tiled blocks' shapes beside the few-rows mode in one
    launch (experts of 5-16 rows, of more than 128 rows: two row tiles, an
    empty expert, experts of 1-4 rows, N with a partial 128-column tile) and
    K = 7168 (DeepSeek-V3's hidden width) at small N with few experts; int8
    and e4m3 codes, bf16 rows, against ragged_int8_plain at 2e-2 (bf16 rows,
    K-long f32 sums in another order), unowned rows exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.models.quant import quantize_array
    from dynamo_tpu_torch.ops.moe_gmm import ragged_int8_gmm, ragged_int8_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    for K, N, sizes in ((512, 160, [7, 0, 300, 3, 16, 129, 1]),
                        (7168, 64, [140, 2, 0, 9])):
        X = len(sizes)
        sizes = torch.tensor(sizes, dtype=torch.int64, device=dev)
        R = int(sizes.sum()) + 5  # five rows no expert owns
        w = torch.randn(X, K, N, generator=g, device=dev)
        lhs = torch.randn(R, K, generator=g, device=dev).bfloat16()
        for mode in ("int8", "fp8_e4m3"):
            qw = quantize_array(w, mode)
            got = ragged_int8_gmm(lhs, qw["q"], qw["s"], sizes)
            ref = ragged_int8_plain(lhs, qw["q"], qw["s"], sizes)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
            assert (got[R - 5:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(2048, 1408), (1408, 2048), (7168, 256)],
                         ids=["v2lite-gate", "v2lite-down", "K7168-N256"])
def test_cuda_ragged_int8_gmm_few_rows_mode(K, N):
    """On the card: the few-rows (decode) blocks at DeepSeek-V2-Lite's gate
    and down shapes and at K = 7168, N = 256 (K split across blocks): experts
    of 1-16 rows beside a tiled one of 40 rows and empty ones, then the
    same experts with the 40-row one cut to 15 (the few-rows blocks alone
    take rows, the tiled ones exit), and with every expert cut to 8 rows;
    int8 and e4m3 codes, bf16 rows, against ragged_int8_plain at 2e-2 (bf16 rows, K-long f32 sums in
    another order), unowned rows exactly 0, two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.models.quant import quantize_array
    from dynamo_tpu_torch.ops.moe_gmm import ragged_int8_gmm, ragged_int8_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(K + N)
    mixed = [1, 2, 0, 3, 4, 5, 8, 9, 16, 0, 40, 7, 1, 12, 0, 6]
    cases = [mixed, [min(n, 15) for n in mixed], [min(n, 8) for n in mixed]]
    w = torch.randn(len(mixed), K, N, generator=g, device=dev)
    for mode in ("int8", "fp8_e4m3"):
        qw = quantize_array(w, mode)
        for sizes in cases:
            sizes = torch.tensor(sizes, dtype=torch.int64, device=dev)
            R = int(sizes.sum()) + 5  # five rows no expert owns
            lhs = torch.randn(R, K, generator=g, device=dev).bfloat16()
            got = ragged_int8_gmm(lhs, qw["q"], qw["s"], sizes)
            again = ragged_int8_gmm(lhs, qw["q"], qw["s"], sizes)
            ref = ragged_int8_plain(lhs, qw["q"], qw["s"], sizes)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
            assert (got[R - 5:] == 0).all()
            assert torch.equal(got, again)


def _decode_case(dev, g, B, Hkv, rows, D, bs, M, N, lens):
    kc = torch.randn(Hkv, N, bs, D, generator=g, device=dev).bfloat16()
    vc = torch.randn(Hkv, N, bs, D, generator=g, device=dev).bfloat16()
    tables = torch.randperm(N - 1, generator=g, device=dev)[: B * M].add(1)
    tables = tables.reshape(B, M).to(torch.int32)
    q = torch.randn(B, Hkv * rows, D, generator=g, device=dev).bfloat16()
    return q, kc, vc, tables, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("G,T", [(4, 17), (7, 10), (7, 1)],
                         ids=["68 rows", "70 rows", "G=7 decode"])
@pytest.mark.parametrize("pages", ["bf16", "int8", "fp8"])
def test_cuda_decode_attention_takes_any_rows_per_kv_head(G, T, pages):
    """On the card: the tensor-core decode body at (gamma + 1) * G verify
    rows per kv head (G = 4, gamma = 16: 68 rows; G = 7, gamma = 9: 70),
    more than one 16-row block each, and a G = 7 decode; horizons of no
    multiple of 16 (split across blocks, merged in the launch), an inactive
    slot; bf16, int8 and fp8 pages, stats on and off. o within 2e-2 of the plain
    version, (m, l) within rtol 1e-3, the inactive slot o = 0, m = -1e30,
    l = 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    Hkv, D, bs, M = 2, 128, 16, 80
    q, kc, vc, tables, lens = _decode_case(dev, g, 4, Hkv, T * G, D, bs, M, 400,
                                           [1000, 0, 333, 17])
    sc = {}
    if pages == "fp8":
        from dynamo_tpu_torch.models.quant import to_e4m3

        kc, vc = to_e4m3(kc), to_e4m3(vc)
    if pages == "int8":
        ks = (kc.float().abs().amax(dim=(0, 2, 3)) / 127).clamp_min(1e-12)
        vs = (vc.float().abs().amax(dim=(0, 2, 3)) / 127).clamp_min(1e-12)
        kc = (kc.float() / ks[None, :, None, None]).round().to(torch.int8)
        vc = (vc.float() / vs[None, :, None, None]).round().to(torch.int8)
        sc = {"k_scales": ks, "v_scales": vs}
    args = (q, kc, vc, tables, lens, D ** -0.5)
    before = paged_decode_attention.verify_launches
    o, m, l = paged_decode_attention(*args, return_stats=True, group=G, **sc)
    ro, rm, rl = paged_decode_attention_plain(*args, return_stats=True, **sc)
    o_only = paged_decode_attention(*args, group=G, **sc)
    torch.cuda.synchronize()
    tol = dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(o_only.float(), ro.float(), **tol)
    torch.testing.assert_close(m, rm, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l, rl, rtol=1e-3, atol=1e-3)
    assert (o[1] == 0).all() and (m[1] == -1e30).all() and (l[1] == 0).all()
    assert paged_decode_attention.verify_launches - before == (2 if T > 1 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D,window", [(16, 4, 64, 32), (64, 8, 64, 128),
                                            (28, 4, 128, 100)],
                         ids=["G=4 D=64 W=32", "gpt-oss widths W=128",
                              "G=7 D=128 W=100"])
def test_cuda_windowed_sink_kernels_match_plain(H, Hkv, D, window):
    """On the card: the three GQA kernels with a sliding window and sinks
    against their plain versions, bf16 and int8 pages (chip_smoke.py
    check_windowed: the merged decode's call and the verify's rows with
    (m, l), decode rows with the sink folded, prefill and the ragged call
    over histories longer than the window; sinks drawn N(ln window, 1), and
    the scale each sink puts on its row's o held to the plain versions'),
    bf16, int8 and fp8 pages, then the pages below every
    walk's first step made NaN: the outputs stay finite and bit-equal (the
    walks start at the floor; they do not read and mask)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from chip_smoke import KernelInputs, check_windowed

    inp = KernelInputs(torch, torch.device("cuda"), H=H, Hkv=Hkv, D=D,
                       window=window, sinks=True)
    errs = check_windowed(torch, inp, "test")
    assert len(errs) == 9


@pytest.mark.cuda
@MLA_WIDTHS
@MLA_DTYPES
@pytest.mark.parametrize("rows", [8, 16, 64, 272])
def test_cuda_mla_kernels_at_minicpm3_widths(C, R, dtype, body, rows):
    """On the card: both latent kernels at MiniCPM3-4B's latent widths
    (C = 256, R = 32) and the others of C.7, with 8 rows per sequence (a
    part of a 16-row tile), 16 (decode, H = 16), 64 (a verify's 4 tokens)
    and 272 (spec_gamma = 16: 17 tokens) against their plain versions:
    decode with (m, l) and an empty slot, one launch each (counted as a
    verify's), prefill of 45 tokens x 8 heads (the last 64-row tile part
    full) with and without valid_len (bf16: 2e-2, (m, l) rtol 1e-3; f32
    2e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.ops import mla_attention as mla

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11 + rows)
    H, M = 8, 16
    cc, pc = _mla_caches(g, dev, C, R, dtype)
    tables = torch.randperm(159, generator=g, device=dev)[: 5 * M].add(1)
    tables = tables.reshape(5, M).to(torch.int32)
    lens = torch.tensor([0, 17, 200, 256], dtype=torch.int32, device=dev)
    qe = torch.randn(4, rows, C, generator=g, device=dev).to(dtype)
    qp = torch.randn(4, rows, R, generator=g, device=dev).to(dtype)
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
           else dict(atol=2e-5, rtol=2e-5))
    tokens = max(1, rows // 16)
    before = (mla.mla_paged_decode_attention.launches,
              mla.mla_paged_decode_attention.verify_launches)
    got = mla.mla_paged_decode_attention(qe, qp, cc, pc, tables[:4], lens, 0.06,
                                         return_stats=True, tokens=tokens)
    ref = mla.mla_paged_decode_attention_plain(qe, qp, cc, pc, tables[:4], lens,
                                               0.06, return_stats=True)
    torch.testing.assert_close(got[0].float(), ref[0].float(), **tol)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-3, atol=1e-3)
    assert (got[0][0] == 0).all() and (got[1][0] == -1e30).all()
    assert (mla.mla_paged_decode_attention.launches - before[0],
            mla.mla_paged_decode_attention.verify_launches - before[1]) == (
                1, int(tokens > 1))
    names = _cuda_kernels(lambda: mla.mla_paged_decode_attention(
        qe, qp, cc, pc, tables[:4], lens, 0.06, return_stats=True))
    assert len(names) == 1 and body in names[0], names
    qe = torch.randn(45, H, C, generator=g, device=dev).to(dtype)
    qp = torch.randn(45, H, R, generator=g, device=dev).to(dtype)
    hist = torch.tensor([100], dtype=torch.int32, device=dev)
    for valid in (None, 30):
        torch.testing.assert_close(
            mla.mla_paged_prefill_attention(qe, qp, cc, pc, tables[4], hist,
                                            0.06, valid_len=valid),
            mla.mla_paged_prefill_attention_plain(qe, qp, cc, pc, tables[4],
                                                  hist, 0.06, valid), **tol)


@pytest.mark.cuda
def test_cuda_engine_serves_spec_gamma_16_at_four_heads_per_kv_head():
    """On the card: a tiny f32 TorchEngine with G = 4 and spec_gamma=16
    (the verify packs 17 x 4 = 68 rows per kv head; 32-token pages, since a
    verify's 17 in-flight rows must fit one page, as in the reference) is
    accepted at init and serves: fed the spec_gamma=0 stream as its
    proposals, it produces the same greedy stream with fewer decode steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    import asyncio

    import numpy as np

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime import Context, collect

    dev = torch.device("cuda")
    cfg = ModelConfig.tiny(dtype="float32", head_dim=64, num_heads=8,
                           num_kv_heads=2, hidden_size=128)
    req = PreprocessedRequest(
        token_ids=[7, 8, 9, 10] * 6, stop_conditions=StopConditions(max_tokens=40),
        sampling_options=SamplingOptions(temperature=0.0), eos_token_ids=[])
    streams, steps = {}, {}
    for gamma in (0, 16):
        eng = TorchEngine(EngineConfig(model=cfg, num_blocks=32, block_size=32,
                                       max_batch_size=2, decode_window=4,
                                       spec_gamma=gamma), seed=1, device=dev)
        if gamma:
            def drafts(eng=eng):
                prop = np.full((eng.cfg.max_batch_size, gamma), -1, np.int64)
                for i, seq in enumerate(eng._active):
                    if seq is not None and not seq.finished:
                        nxt = streams[0][seq.generated: seq.generated + gamma]
                        prop[i, : len(nxt)] = nxt
                return prop if (prop >= 0).any() else None
            eng._propose_ngram = drafts

        async def run(eng=eng):
            try:
                return await collect(eng.generate(Context(req)))
            finally:
                await eng.close()

        streams[gamma] = [t for o in asyncio.run(run()) for t in o.token_ids]
        steps[gamma] = dict(eng.stats)
    assert streams[16] == streams[0] and len(streams[0]) == 40
    assert steps[16]["spec_accepted"] > 0
    assert steps[16]["decode_steps"] < steps[0]["decode_steps"]


# ---------------- CUDA graphs of the decode window and the verify ----------------


def fill_caches(eng, g):
    """Random history in every page (int8 codes with scales for the int8
    cache), so attention reads something other than zeros."""
    if eng.k_cache.dtype == torch.int8:
        for c in (eng.k_cache, eng.v_cache):
            c.copy_(torch.randint(-127, 128, c.shape, generator=g, dtype=torch.int8))
        for s in (eng.k_scales, eng.v_scales):
            s.copy_(torch.rand(s.shape, generator=g) * 0.02 + 1e-3)
    else:
        for c in (eng.k_cache, eng.v_cache):
            c.copy_(torch.randn(c.shape, generator=g))


def set_batch(eng, rng, lens, *, temps=0.0, seeds=0, top_ks=0, top_ps=1.0,
              penalties=False, first_page=1):
    """The engine's host state for one dispatch: slot b holds lens[b]
    tokens (0: a free or preempted slot, its table zero) on consecutive
    pages from ``first_page``, with room for a window; penalties on rows
    0, 2 and 3 of a 4-slot engine. Returns the steps (per-row generation
    counters) the dispatch takes."""
    bs, M = eng.cfg.block_size, eng.cfg.max_blocks_per_seq
    V = eng.cfg.model.vocab_size
    eng._block_tables[:] = 0
    page = first_page
    for b, n in enumerate(lens):
        if n:
            need = min(-(-(n + 4) // bs), M)
            eng._block_tables[b, :need] = np.arange(page, page + need)
            page += need
    eng._seq_lens[:] = lens
    eng._last_tokens[:] = rng.randint(0, V, len(lens))
    eng._temps[:], eng._seeds[:] = temps, seeds
    eng._top_ks[:], eng._top_ps[:] = top_ks, top_ps
    if penalties:
        eng._ensure_penalty_buffers()
        eng._pen_counts.copy_(torch.as_tensor(rng.randint(0, 3, eng._pen_counts.shape)))
        eng._pen_mask.copy_(torch.as_tensor(rng.rand(*eng._pen_mask.shape) < 0.1))
        eng._freq_pens[:] = [0.5, 0.0, 0.2, 0.0]
        eng._pres_pens[:] = [0.3, 0.0, 0.0, 0.1]
        eng._rep_pens[:] = [1.2, 1.0, 0.9, 1.0]
    else:
        eng._freq_pens[:], eng._pres_pens[:], eng._rep_pens[:] = 0.0, 0.0, 1.0
    return rng.randint(0, 50, len(lens)).astype(np.int64)  # steps


def _graph_model(family, dtype):
    from chip_smoke import tiny_gptoss
    from dynamo_tpu_torch.models.config import ModelConfig

    if family == "gptoss":
        return tiny_gptoss(dtype)
    if family == "gqa":
        return ModelConfig.tiny(dtype=dtype, head_dim=64, num_heads=8,
                                num_kv_heads=2, hidden_size=128)
    return ModelConfig.tiny_mla(
        dtype=dtype, kv_lora_rank=128, qk_rope_head_dim=64, num_layers=3,
        first_dense_layers=1, num_experts=8, num_experts_per_tok=2,
        num_shared_experts=1, moe_intermediate_size=32)


def _graph_engine(family, dtype="float32", quantization="none", kv="model",
                  params=None):
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine

    cfg = _graph_model(family, dtype)
    return TorchEngine(EngineConfig(
        model=cfg, num_blocks=64, block_size=16, max_batch_size=4,
        max_context=256, decode_window=4, quantization=quantization,
        kv_cache_dtype=kv), params=params, seed=1, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family,dtype,quantization,kv", [
    ("gqa", "float32", "none", "model"), ("gqa", "bfloat16", "none", "model"),
    ("mla", "float32", "none", "model"), ("mla", "bfloat16", "none", "model"),
    ("mla", "float32", "int8", "model"), ("mla", "bfloat16", "int8", "model"),
    ("gqa", "float32", "fp8_e4m3", "int8"),
    ("gptoss", "float32", "none", "model"),
    ("gptoss", "bfloat16", "none", "model"),
    ("gqa", "bfloat16", "none", "float8_e4m3"),
    ("gptoss", "bfloat16", "none", "float8_e4m3")],
    ids=["GQA f32", "GQA bf16", "MLA+MoE f32", "MLA+MoE bf16",
         "MLA+MoE int8 weights", "MLA+MoE bf16, int8 weights",
         "GQA fp8 weights + int8 KV", "gpt-oss f32", "gpt-oss bf16",
         "GQA bf16, fp8 KV", "gpt-oss bf16, fp8 KV"])
def test_cuda_graph_replays_equal_the_eager_step(family, dtype, quantization, kv):
    """On the card, at tiny widths: every key of the window ladder (n = 4,
    2, 1) and the gamma-3 verify (not over int8 pages, which the verify
    does not take), replayed from its CUDA graph, gives bit for bit what
    the eager step gives on the same inputs and state (chip_smoke.py
    check_replay): greedy rows; seeded sampled rows with top-k / top-p,
    penalties and logprobs; then the tables changed, a slot freed and
    another refilled on other pages, replayed by the graphs captured
    before. The replays count their kernels' launches. The tiny gpt-oss
    (16-token windows on alternate layers, sinks, biased clamped MoE;
    histories past the window) replays its windowed launches too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from chip_smoke import check_replay
    from dynamo_tpu_torch.ops import mla_attention

    eng = _graph_engine(family, dtype, quantization, kv)
    fill_caches(eng, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    V = eng.cfg.model.vocab_size
    cases = [
        ([40, 17, 0, 66], {}, False, False, 1),
        ([41, 18, 0, 67], dict(temps=[0.8, 0.0, 0.0, 1.1], seeds=[5, 0, 9, 77],
                               top_ks=[0, 0, 0, 3], top_ps=[1.0, 1.0, 1.0, 0.9]),
         True, True, 1),
        ([42, 0, 23, 68], dict(temps=[0.9, 0.0, 0.6, 0.0], seeds=[5, 0, 31, 0]),
         False, True, 30),
    ]
    decode = (mla_attention.mla_paged_decode_attention if family == "mla"
              else paged_decode_attention)
    windowed = paged_decode_attention.window_launches
    for lens, samp, pen, lp, first in cases:
        steps = set_batch(eng, rng, lens, penalties=pen, first_page=first, **samp)
        programs = [eng._decode_program(steps, n, pen, lp) for n in (4, 2, 1)]
        if kv != "int8":
            proposals = rng.randint(0, V, (4, 3)).astype(np.int32)
            proposals[0, 2] = -1
            window = np.concatenate([eng._last_tokens[:, None],
                                     np.maximum(proposals, 0)], 1).astype(np.int32)
            programs.append(eng._verify_program(window, proposals, steps, pen, lp))
        for _key, gkey, program, holds in programs:
            before = decode.launches
            check_replay(torch, eng._graphs, gkey, program, holds)
            assert decode.launches > before  # the eager step's and the replay's
    assert eng._graphs.replays == 3 * len(programs)
    if family == "gptoss":
        assert paged_decode_attention.window_launches > windowed
    assert len(eng._graphs.graphs) >= len(programs)
    assert eng._graphs.pool_bytes() > 0


@pytest.mark.cuda
def test_cuda_int8_kv_requant_count_survives_replays():
    """The int8 cache's requant count sums a window's graph output, which
    the next replay overwrites: windows dispatched through the graphs
    (capture, then replays with a scrape between them) and through the
    eager step on a twin engine (same weights, same state) give the same
    tokens and the same ``kv_device_requants_total``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.engine.graphs import GraphRunner

    graphs = _graph_engine("gqa", kv="int8")
    eager = _graph_engine("gqa", kv="int8", params=graphs.params)
    eager._graphs = GraphRunner(eager.device, capture=False)
    results = []
    for eng in (graphs, eager):
        fill_caches(eng, torch.Generator().manual_seed(4))
        steps = set_batch(eng, np.random.RandomState(4), [30, 9, 0, 50])
        toks, totals = [], []
        for _ in range(2):
            for _ in range(2):
                toks.append(eng._dispatch_window(steps, 4)[0])
            totals.append(eng.load_metrics()["kv_device_requants_total"])
        results.append((np.stack(toks), totals))
    assert graphs._graphs.replays == 3 and eager._graphs.replays == 0
    np.testing.assert_array_equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1] and results[0][1][0] > 0


@pytest.mark.cuda
def test_cuda_device_buffer_refuses_to_grow_while_capturing():
    """A shared device buffer is sized by the eager run before a capture;
    asked to grow while the stream captures, it raises (a graph would
    otherwise hold a buffer made inside its own pool)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.ops import _cuda

    dev = torch.device("cuda")
    held = _cuda.device_buffer("capture probe", dev, 16, torch.float32)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            assert _cuda.device_buffer("capture probe", dev, 16, torch.float32) is held
            with pytest.raises(RuntimeError, match="captures a CUDA graph"):
                _cuda.device_buffer("capture probe", dev, held.numel() + 1,
                                    torch.float32)
            with pytest.raises(RuntimeError, match="captures a CUDA graph"):
                _cuda.device_buffer("never made", dev, 1, torch.float32)
        finally:
            graph.capture_end()


@pytest.mark.cuda
def test_cuda_f32_ragged_mm_memory_stays_bounded_at_prefill_rows():
    """The f32 expert matmul on the card (a batched product of each row's
    gathered expert matrix, capture-safe) at a prefill's row count where
    gathering every row's ``[in, out]`` matrix at once would take 96 GiB:
    it gathers in bounded chunks, matches a per-expert product, and leaves
    rows past the groups zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from dynamo_tpu_torch.models import llama

    dev = torch.device("cuda")
    E, D, X = 8, 2048, 6144  # X rows x a 16 MiB matrix each: 96 GiB
    g = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randn(X, D, generator=g, device=dev)
    w = torch.randn(E, D, D, generator=g, device=dev) * D ** -0.5
    sizes = [1500, 0, 900, 1200, 17, 800, 1000, 600]  # 127 rows past the groups
    group_sizes = torch.tensor(sizes, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = llama._ragged_mm(xs, w, group_sizes)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < 2 * llama._F32_GATHER_BYTES
    want = torch.zeros_like(out)
    start = 0
    for e, n in enumerate(sizes):
        want[start:start + n] = xs[start:start + n] @ w[e]
        start += n
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    assert not out[sum(sizes):].any()


@pytest.mark.cuda
def test_cuda_fp8_cast_on_store_is_the_reference_cast():
    """On the card: the row store into fp8 caches, byte for byte against
    models/quant.to_e4m3 (the reference's cast, NaN above 464 where the
    card's satfinite cvt saturates): every bf16 bit pattern and f32 rows at
    D = 128 and D = 6 (chip_smoke.py check_e4m3_store), then bf16 rows at
    DeepSeek-V2-Lite's latent widths (Dk = 512, Dv = 64) through
    kv_cache_append_tokens against its plain twin (page 0 excluded)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from chip_smoke import check_e4m3_store, same_bytes
    from dynamo_tpu_torch.models.quant import to_e4m3
    from dynamo_tpu_torch.ops import kv_cache_update as kvu

    dev = torch.device("cuda")
    check_e4m3_store(torch, dev)
    g = torch.Generator(device=dev).manual_seed(9)
    L, B, T, N, bs = 3, 4, 4, 40, 16
    k_new = torch.randn(L, B, T, 1, 512, generator=g, device=dev).bfloat16() * 300
    v_new = torch.randn(L, B, T, 1, 64, generator=g, device=dev).bfloat16() * 300
    kc = to_e4m3(torch.randn(L, 1, N, bs, 512, generator=g, device=dev))
    vc = to_e4m3(torch.randn(L, 1, N, bs, 64, generator=g, device=dev))
    pos = torch.tensor([bs - 2, 3, 0, bs], device=dev)[:, None] + torch.arange(
        T, device=dev)[None]
    tables = torch.tensor([[3, 7, 9], [5, 2, 11], [0, 0, 0], [20, 21, 22]],
                          dtype=torch.int32, device=dev)
    blk = torch.gather(tables, 1, pos // bs).to(torch.int32)
    off = (pos % bs).to(torch.int32)
    kp, vp = kc.clone(), vc.clone()
    kvu.kv_cache_append_tokens(k_new, v_new, kc, vc, blk, off)
    kvu.kv_cache_append_tokens_plain(k_new, v_new, kp, vp, blk, off)
    torch.cuda.synchronize()
    assert same_bytes(torch, kc[:, :, 1:], kp[:, :, 1:])
    assert same_bytes(torch, vc[:, :, 1:], vp[:, :, 1:])


@pytest.mark.cuda
def test_cuda_fp8_tiny_model_matches_the_cpu():
    """On the card: the tiny GQA model over an fp8 cache through prefill,
    the fused mixed step and a decode window against the CPU's plain
    versions (chip_smoke.py check_model_on_card: tokens exact, logits
    within 2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    from chip_smoke import check_model_on_card, tiny_models

    label, cfg, quantization, kv = next(
        m for m in tiny_models() if m[3] == "float8_e4m3")
    check_model_on_card(torch, torch.device("cuda"), label, cfg, quantization, kv)
