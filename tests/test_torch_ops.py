"""The port's attention / KV-append / sampling ops against the JAX package.

Each kernel's plain PyTorch version (what the wrapper runs on a CPU tensor)
is held to the JAX Pallas kernel run in interpret mode, on the same numpy
inputs from a seed, at f32 with the JAX kernel tests' tolerance (2e-5);
the KV append is bit-exact. The dense twins and the sampling ops are held
to their JAX functions (the CUDA kernels themselves are held to their
plain versions on the card by tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import sampling as jsamp
from dynamo_tpu.ops.kv_cache_update_pallas import kv_cache_append as j_append
from dynamo_tpu.ops.paged_attention_pallas import (
    paged_decode_attention as j_decode,
)
from dynamo_tpu.ops.paged_attention_pallas import (
    paged_prefill_attention as j_prefill,
)
from dynamo_tpu.ops.ragged_paged_attention_pallas import (
    ragged_mixed_attention as j_ragged,
)
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import paged_attention, sampling
from dynamo_tpu_torch.ops.kv_cache_update import kv_cache_append
from dynamo_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)
from dynamo_tpu_torch.ops.ragged_paged_attention import ragged_mixed_attention

TOL = dict(rtol=2e-5, atol=2e-5)


def _cache(rng, Hkv, N, bs, D):
    return (rng.standard_normal((Hkv, N, bs, D)).astype(np.float32),
            rng.standard_normal((Hkv, N, bs, D)).astype(np.float32))


def _tables(rng, rows, M, N):
    """Disjoint physical pages per row; page 0 stays the trash page."""
    pages = rng.permutation(np.arange(1, N)).astype(np.int32)
    return pages[: rows * M].reshape(rows, M)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("H,Hkv", [(8, 2), (4, 4)])
def test_paged_decode_attention_stats_match_pallas(H, Hkv):
    rng = np.random.default_rng(0)
    B, D, bs, M = 4, 16, 8, 3
    N = B * M + 1
    kc, vc = _cache(rng, Hkv, N, bs, D)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    tables = _tables(rng, B, M, N)
    seq_lens = np.asarray([0, 5, M * bs, 9], np.int32)  # one empty slot
    scale = D ** -0.5
    o, m, l = paged_decode_attention(*_t(q, kc, vc, tables, seq_lens), scale,
                                     return_stats=True)
    jo, jm, jl = j_decode(*_j(q, kc, vc, tables, seq_lens), scale,
                          return_stats=True, interpret=True)
    _close(o, jo)
    _close(m, jm)
    _close(l, jl)
    # the empty slot: o = 0, m = the kernels' -1e30 (not -inf), l = 0
    assert (o[0] == 0).all() and (m[0] == -1e30).all() and (l[0] == 0).all()


def test_decode_attention_merged_matches_jax():
    rng = np.random.default_rng(1)
    B, H, Hkv, D, bs, M = 3, 8, 2, 16, 8, 4
    N = B * M + 1
    kc, vc = _cache(rng, Hkv, N, bs, D)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k_new = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    v_new = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    tables = _tables(rng, B, M, N)
    hist = np.asarray([0, 7, 30], np.int32)  # hist 0 degenerates to v_new
    scale = D ** -0.5
    args = (q, k_new, v_new, kc, vc, tables, hist)
    got = att.decode_attention_merged(*_t(*args), scale)
    ref = jatt.decode_attention_merged(*_j(*args), scale, interpret=True)
    _close(got, ref)
    # a T=3 in-flight window: the causal part inside the window too
    win = (rng.standard_normal((B, 3, H, D)).astype(np.float32),
           rng.standard_normal((B, 3, Hkv, D)).astype(np.float32),
           rng.standard_normal((B, 3, Hkv, D)).astype(np.float32),
           kc, vc, tables, hist)
    _close(att.verify_attention(*_t(*win), scale),
           jatt.verify_attention(*_j(*win), scale, use_pallas=True,
                                 interpret=True))
    # the dense twins agree with their JAX counterparts too
    h_got = att._history_attention_xla(
        *_t(q[:, None], kc, vc, tables, hist), scale)
    h_ref = jatt._history_attention_xla(
        *_j(q[:, None], kc, vc, tables, hist), scale)
    for g, r in zip(h_got, h_ref):
        _close(g, r)
    seq_lens = hist + 1
    _close(att.decode_attention_xla(*_t(q, kc, vc, tables, seq_lens), scale),
           jatt.decode_attention_xla(*_j(q, kc, vc, tables, seq_lens), scale))


def test_paged_prefill_attention_matches_pallas_on_real_rows():
    rng = np.random.default_rng(2)
    H, Hkv, D, bs, M = 4, 2, 16, 8, 6
    T, valid, hist = 16, 13, 19
    N = M + 4
    kc, vc = _cache(rng, Hkv, N, bs, D)
    table = _tables(rng, 1, M, N)[0]
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k_chunk = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    v_chunk = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    scale = D ** -0.5
    # write-before-attend: the chunk lands through the port's writer and
    # through the JAX one; the two caches must come out identical
    tkc, tvc, ttab = _t(kc, vc, table)
    att.write_chunk_to_cache(tkc, *_t(k_chunk), ttab, hist)
    att.write_chunk_to_cache(tvc, *_t(v_chunk), ttab, hist)
    jkc = jatt.write_chunk_to_cache(jnp.asarray(kc), jnp.asarray(k_chunk),
                                    jnp.asarray(table), jnp.int32(hist))
    jvc = jatt.write_chunk_to_cache(jnp.asarray(vc), jnp.asarray(v_chunk),
                                    jnp.asarray(table), jnp.int32(hist))
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jkc))
    got = paged_prefill_attention(torch.from_numpy(q), tkc, tvc, ttab, hist,
                                  scale)
    ref = j_prefill(jnp.asarray(q), jkc, jvc, jnp.asarray(table),
                    jnp.int32(hist), scale, interpret=True)
    _close(got[:valid], np.asarray(ref)[:valid])
    # with the valid length the padded rows come out zero, real rows alike
    got_v = paged_prefill_attention(torch.from_numpy(q), tkc, tvc, ttab, hist,
                                    scale, valid_len=valid)
    assert (got_v[valid:] == 0).all()
    _close(got_v[:valid], got[:valid], rtol=0, atol=0)
    # ... and the dense twin (chunk read from the arguments)
    dense = att.chunk_attention_with_cache_xla(
        *_t(q, k_chunk, v_chunk), tkc, tvc, ttab, hist, valid, scale)
    jdense = jatt.chunk_attention_with_cache_xla(
        *_j(q, k_chunk, v_chunk), jkc, jvc, jnp.asarray(table),
        jnp.int32(hist), jnp.int32(valid), scale)
    _close(dense[:valid], np.asarray(jdense)[:valid])
    _close(got[:valid], dense[:valid])


def test_ragged_mixed_attention_matches_pallas():
    rng = np.random.default_rng(3)
    B, Hkv, G, D, bs, M = 3, 2, 2, 16, 8, 6
    H = Hkv * G
    MP, T = 2, 16
    N = (B + MP) * M + 1
    kc, vc = _cache(rng, Hkv, N, bs, D)
    tables = _tables(rng, B + MP, M, N)
    d_tables, p_tables = tables[:B], tables[B:].copy()
    p_tables[1] = 0  # dead segment: zero table, valid 0
    d_seq_lens = np.asarray([5, 0, 33], np.int32)  # one inactive slot
    p_hists = np.asarray([9, 0], np.int32)
    p_valids = np.asarray([13, 0], np.int32)
    q_dec = rng.standard_normal((B, H, D)).astype(np.float32)
    q_chunks = rng.standard_normal((MP, T, H, D)).astype(np.float32)
    scale = D ** -0.5
    args = (q_dec, q_chunks, kc, vc, d_tables, d_seq_lens, p_tables, p_hists,
            p_valids)
    o_dec, o_chunks = ragged_mixed_attention(*_t(*args), scale)
    jo_dec, jo_chunks = j_ragged(*_j(*args), scale, q_tile=8, interpret=True)
    _close(o_dec, jo_dec)
    _close(o_chunks[0, :13], np.asarray(jo_chunks)[0, :13])
    # inactive slot, dead segment and padded rows are zeros
    assert (o_dec[1] == 0).all() and (o_chunks[1] == 0).all()
    assert (o_chunks[0, 13:] == 0).all()
    np.testing.assert_array_equal(np.asarray(jo_chunks)[1], 0.0)


LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _tc_tile_arithmetic(q, kc, vc, table, limit, scale, ks=None, vs=None):
    """The tensor-core segment tiles' arithmetic (csrc/paged_attention.cu,
    tc_segment_tile) in torch, for the rows ``q [R, Hkv, G, D]`` (bf16) of
    one sequence's ``table``, row r attending ``0..limit[r]``: 64-position
    steps; S from the bf16 operands summed in f32 (int8 codes are exact in
    bf16), times scale * log2(e) and, with int8 pages, the K page's scale
    per column; an exp2 online softmax in f32 whose l sums the f32 p; P
    times the V page's scale, rounded to bf16, then P V over the codes.
    Returns o (f32) ``[R, Hkv, G, D]`` and m, l ``[R, Hkv, G]``; rows that
    attend nothing give 0, -1e30, 0."""
    R, Hkv, G, D = q.shape
    bs = kc.shape[2]
    S = table.numel() * bs
    page = table.long().repeat_interleave(bs)  # the page of each position
    slot = page * bs + torch.arange(S) % bs
    k = kc.reshape(Hkv, -1, D)[:, slot].float()  # [Hkv, S, D]
    v = vc.reshape(Hkv, -1, D)[:, slot].float()
    kcol = torch.ones(S) if ks is None else ks[page]
    vcol = torch.ones(S) if vs is None else vs[page]
    qf = q.float().permute(1, 0, 2, 3).reshape(Hkv, R * G, D)
    lim = limit.long().repeat_interleave(G)  # row r * G + g
    m = torch.full((Hkv, R * G), -1e30)
    l = torch.zeros(Hkv, R * G)
    acc = torch.zeros(Hkv, R * G, D)
    for c in range(0, int(lim.max()) + 1, 64):
        pos = torch.arange(c, min(c + 64, S))
        s2 = qf @ k[:, pos].transpose(1, 2) * (scale * LOG2E) * kcol[pos]
        s2 = s2.masked_fill(pos[None, None] > lim[None, :, None], -float("inf"))
        m_new = torch.maximum(m, s2.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pb = (p * vcol[pos]).bfloat16().float()
        acc = acc * alpha[..., None] + pb @ v[:, pos]
        m = m_new
    live = lim >= 0
    o = torch.where(live[None, :, None], acc / l.clamp_min(1e-20)[..., None], 0.0)
    m = torch.where(live, m * LN2, -1e30)
    l = torch.where(live, l, 0.0)
    back = lambda x: x.reshape(Hkv, R, G, *x.shape[2:]).transpose(0, 1)  # noqa: E731
    return back(o), back(m), back(l)


@pytest.mark.parametrize("int8_pages", [False, True], ids=["bf16", "int8"])
def test_tensor_core_tile_arithmetic_fits_pallas(int8_pages):
    """The reorganised arithmetic of the bf16 launches' segment tiles (P in
    bf16, int8 codes exact with the page scales on S columns and folded
    into P) against the JAX Pallas prefill and ragged kernels in interpret
    mode, at the card's kernel-vs-plain tolerances: o within 2e-2 (bf16
    output, P rounded), (m, l) within rtol 1e-3 of the plain f32 softmax.
    G = 3 (rows do not fill a 16-row group), a history of 75 (no multiple
    of 16 or 64), valid 33 of T = 40, and a dead segment."""
    rng = np.random.default_rng(6)
    Hkv, G, D, bs, M = 2, 3, 64, 16, 8
    H, T, valid, hist = Hkv * G, 40, 33, 75
    N = 2 * M + 1

    def bf(*shape):  # bf16 values, shared exactly by both sides
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    if int8_pages:
        codes = rng.integers(-127, 128, (2, Hkv, N, bs, D)).astype(np.int8)
        kc, vc = torch.from_numpy(codes[0]), torch.from_numpy(codes[1])
        ks, vs = (torch.from_numpy(rng.uniform(0.002, 0.02, N).astype(np.float32))
                  for _ in range(2))
        jsc = dict(k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy()))
        jk, jv = jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy())
    else:
        kc, vc, ks, vs, jsc = bf(Hkv, N, bs, D), bf(Hkv, N, bs, D), None, None, {}
        jk, jv = (jnp.asarray(c.float().numpy(), jnp.bfloat16) for c in (kc, vc))
    tables = torch.from_numpy(_tables(rng, 2, M, N))
    q = bf(T, H, D)
    jq = jnp.asarray(q.float().numpy(), jnp.bfloat16)
    scale = D ** -0.5
    t = torch.arange(T)
    limit = torch.where(t < valid, hist + t, -1)
    o, m, l = _tc_tile_arithmetic(q.reshape(T, Hkv, G, D), kc, vc, tables[0],
                                  limit, scale, ks, vs)
    ref = j_prefill(jq, jk, jv, jnp.asarray(tables[0].numpy()), jnp.int32(hist),
                    scale, interpret=True, **jsc)
    o = o.reshape(T, H, D)
    ref = np.asarray(ref.astype(jnp.float32))
    _close(o[:valid], ref[:valid], rtol=2e-2, atol=2e-2)
    assert (o[valid:] == 0).all() and (m[valid:] == -1e30).all() and (l[valid:] == 0).all()
    qg = q.reshape(T, Hkv, G, D).float() * scale
    k = paged_attention.gather_pages(kc, tables[0], ks)[:, None]
    v = paged_attention.gather_pages(vc, tables[0], vs)[:, None]
    _, pm, pl = paged_attention.masked_attention(qg, k.float(), v.float(), limit)
    _close(m[:valid], pm[:valid], rtol=1e-3, atol=1e-3)
    _close(l[:valid], pl[:valid], rtol=1e-3, atol=1e-3)
    # the same rows as the first segment of a ragged call beside a dead
    # segment and two decode rows (the decode rows keep the CUDA-core body)
    q_dec = bf(2, H, D)
    qc = torch.stack([q, bf(T, H, D)])
    jargs = (jnp.asarray(q_dec.float().numpy(), jnp.bfloat16),
             jnp.asarray(qc.float().numpy(), jnp.bfloat16), jk, jv,
             jnp.asarray(tables.numpy()), jnp.asarray([9, 0], jnp.int32),
             jnp.asarray(tables.numpy()), jnp.asarray([hist, 0], jnp.int32),
             jnp.asarray([valid, 0], jnp.int32))
    _, jo_chunks = j_ragged(*jargs, scale, q_tile=8, interpret=True, **jsc)
    jo_chunks = np.asarray(jo_chunks.astype(jnp.float32))
    _close(o[:valid], jo_chunks[0, :valid], rtol=2e-2, atol=2e-2)
    dead, dm, dl = _tc_tile_arithmetic(qc[1].reshape(T, Hkv, G, D), kc, vc,
                                       tables[1], torch.full((T,), -1), scale,
                                       ks, vs)
    assert (dead == 0).all() and (dm == -1e30).all() and (dl == 0).all()
    np.testing.assert_array_equal(jo_chunks[1], 0.0)


def _tc_decode_arithmetic(q, kc, vc, tables, seq_lens, scale, n_split,
                          ks=None, vs=None, n_warps=8, kt=16, min_steps=8):
    """The tensor-core decode body's arithmetic (csrc/paged_attention.cu,
    tc_decode_tile) in torch, for ``q [B, Hkv, R, D]`` (bf16; R rows per kv
    head, e.g. a verify's T*G): a tile's horizon in kt-position steps,
    split into n_split block runs of at least min_steps steps (where the
    horizon has them), each cut into n_warps warp runs; each warp an exp2
    online softmax in f32 with the K page scale on S columns, P times the V
    page scale rounded to bf16, l summing the f32 p; the warps merged by the
    flash rule (log2), each block's normalized partial written in f32, the
    splits merged by the flash rule (natural log). Returns o (f32) ``[B,
    Hkv, R, D]`` and m, l ``[B, Hkv, R]``; an inactive slot gives 0, -1e30,
    0."""
    B, Hkv, R, D = q.shape
    bs = kc.shape[2]
    o = torch.zeros(B, Hkv, R, D)
    m_out = torch.full((B, Hkv, R), -1e30)
    l_out = torch.zeros(B, Hkv, R)
    for b in range(B):
        last = min(int(seq_lens[b]), tables.shape[1] * bs) - 1
        steps = (last + kt) // kt
        per = max(-(-steps // n_split), min_steps)
        page = tables[b].long().repeat_interleave(bs)  # the page of a position
        slot = page * bs + torch.arange(page.numel()) % bs
        kcol = torch.ones(page.numel()) if ks is None else ks[page]
        vcol = torch.ones(page.numel()) if vs is None else vs[page]
        for h in range(Hkv):
            k = kc[h].reshape(-1, D)[slot].float()
            v = vc[h].reshape(-1, D)[slot].float()
            qf = q[b, h].float()
            parts = []
            for z in range(n_split):
                b0 = min(steps, z * per)
                b1 = min(steps, b0 + per)
                wper = -(-(b1 - b0) // n_warps)
                warps = []
                for w in range(n_warps):
                    w0 = min(b1, b0 + w * wper)
                    w1 = min(b1, w0 + wper)
                    m = torch.full((R,), -1e30)
                    l = torch.zeros(R)
                    acc = torch.zeros(R, D)
                    for st in range(w0, w1):
                        pos = torch.arange(st * kt, st * kt + kt)
                        s2 = qf @ k[pos].T * (scale * LOG2E) * kcol[pos]
                        s2 = s2.masked_fill(pos[None] > last, -float("inf"))
                        m_new = torch.maximum(m, s2.amax(-1))
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(s2 - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + (p * vcol[pos]).bfloat16().float() @ v[pos]
                        m = m_new
                    warps.append((m, l, acc))
                M = torch.stack([w[0] for w in warps]).amax(0)
                wt = [torch.exp2(w[0] - M) for w in warps]
                L = sum(w[1] * x for w, x in zip(warps, wt))
                O = sum(w[2] * x[:, None] for w, x in zip(warps, wt))
                live = L > 0
                parts.append((torch.where(live[:, None], O / L.clamp_min(1e-30)[:, None], 0.0),
                              torch.where(live, M * LN2, -1e30), torch.where(live, L, 0.0)))
            if n_split == 1:
                o[b, h], m_out[b, h], l_out[b, h] = parts[0]
                continue
            Mz = torch.stack([x[1] for x in parts]).amax(0)
            wz = [x[2] * torch.exp(x[1] - Mz) for x in parts]
            Lz = sum(wz)
            o[b, h] = sum(x[0] * w[:, None] for x, w in zip(parts, wz)) / Lz.clamp_min(1e-20)[:, None]
            m_out[b, h], l_out[b, h] = Mz, Lz
    return o, m_out, l_out


@pytest.mark.parametrize("G,T", [(3, 1), (4, 17)], ids=["G=3", "68 verify rows"])
@pytest.mark.parametrize("int8_pages", [False, True], ids=["bf16", "int8"])
def test_tensor_core_decode_arithmetic_fits_pallas(int8_pages, G, T):
    """The reorganised arithmetic of the bf16 launches' decode tiles (P in
    bf16, int8 codes exact with the page scales on S columns and folded
    into P, per-warp horizon runs and horizon splits merged by the flash
    rule) against the JAX Pallas decode kernel in interpret mode, at the
    card's kernel-vs-plain tolerances: o within 2e-2 (bf16 output, P
    rounded), (m, l) within rtol 1e-3. G = 3 (a decode row group 3 of 16
    rows full) and 68 verify-style rows (G = 4, T = 17: more than one 16-row
    block); horizons of 37, 300 and 75 (no multiple of 16; 300 spans three
    splits and every warp) and an inactive slot."""
    rng = np.random.default_rng(7)
    Hkv, D, bs, M, B = 2, 64, 16, 20, 4
    R = T * G
    N = B * M + 1

    def bf(*shape):  # bf16 values, shared exactly by both sides
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    if int8_pages:
        codes = rng.integers(-127, 128, (2, Hkv, N, bs, D)).astype(np.int8)
        kc, vc = torch.from_numpy(codes[0]), torch.from_numpy(codes[1])
        ks, vs = (torch.from_numpy(rng.uniform(0.002, 0.02, N).astype(np.float32))
                  for _ in range(2))
        jsc = dict(k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy()))
        jk, jv = jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy())
    else:
        kc, vc, ks, vs, jsc = bf(Hkv, N, bs, D), bf(Hkv, N, bs, D), None, None, {}
        jk, jv = (jnp.asarray(c.float().numpy(), jnp.bfloat16) for c in (kc, vc))
    tables = torch.from_numpy(_tables(rng, B, M, N))
    lens = torch.tensor([37, 0, 300, 75], dtype=torch.int32)
    q = bf(B, Hkv * R, D)
    scale = D ** -0.5
    o, m, l = _tc_decode_arithmetic(q.reshape(B, Hkv, R, D), kc, vc, tables, lens,
                                    scale, 3, ks, vs)
    jo, jm, jl = j_decode(jnp.asarray(q.float().numpy(), jnp.bfloat16), jk, jv,
                          jnp.asarray(tables.numpy()), jnp.asarray(lens.numpy()),
                          scale, return_stats=True, group=G, interpret=True, **jsc)
    _close(o.reshape(B, Hkv * R, D), np.asarray(jo.astype(jnp.float32)),
           rtol=2e-2, atol=2e-2)
    live = [0, 2, 3]
    _close(m[live], np.asarray(jm)[live], rtol=1e-3, atol=1e-3)
    _close(l[live], np.asarray(jl)[live], rtol=1e-3, atol=1e-3)
    assert (o[1] == 0).all() and (m[1] == -1e30).all() and (l[1] == 0).all()
    # one split gives the same function (the warps' merge alone)
    o1, m1, l1 = _tc_decode_arithmetic(q.reshape(B, Hkv, R, D), kc, vc, tables,
                                       lens, scale, 1, ks, vs)
    _close(o1, o, rtol=2e-2, atol=2e-2)
    _close(m1, m, rtol=1e-5, atol=1e-5)
    _close(l1, l, rtol=1e-4, atol=1e-4)


def test_kv_cache_append_bit_exact_vs_pallas():
    rng = np.random.default_rng(4)
    L, B, Hkv, D, N, bs = 3, 4, 2, 16, 9, 8
    k_new = rng.standard_normal((L, B, Hkv, D)).astype(np.float32)
    v_new = rng.standard_normal((L, B, Hkv, D)).astype(np.float32)
    kc = rng.standard_normal((L, Hkv, N, bs, D)).astype(np.float32)
    vc = rng.standard_normal((L, Hkv, N, bs, D)).astype(np.float32)
    blk = np.asarray([3, 5, 1, 8], np.int32)
    off = np.asarray([0, 7, 4, 2], np.int32)
    tk, tv = _t(kc, vc)
    out_k, out_v = kv_cache_append(*_t(k_new, v_new), tk, tv, *_t(blk, off))
    assert out_k is tk and out_v is tv  # updated in place
    jk, jv = j_append(*_j(k_new, v_new, kc, vc, blk, off), interpret=True)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the per-layer slot writer lands the same rows (positions -> slots)
    tables = np.arange(1, 9, dtype=np.int32).reshape(B, 2)
    pos = np.asarray([0, 9, 4, 15], np.int32)
    got = att.write_decode_token_to_cache(
        *_t(kc[1], k_new[1], tables, pos))
    ref = jatt.write_decode_token_to_cache(*_j(kc[1], k_new[1], tables, pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_kernel_path_is_selected_by_device_never_rerouted(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel path, which
    raises without CUDA — the plain version is never a fallback."""
    from dynamo_tpu_torch.ops import kv_cache_update, paged_attention

    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(paged_attention, "paged_decode_attention_plain", boom)
    monkeypatch.setattr(kv_cache_update, "kv_cache_append_plain", boom)
    meta = dict(device="meta")
    q = torch.empty(2, 4, 64, **meta)
    kc = torch.empty(2, 5, 8, 64, **meta)
    tables = torch.empty(2, 2, dtype=torch.int32, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    before = paged_decode_attention.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        paged_decode_attention(q, kc, kc, tables, lens, 0.125)
    with pytest.raises(RuntimeError, match="CUDA"):
        kv_cache_append(torch.empty(1, 2, 2, 64, **meta),
                        torch.empty(1, 2, 2, 64, **meta),
                        torch.empty(1, 2, 5, 8, 64, **meta),
                        torch.empty(1, 2, 5, 8, 64, **meta), lens, lens)
    assert paged_decode_attention.launches == before


def test_sampling_ops_match_jax():
    rng = np.random.default_rng(5)
    B, V = 4, 64
    logits = rng.standard_normal((B, V)).astype(np.float32)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1.0  # tie: first wins
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    mask = rng.random((B, V)) < 0.2
    pens = (np.asarray([0.5, 0, 0.2, 0], np.float32),
            np.asarray([0, 0.3, 0.1, 0], np.float32),
            np.asarray([1.0, 1.3, 0.8, 1.0], np.float32))
    _close(sampling.apply_penalties(*_t(logits, counts, mask, *pens)),
           jsamp.apply_penalties(*_j(logits, counts, mask, *pens)))
    zeros = np.zeros(B, np.float32)
    greedy = sampling.sample_tokens(
        *_t(logits), None, *_t(zeros, zeros.astype(np.int32),
                               np.ones(B, np.float32)))
    jgreedy = jsamp.sample_tokens(
        *_j(logits), jsamp.make_keys(jnp.zeros(B, jnp.int32),
                                     jnp.zeros(B, jnp.int32)),
        *_j(zeros, zeros.astype(np.int32), np.ones(B, np.float32)))
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgreedy))
    assert int(greedy[2]) == 7
    chosen = np.asarray([1, 2, 3, 4], np.int32)
    (lp, ids, top), (jlp, jids, jtop) = (
        sampling.token_logprobs(*_t(logits, chosen)),
        jsamp.token_logprobs(*_j(logits, chosen)),
    )
    _close(lp, jlp, rtol=1e-5, atol=1e-5)
    _close(top, jtop, rtol=1e-5, atol=1e-5)
    # tied logits may list in either order
    np.testing.assert_array_equal(np.sort(ids.numpy()), np.sort(np.asarray(jids)))
    # top-k/top-p masks agree; a seeded row replays, and draws JAX's token
    tk = np.asarray([3, 0, 5, 0], np.int32)
    tp = np.asarray([1.0, 0.5, 0.9, 1.0], np.float32)
    _close(sampling._apply_topk_topp(*_t(logits, tk, tp)),
           jsamp._apply_topk_topp(*_j(logits, tk, tp)))
    temps = np.full(B, 0.7, np.float32)
    draws = [
        sampling.sample_tokens(
            *_t(logits), sampling.make_keys([11] * B, [3] * B),
            *_t(temps, tk, tp)).tolist()
        for _ in range(2)
    ]
    assert draws[0] == draws[1]
    jdraw = jsamp.sample_tokens(
        *_j(logits), jsamp.make_keys(jnp.full(B, 11, jnp.int32),
                                     jnp.full(B, 3, jnp.int32)),
        *_j(temps, tk, tp))
    assert draws[0] == np.asarray(jdraw).tolist()
