"""The block plan of the latent kernels' tensor-core body, on the CPU.

``ops/mla_attention.tile_plan`` cuts a bf16 decode launch into row tiles,
column slabs and horizon splits (``split_ranges``: what the kernel takes
on the device). Each block's work, done here by ``latent_attention`` on
its rows, columns and positions, and the splits merged with the flash
rule, must give ``mla_paged_decode_attention_plain``'s (o, m, l) and the
JAX Pallas kernel's in interpret mode (f32, 1e-5), every output element
written by exactly one block: empty slots, a length of 1, lengths that
end mid-page, 16 rows per sequence (one 16-row tile) and 272 (a verify's
17 tokens x 16 heads in 64-row tiles), one slab and two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import mla_attention_pallas as jmla
from dynamo_tpu_torch.ops import mla_attention as tmla

BS = 16


def _merge(parts):
    """Flash merge of normalized partials (o, m, l) of one row set."""
    m = torch.stack([p[1] for p in parts]).amax(0)
    w = [p[2] * torch.exp(p[1] - m) for p in parts]
    l = sum(w)
    o = sum(wz[..., None] * p[0] for wz, p in zip(w, parts))
    return o / l.clamp_min(1e-20)[..., None], m, l


def _planned(q_eff, q_pe, cc, pc, tables, lens, scale, plan):
    """The decode launch block by block, as the kernel cuts it."""
    B, rows, C = q_eff.shape
    o = torch.full((B, rows, C), float("nan"))
    m = torch.full((B, rows), float("nan"))
    l = torch.full((B, rows), float("nan"))
    c_all = tmla.gather_latents(cc, tables)  # [B, M*bs, C]
    pe_all = tmla.gather_latents(pc, tables)
    for b in range(B):
        n = min(int(lens[b]), tables.shape[1] * BS)
        ranges = tmla.split_ranges(n, plan)
        assert len(ranges) <= plan.n_split
        assert all(e - s >= min(n, plan.min_steps * plan.kvt) for s, e in ranges[:-1])
        for rt in range(plan.n_rt):
            r0, r1 = rt * plan.rows, min(rows, (rt + 1) * plan.rows)
            for sl in range(plan.n_slabs):
                c0, c1 = sl * plan.slab, min(C, (sl + 1) * plan.slab)
                parts = []
                for s, e in ranges:
                    if e == s:  # the empty slot's one block: the empty row
                        parts.append((torch.zeros(1, r1 - r0, C),
                                      torch.full((1, r1 - r0), tmla.NEG_INF),
                                      torch.zeros(1, r1 - r0)))
                        continue
                    lim = torch.tensor([e - s - 1])
                    parts.append(tmla.latent_attention(
                        q_eff[b:b + 1, r0:r1], q_pe[b:b + 1, r0:r1],
                        c_all[b:b + 1, s:e], pe_all[b:b + 1, s:e], lim, scale))
                po, pm, pl = _merge(parts)
                assert bool(torch.isnan(o[b, r0:r1, c0:c1]).all())  # once
                o[b, r0:r1, c0:c1] = po[0, :, c0:c1]
                m[b, r0:r1], l[b, r0:r1] = pm[0], pl[0]
    assert not bool(torch.isnan(o).any() or torch.isnan(m).any())
    return o, m, l


@pytest.mark.parametrize("rows,C,R", [(16, 128, 8), (272, 640, 64)],
                         ids=["16rows-1slab", "272rows-2slabs"])
def test_mla_decode_tile_plan_fits_plain_and_pallas(rows, C, R):
    rng = np.random.default_rng(5)
    B, M = 4, 20
    N = B * M + 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q_eff, q_pe = f(B, rows, C), f(B, rows, R)
    cc, pc = f(1, N, BS, C) * 0.3, f(1, N, BS, R) * 0.3
    tables = np.arange(1, N, dtype=np.int32).reshape(B, M)
    lens = np.asarray([0, 1, 3 * BS + 5, 19 * BS + 12], np.int32)
    plan = tmla.tile_plan(C, R, rows, B)
    assert plan.rows == (16 if rows <= 16 else 64) and plan.n_slabs == -(-C // 512)
    assert plan.n_split > 1 and len(tmla.split_ranges(int(lens[-1]), plan)) > 1
    t = [torch.from_numpy(x) for x in (q_eff, q_pe, cc, pc, tables, lens)]
    got = _planned(*t, 0.07, plan)
    twin = tmla.mla_paged_decode_attention_plain(*t, 0.07, return_stats=True)
    ref = jmla.mla_paged_decode_attention(
        *[jnp.asarray(x) for x in (q_eff, q_pe, cc, pc, tables, lens)], 0.07,
        return_stats=True, interpret=True)
    for a, b, c in zip(got, twin, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(c)[:, :rows],
                                   rtol=1e-5, atol=1e-5)
    assert float(got[0][0].abs().max()) == 0.0 and float(got[2][0].max()) == 0.0
    assert bool((got[1][0] == -1e30).all())


def test_mla_kernel_widths_are_the_reference_gate():
    """kv_lora_rank % 128 == 0 and any rope width >= 1; every published MLA
    width among them, and on the tensor-core body (the rest on the
    CUDA-core body). At every tensor-core width the block plan fits a
    block's shared memory, over bf16 pages and over fp8 pages (whose staged
    codes sit beside the ring: a 16-row decode tile that cannot hold them
    at two stages takes 64-row tiles; bf16 plans keep 16-row tiles)."""
    for C, R in [(512, 64), (256, 32), (128, 64), (384, 16), (640, 64),
                 (640, 128), (128, 1), (128, 5)]:
        assert tmla.takes_widths(C, R) and tmla.tc_takes(C, R), (C, R)
        dp = tmla.padded_row(C, R)
        for fp8 in (False, True):
            kd = C + -(-R // 16) * 16 if fp8 else 0
            for rows, B in ((16, 8), (64, 8), (8192, 0)):
                plan = tmla.tile_plan(C, R, rows, B, fp8=fp8)
                assert tmla._tc_smem(plan.wpg, dp, plan.stages, kd) <= tmla._SMEM_MAX
                if rows == 16 and not fp8:
                    assert plan.wpg == 8, (C, R)
    # V2-Lite's widths over fp8 pages: 16-row decode tiles at two stages,
    # 64-row tiles at three (231424 bytes exactly)
    assert tmla.tile_plan(512, 64, 16, 8, fp8=True)[:2] == (8, 64)
    assert tmla.tile_plan(512, 64, 512 * 16, 0, fp8=True).stages == 3
    assert tmla.tile_plan(640, 128, 16, 8, fp8=True).wpg == 2
    for C, R in [(768, 64), (512, 129), (512, 160), (2048, 64)]:
        assert tmla.takes_widths(C, R) and not tmla.tc_takes(C, R), (C, R)
    for C, R in [(32, 8), (500, 64), (512, 0)]:
        assert not tmla.takes_widths(C, R), (C, R)
