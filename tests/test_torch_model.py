"""The port's Llama forward against the JAX package's, same weights.

``prefill`` and merged ``decode_window`` are held to the JAX functions on
their XLA path (``use_pallas=False``), ``mixed_step`` to the JAX fused
forward with the ragged Pallas kernel in interpret mode. Tiny config at
f32: logits within 1e-4, greedy tokens identical, caches equal to
tolerance; one bf16 case at 3e-2 (bf16 rounds at other places in the two
frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.weights import from_jax_params

N_BLOCKS, BS = 40, 4


def _setup(dtype="float32", seed=0):
    jcfg = JaxModelConfig.tiny(dtype=dtype)
    cfg = ModelConfig.tiny(dtype=dtype)
    jparams = jllama.init_params(jcfg, jax.random.key(seed))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    rng = np.random.default_rng(seed)
    shape = llama.kv_cache_shapes(cfg, N_BLOCKS, BS)[0]
    kc = rng.standard_normal(shape).astype(np.float32) * 0.5
    vc = rng.standard_normal(shape).astype(np.float32) * 0.5
    return jcfg, cfg, jparams, params, kc, vc, rng


def _caches(kc, vc, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ((jnp.asarray(kc, jdt), jnp.asarray(vc, jdt)),
            (torch.from_numpy(kc.copy()).to(tdt),
             torch.from_numpy(vc.copy()).to(tdt)))


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_prefill_matches_jax(dtype, tol):
    jcfg, cfg, jparams, params, kc, vc, rng = _setup(dtype)
    T, hist, valid = 16, 8, 11
    table = np.asarray(rng.permutation(np.arange(1, N_BLOCKS))[:8], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    (jk, jv), (tk, tv) = _caches(kc, vc, dtype)
    jl, jk, jv = jllama.prefill(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(table),
        jnp.int32(hist), jnp.int32(valid), jk, jv, use_pallas=False,
    )
    tl, tk, tv = llama.prefill(
        params, cfg, torch.from_numpy(tokens), torch.from_numpy(table),
        hist, valid, tk, tv,
    )
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=tol, atol=tol)
    if dtype == "float32":
        assert int(torch.argmax(tl)) == int(jnp.argmax(jl))
        # the real rows' K landed alike (padded rows are garbage by
        # contract: the two paths mask them differently)
        pos = np.arange(hist, hist + valid)
        slots = (slice(None), slice(None), table[pos // BS], pos % BS)
        np.testing.assert_allclose(_np(tk)[slots], _np(jk)[slots],
                                   rtol=tol, atol=tol)


def test_rope_matches_jax_default_and_llama3_scaling():
    scaling = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                   high_freq_factor=4.0, original_max_position_embeddings=8192)
    x = np.random.default_rng(7).standard_normal((5, 3, 128)).astype(np.float32)
    pos = np.arange(4000, 4005, dtype=np.int32)
    for rs in (None, scaling):
        jcfg = JaxModelConfig.llama3_8b(num_layers=1, rope_scaling=rs)
        cfg = ModelConfig.llama3_8b(num_layers=1, rope_scaling=rs)
        inv, jinv = llama._rope_freqs(cfg), jllama._rope_freqs(jcfg)
        np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6)
        np.testing.assert_allclose(
            llama.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), inv),
            jllama.apply_rope(jnp.asarray(x), jnp.asarray(pos), jinv),
            rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="longrope"):
        llama._rope_freqs(ModelConfig.tiny(rope_scaling={"rope_type": "longrope"}))


def test_merged_decode_window_matches_jax():
    jcfg, cfg, jparams, params, kc, vc, rng = _setup()
    B, M, n = 3, 6, 3
    tables = np.asarray(
        rng.permutation(np.arange(1, N_BLOCKS))[: B * M].reshape(B, M), np.int32
    )
    tables[2] = 0  # inactive slot
    seq_lens = np.asarray([5, 13, 0], np.int32)
    positions = np.maximum(seq_lens - 1, 0).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    zeros_f, zeros_i = np.zeros(B, np.float32), np.zeros(B, np.int32)
    ones_f = np.ones(B, np.float32)
    (jk, jv), (tk, tv) = _caches(kc, vc, "float32")
    jtoks, jk, jv = jllama.decode_window(
        jparams, jcfg, *(jnp.asarray(a) for a in (
            tokens, positions, tables, seq_lens, zeros_i, zeros_i, zeros_f,
            zeros_i, ones_f)),
        jk, jv, n_steps=n, use_pallas=False,
    )
    ttoks, tk, tv = llama.decode_window(
        params, cfg, *(torch.from_numpy(a) for a in (
            tokens, positions, tables, seq_lens)), [0] * B, [0] * B,
        *(torch.from_numpy(a) for a in (zeros_f, zeros_i, ones_f)),
        tk, tv, n_steps=n,
    )
    np.testing.assert_array_equal(ttoks.numpy()[:, :2], np.asarray(jtoks)[:, :2])
    # every written slot agrees (page 0 is trash: inactive rows land there)
    np.testing.assert_allclose(_np(tk)[:, :, 1:], _np(jk)[:, :, 1:],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tv)[:, :, 1:], _np(jv)[:, :, 1:],
                               rtol=1e-4, atol=1e-4)


def test_mixed_step_matches_jax_fused_forward():
    jcfg, cfg, jparams, params, kc, vc, rng = _setup()
    B, M, MP, T = 2, 8, 2, 16
    pages = rng.permutation(np.arange(1, N_BLOCKS))
    d_tables = np.asarray(pages[: B * M].reshape(B, M), np.int32)
    p_tables = np.zeros((MP, M), np.int32)
    p_tables[0] = pages[B * M : (B + 1) * M]  # segment 1 is dead
    d_seq_lens = np.asarray([9, 20], np.int32)
    d_positions = d_seq_lens - 1
    d_tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    p_tokens = rng.integers(0, cfg.vocab_size, (MP, T)).astype(np.int32)
    p_hists = np.asarray([4, 0], np.int32)
    p_valids = np.asarray([12, 0], np.int32)
    zeros_f, zeros_i = np.zeros(B, np.float32), np.zeros(B, np.int32)
    ones_f = np.ones(B, np.float32)
    dec = (d_tokens, d_positions, d_tables, d_seq_lens)
    pre = (p_tokens, p_tables, p_hists, p_valids)
    (jk, jv), (tk, tv) = _caches(kc, vc, "float32")
    jn, jpl, jk, jv = jllama.mixed_step(
        jparams, jcfg, *map(jnp.asarray, dec), *map(jnp.asarray, (
            zeros_i, zeros_i, zeros_f, zeros_i, ones_f)),
        *map(jnp.asarray, pre), jk, jv, use_pallas=True, interpret=True,
    )
    tn, tpl, tk, tv = llama.mixed_step(
        params, cfg, *map(torch.from_numpy, dec), [0] * B, [0] * B,
        *map(torch.from_numpy, (zeros_f, zeros_i, ones_f)),
        *map(torch.from_numpy, pre), tk, tv,
    )
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(_np(tpl)[0], _np(jpl)[0], rtol=1e-4, atol=1e-4)
    # the decode tokens' and the live segment's real rows landed alike
    # (padded segment rows are garbage by contract)
    pos = np.arange(p_hists[0], p_hists[0] + p_valids[0])
    blk = np.concatenate([d_tables[np.arange(B), d_positions // BS],
                          p_tables[0][pos // BS]])
    off = np.concatenate([d_positions % BS, pos % BS])
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(t)[:, :, blk, off], _np(j)[:, :, blk, off],
                                   rtol=1e-4, atol=1e-4)
