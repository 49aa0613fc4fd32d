"""KV head-layout rearrangement for mismatched prefill/decode layouts.

A copy of ``dynamo_tpu/ops/kv_rearrange.py`` over ``torch`` tensors. KV
travels between workers as a global ``[L, Hkv, n, bs, D]`` stack
(``disagg/transfer.py``), so what a receiver may have to do to it is a
permutation of the head axis:

  * **layout regroup**: engines may order kv heads "blocked"
    (shard-contiguous: shard i of tp=P owns heads [i*H/P, (i+1)*H/P)) or
    "interleaved" (round-robin: shard i owns heads i, i+P, i+2P, ...).
    Converting between them is a head-axis permutation.
  * **GQA replication**: a decode side with tp > num_kv_heads needs each
    kv head replicated tp/Hkv times.

The port's own layout is always ``blocked`` at tp = 1; the regroup matters
when a JAX peer with ``interleaved`` heads at tp > 1 sends to it. The
reference does these gathers in numpy or ``jnp`` outside any Pallas
kernel, and so does this module, with ``index_select`` on the tensor's own
device.
"""

from __future__ import annotations

import numpy as np
import torch


def _head_permutation(num_heads: int, tp: int, src_layout: str,
                      dst_layout: str) -> np.ndarray:
    """Permutation p with out[h] = in[p[h]] converting head order
    src_layout -> dst_layout for a tp-way sharding."""
    if src_layout == dst_layout:
        return np.arange(num_heads)
    if num_heads % tp:
        raise ValueError(f"{num_heads} heads not divisible by tp={tp}")
    per = num_heads // tp
    # interleaved order listed shard-major: position j (shard j//per,
    # slot r=j%per) holds head (j//per) + r*tp
    interleaved = np.arange(num_heads).reshape(per, tp).T.reshape(-1)
    if src_layout == "blocked" and dst_layout == "interleaved":
        return interleaved
    if src_layout == "interleaved" and dst_layout == "blocked":
        inv = np.empty(num_heads, np.int64)
        inv[interleaved] = np.arange(num_heads)
        return inv
    raise ValueError(f"unknown layouts {src_layout!r}->{dst_layout!r}")


def _take(kv: torch.Tensor, idx: np.ndarray, axis: int) -> torch.Tensor:
    return kv.index_select(axis, torch.as_tensor(idx, device=kv.device))


def regroup_heads(kv: torch.Tensor, tp: int, src_layout: str = "blocked",
                  dst_layout: str = "blocked", head_axis: int = 1):
    """Permute the kv-head axis between shard layouts. ``[L, Hkv, n, bs,
    D]`` stacks use head_axis=1; the identity returns ``kv`` itself."""
    perm = _head_permutation(kv.shape[head_axis], tp, src_layout, dst_layout)
    if (perm == np.arange(len(perm))).all():
        return kv
    return _take(kv, perm, head_axis)


def expand_kv_heads(kv: torch.Tensor, factor: int, head_axis: int = 1):
    """Replicate each kv head ``factor`` times (decode tp > num_kv_heads):
    shard i of the expanded stack then owns exactly one replica."""
    if factor == 1:
        return kv
    return _take(kv, np.repeat(np.arange(kv.shape[head_axis]), factor),
                 head_axis)


def layout_mismatched(src_layout: str, src_tp: int, dst_layout: str,
                      dst_tp: int) -> bool:
    """Does a delivery with the source's declared head ordering need the
    :func:`rearrange_for_decode` regroup before landing in a cache with
    the destination's? A foreign layout always does, and interleaved
    orderings are tp-DEPENDENT: the same layout name with another tp
    still permutes. One definition shared by the disagg bulk delivery,
    the streamed scatter sink and the fleet peer-pull landing."""
    return src_layout != dst_layout or (
        src_layout == "interleaved" and src_tp != dst_tp
    )


def rearrange_for_decode(kv: torch.Tensor, src_tp: int, dst_tp: int,
                         src_layout: str = "blocked",
                         dst_layout: str = "blocked", head_axis: int = 1):
    """Full prefill->decode adaptation: undo the source head ordering,
    apply the destination's. Interleaved orderings are tp-dependent, so
    interleaved->interleaved with src_tp != dst_tp is NOT an identity. No
    head replication happens here: the decode cache is a global
    ``[L, Hkv, ...]`` array (``expand_kv_heads`` is for per-shard export
    paths only)."""
    if src_layout != "blocked":
        kv = regroup_heads(kv, src_tp, src_layout, "blocked", head_axis)
    if dst_layout != "blocked":
        kv = regroup_heads(kv, dst_tp, "blocked", dst_layout, head_axis)
    return kv
