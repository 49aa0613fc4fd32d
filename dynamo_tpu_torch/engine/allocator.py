"""Paged KV block allocator with prefix reuse.

Host-side bookkeeping for the device-resident paged KV cache (the
reference's equivalent machinery is vLLM's block manager plus the Rust
reuse pool, lib/llm/src/kv/{manager,reuse}.rs). Responsibilities:

  * free-list allocation of fixed-size token blocks (block 0 is reserved
    as the trash block — padded-position writes land there harmlessly),
  * content addressing: full blocks carry a chained sequence hash
    (ref lib/llm/src/tokens.rs SequenceHash) so identical prefixes map to
    identical block chains,
  * prefix-cache reuse: freed blocks go to an LRU reuse pool indexed by
    sequence hash; new requests claim matching chains (radix-style match),
  * refcounting: shared prefix blocks are copy-free (multiple sequences
    reference the same immutable full block — ref kv/reserved.rs).

A copy of ``dynamo_tpu/engine/allocator.py`` (block hashes stay
byte-identical to the reference's, so a torch worker's blocks address the
same prefix-cache entries). The event hooks (block stored/removed) are
kept for the KV router publisher a later slice ports.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional, Sequence


def block_token_hash(tokens: Sequence[int]) -> int:
    """Content hash of one block's tokens (local hash, ref
    kv_router/indexer.rs:87 LocalBlockHash over token bytes)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(b"tok:" + b",".join(str(t).encode() for t in tokens))
    return int.from_bytes(h.digest(), "big")


def chain_hash(parent: Optional[int], local: int) -> int:
    """Chained sequence hash (ref tokens.rs:166-202 SequenceHash)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(b"seq:" + (parent or 0).to_bytes(8, "big") + local.to_bytes(8, "big"))
    return int.from_bytes(h.digest(), "big")


def model_hash_salt(model: Optional[str]) -> Optional[int]:
    """Per-model root of the chain-hash namespace (multi-model serving).

    The chained sequence hash is the cross-process address of a KV block
    — radix index entries, reuse-pool keys, wire pulls all speak it. Two
    models sharing a token-identical prompt must NEVER share that
    address (an adapter's KV is a different function of the same
    tokens), so the ADAPTER's name hashes into the chain as a synthetic
    root parent. ``None``/empty (the base model) returns None — the
    chain starts unsalted, byte-identical to every pre-multi-model
    fleet: no hash drift for existing deployments, and base-model
    traffic on an adapter-serving fleet still prefix-shares with
    base-only peers."""
    if not model:
        return None
    h = hashlib.blake2b(digest_size=8)
    h.update(b"model:" + model.encode())
    return int.from_bytes(h.digest(), "big")


def sequence_block_hashes(
    tokens: Sequence[int], block_size: int, salt: Optional[int] = None
) -> list[tuple[int, int]]:
    """[(local_hash, chained_hash)] for each *full* block of the sequence.

    The pure-Python walk of the JAX package's hasher (its native C++ batch
    hasher produces bit-identical output, so hashes match either way):
    hashes address KV blocks across processes. ``salt``
    (``model_hash_salt``) roots the chain in a per-model namespace.
    """
    out: list[tuple[int, int]] = []
    parent: Optional[int] = salt
    for i in range(0, len(tokens) - len(tokens) % block_size, block_size):
        local = block_token_hash(tokens[i : i + block_size])
        parent = chain_hash(parent, local)
        out.append((local, parent))
    return out


@dataclass
class Block:
    idx: int  # device block index
    ref_count: int = 0
    seq_hash: Optional[int] = None  # chained hash when full+immutable
    local_hash: Optional[int] = None
    # restored via a router prefetch hint and not yet claimed — cleared
    # (and counted as h2d_prefetch_hits) on the first match_prefix claim
    prefetched: bool = False


class BlockAllocator:
    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        on_stored: Optional[Callable[[Block, Optional[int]], None]] = None,
        on_removed: Optional[Callable[[list[int]], None]] = None,
        on_evict: Optional[Callable[[int, Block], None]] = None,
    ):
        """``num_blocks`` includes the reserved trash block 0."""
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._blocks = [Block(i) for i in range(num_blocks)]
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))  # stack; 0 reserved
        # full immutable blocks by chained hash (active, refcounted)
        self._by_hash: dict[int, int] = {}
        # reuse pool: freed-but-still-resident blocks, LRU ordered
        self._reuse: OrderedDict[int, int] = OrderedDict()  # seq_hash -> idx
        self.on_stored = on_stored
        self.on_removed = on_removed
        # fired when a reuse-pool block is about to be repurposed — the
        # offload tier's chance to copy it down (engine/offload.py)
        self.on_evict = on_evict
        # fired INSTEAD of on_removed when an offload tier takes the
        # evicted block (set alongside on_evict by the KV-event
        # publisher): the worker still holds the KV, one tier down, so
        # the router's radix index must keep counting it as residency —
        # the true removal arrives later via OffloadManager.on_dropped
        # when the block leaves the last local tier
        self.on_demoted: Optional[Callable[[list[int]], None]] = None
        # fired with the device block index every time a block becomes
        # fresh-mutable (free-list pop OR reuse-pool eviction) — the
        # engine's int8 device cache resets the block's scale-plane
        # entries here so stale absmax scales never survive recycling.
        # match_prefix claims deliberately do NOT fire it: a claimed
        # prefix block keeps its content AND its scales.
        self.on_allocated: Optional[Callable[[int], None]] = None

    # ---- stats ----
    @property
    def free_count(self) -> int:
        return len(self._free) + len(self._reuse)

    @property
    def used_count(self) -> int:
        return self.num_blocks - 1 - self.free_count

    @property
    def resident_count(self) -> int:
        """Blocks holding LIVE KV content: ref'd by sequences or parked
        in the content-addressed reuse pool (claimable prefix cache).
        This is what a live reshard actually re-lays — the reuse pool's
        prefix blocks survive a morph exactly like active ones."""
        return self.num_blocks - 1 - len(self._free)

    def usage(self) -> float:
        cap = self.num_blocks - 1
        return self.used_count / cap if cap else 0.0

    # ---- allocation ----
    def _pop_free(self) -> Optional[Block]:
        if self._free:
            b = self._blocks[self._free.pop()]
        elif self._reuse:
            # evict LRU from the reuse pool
            seq_hash, idx = self._reuse.popitem(last=False)
            b = self._blocks[idx]
            if self.on_evict:
                self.on_evict(seq_hash, b)
            if self.on_evict and self.on_demoted:
                # device -> offload tier: a demotion, not a removal
                self.on_demoted([seq_hash])
            elif self.on_removed:
                self.on_removed([seq_hash])
            b.seq_hash = None
            b.local_hash = None
            b.prefetched = False
        else:
            return None
        b.ref_count = 1
        if self.on_allocated:
            self.on_allocated(b.idx)
        return b

    def match_prefix(
        self,
        tokens: Sequence[int],
        hashes: Optional[list[tuple[int, int]]] = None,
    ) -> list[Block]:
        """Longest chain of cached full blocks matching the token prefix.
        Claims refs on the matched blocks (caller owns them). ``hashes``
        may carry precomputed ``sequence_block_hashes(tokens, block_size)``
        to avoid re-hashing."""
        matched: list[Block] = []
        if hashes is None:
            hashes = sequence_block_hashes(tokens, self.block_size)
        for _local, seq_hash in hashes:
            idx = self._by_hash.get(seq_hash)
            if idx is None and seq_hash in self._reuse:
                idx = self._reuse.pop(seq_hash)
                self._by_hash[seq_hash] = idx
            if idx is None:
                break
            b = self._blocks[idx]
            b.ref_count += 1
            matched.append(b)
        return matched

    def allocate(self, n: int) -> Optional[list[Block]]:
        """n fresh (mutable) blocks, or None if insufficient."""
        if self.free_count < n:
            return None
        out = []
        for _ in range(n):
            b = self._pop_free()
            assert b is not None
            out.append(b)
        return out

    def has_hash(self, seq_hash: int) -> bool:
        """Non-claiming device-residency probe (active OR reuse pool) —
        the prefetch path's radix check before it touches the host tier."""
        return seq_hash in self._by_hash or seq_hash in self._reuse

    def adopt_restored(
        self,
        block: Block,
        seq_hash: int,
        local_hash: Optional[int],
        parent_hash: Optional[int],
    ) -> bool:
        """Content-address a block whose KV was just restored from a
        lower tier (router-hinted prefetch): like
        :meth:`commit_full_block` but the hashes arrive precomputed from
        the hint instead of from tokens. The caller still holds the
        allocation ref; its :meth:`free` parks the block in the reuse
        pool where match_prefix claims it.

        Returns False without adopting when the hash is ALREADY device
        resident (a request raced its own hint and committed first):
        registering a second block under the hash would let free() park
        it over the existing reuse entry and orphan that block. The
        un-adopted block stays plain and free() returns it to the free
        list."""
        if self.has_hash(seq_hash):
            return False
        block.seq_hash = seq_hash
        block.local_hash = local_hash
        self._by_hash[seq_hash] = block.idx
        if self.on_stored:
            self.on_stored(block, parent_hash)
        return True

    def commit_full_block(self, block: Block, tokens: Sequence[int], parent_hash: Optional[int]) -> int:
        """Mark a now-full block immutable + content-addressed; returns its
        chained hash. Fires the stored event (feeds the KV router)."""
        local = block_token_hash(tokens)
        seq_hash = chain_hash(parent_hash, local)
        block.local_hash = local
        existing = self._by_hash.get(seq_hash)
        if existing is not None and existing != block.idx:
            # another sequence committed identical content first; keep ours
            # as a duplicate (device copy dedup is a later optimization)
            pass
        else:
            self._by_hash[seq_hash] = block.idx
        block.seq_hash = seq_hash
        if self.on_stored:
            self.on_stored(block, parent_hash)
        return seq_hash

    def free(self, blocks: list[Block]) -> None:
        """Release refs; full content-addressed blocks go to the reuse pool,
        partial blocks go straight to the free list."""
        removed_hashes: list[int] = []
        for b in blocks:
            if b.idx == 0:
                continue
            b.ref_count -= 1
            if b.ref_count > 0:
                continue
            if b.seq_hash is not None and self._by_hash.get(b.seq_hash) == b.idx:
                del self._by_hash[b.seq_hash]
                if b.seq_hash not in self._reuse:
                    self._reuse[b.seq_hash] = b.idx
                    self._reuse.move_to_end(b.seq_hash)
                else:
                    # belt-and-braces vs adopt_restored's residency
                    # check: parking over an existing reuse entry would
                    # orphan that block (ref 0, in neither _free nor
                    # _reuse) — the duplicate goes to the free list
                    b.seq_hash = None
                    b.local_hash = None
                    b.prefetched = False
                    self._free.append(b.idx)
            else:
                b.seq_hash = None
                b.local_hash = None
                b.prefetched = False
                self._free.append(b.idx)
        if removed_hashes and self.on_removed:
            self.on_removed(removed_hashes)

    def reset(self) -> None:
        for b in self._blocks:
            b.ref_count = 0
            b.seq_hash = None
            b.local_hash = None
            b.prefetched = False
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._by_hash.clear()
        self._reuse.clear()
