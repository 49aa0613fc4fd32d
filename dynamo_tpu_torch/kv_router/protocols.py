"""KV event schema: a copy of ``dynamo_tpu/kv_router/protocols.py`` (the
reference's lib/llm/src/kv_router/protocols.rs:19-98), byte for byte on the
bus.

Two hash kinds, as in the reference:
  * ``tokens_hash`` — content hash of one block's tokens (LocalBlockHash),
  * ``block_hash``  — chained sequence hash (ExternalSequenceBlockHash):
    hash(parent_chain, tokens_hash). The chain hash is position-dependent,
    so equal chains <=> equal full prefixes — the index key.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

KV_EVENT_SUBJECT = "kv_events"
KV_HIT_RATE_SUBJECT = "kv-hit-rate"
KV_PREFETCH_SUBJECT = "kv-prefetch"
#: fleet prefix cache: a routed worker whose local tiers miss asks the
#: peer named in its kv-prefetch hint for the chain's continuation; the
#: peer answers by pushing the blocks over the TCP transfer plane
#: (disagg/transfer.py framing + ack) to the requester's connect-back
#: address. The bus carries only the negotiation, never the KV bytes
KV_PEER_FETCH_SUBJECT = "kv-peer-fetch"

#: hard cap on blocks per prefetch hint: bounds message size and the
#: host->device burst one hint can trigger on the worker
KV_PREFETCH_MAX_BLOCKS = 512


@dataclass
class StoredBlock:
    block_hash: int  # chained
    tokens_hash: int  # local


@dataclass
class KvCacheEvent:
    """Stored (with parent linkage), Removed, or Demoted.

    ``demoted`` = the block left the device cache for the worker's
    offload tiers (host DRAM / disk): the worker still holds the KV —
    the index keeps the residency (that is what makes the fleet one
    prefix cache) but tags it offload-tier so routing can tell a
    device hit from a restorable one. The matching ``removed`` arrives
    only when the block leaves the worker's LAST tier."""

    kind: str  # "stored" | "removed" | "demoted"
    parent_hash: Optional[int] = None
    blocks: list[StoredBlock] = field(default_factory=list)
    block_hashes: list[int] = field(default_factory=list)

    @staticmethod
    def stored(parent_hash: Optional[int], blocks: list[StoredBlock]) -> "KvCacheEvent":
        return KvCacheEvent(kind="stored", parent_hash=parent_hash, blocks=blocks)

    @staticmethod
    def removed(block_hashes: list[int]) -> "KvCacheEvent":
        return KvCacheEvent(kind="removed", block_hashes=block_hashes)

    @staticmethod
    def demoted(block_hashes: list[int]) -> "KvCacheEvent":
        return KvCacheEvent(kind="demoted", block_hashes=block_hashes)


@dataclass
class RouterEvent:
    worker_id: int
    event: KvCacheEvent
    event_id: int = 0

    def to_bytes(self) -> bytes:
        d = {
            "worker_id": self.worker_id,
            "event_id": self.event_id,
            "kind": self.event.kind,
            "parent_hash": self.event.parent_hash,
            "blocks": [[b.block_hash, b.tokens_hash] for b in self.event.blocks],
            "block_hashes": self.event.block_hashes,
        }
        return json.dumps(d).encode()

    @staticmethod
    def from_bytes(raw: bytes) -> "RouterEvent":
        d = json.loads(raw)
        return RouterEvent(
            worker_id=d["worker_id"],
            event_id=d.get("event_id", 0),
            event=KvCacheEvent(
                kind=d["kind"],
                parent_hash=d.get("parent_hash"),
                blocks=[StoredBlock(b[0], b[1]) for b in d.get("blocks", [])],
                block_hashes=d.get("block_hashes", []),
            ),
        )


@dataclass
class KvPrefetchHint:
    """Router -> chosen worker, published the moment a request is routed
    to a worker whose device radix match does NOT cover the prompt: the
    prompt's full block-hash chain as (tokens_hash, block_hash) pairs in
    prompt order. The worker probes its own tiers against the chain and
    starts uploading the host-resident continuation BEFORE the request
    itself arrives (PRESERVE, arxiv 2501.08192), so admission claims the
    blocks as ordinary device prefix hits.

    ``peer_worker_id``/``peer_blocks`` (fleet prefix cache): the peer
    whose radix chain covers the prompt deeper than the routed worker's
    own tiers, and to what depth. The worker re-probes its local tiers
    first and, when they fall short, pulls the continuation from the
    peer over the transfer plane (kv-peer-fetch) before the restore.
    Advisory like the rest of the hint — a dead or mistaken peer just
    costs the pull attempt; the request recomputes.

    ``model`` (PRESERVE-style weight prefetch): the routed model or
    adapter name, so the worker can pre-stage its weights alongside
    the KV restore — today's workers resolve it to a stat-counted
    no-op hook (engine.pre_stage_weights), wiring the call path the
    multi-model work lands on warm. Absent on old routers; ignored by
    old workers (tolerant decode both ways)."""

    worker_id: int
    blocks: list  # [[tokens_hash, block_hash], ...] prompt order
    peer_worker_id: Optional[int] = None
    peer_blocks: int = 0
    model: Optional[str] = None

    def to_bytes(self) -> bytes:
        return json.dumps(
            {"worker_id": self.worker_id, "blocks": self.blocks,
             "peer_worker_id": self.peer_worker_id,
             "peer_blocks": self.peer_blocks,
             "model": self.model}
        ).encode()

    @staticmethod
    def from_bytes(raw: bytes) -> "KvPrefetchHint":
        d = json.loads(raw)
        peer = d.get("peer_worker_id")
        model = d.get("model")
        return KvPrefetchHint(
            worker_id=d["worker_id"],
            blocks=[[int(a), int(b)] for a, b in d.get("blocks", [])],
            peer_worker_id=int(peer) if peer is not None else None,
            peer_blocks=int(d.get("peer_blocks") or 0),
            model=str(model) if model else None,
        )


@dataclass
class KvPeerFetchRequest:
    """Worker -> peer negotiation for one fleet-tier prefix pull: the
    requested chain (hashes PAST the requester's local coverage, prompt
    order) plus the requester's transfer-plane connect-back address.
    The peer probes its host/disk tiers and pushes the longest
    consecutive resident run as one bulk KV transfer keyed by
    ``request_id`` (or an error delivery on a total miss, so the
    requester doesn't wait out its timeout). The KV bytes never touch
    the bus."""

    peer_worker_id: int  # the peer asked to serve
    src_worker_id: int  # the requester (logging/metrics)
    request_id: str  # transfer-plane correlation id
    hashes: list  # chained block hashes, prompt order
    connection: dict  # requester's KvTransferServer ConnectionInfo
    #: wire-codec capability (disagg/transfer.KV_QUANT_WIRE_VERSION):
    #: the requester accepts int8/fp8 payloads + scale frames and
    #: dequantizes on landing. 0/absent (legacy pullers) makes the
    #: serving peer dequantize its stored blocks to full width first —
    #: the quant/no-quant skew matrix degrades to bytes, never errors.
    accept_quant: int = 0

    def to_bytes(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @staticmethod
    def from_bytes(raw: bytes) -> "KvPeerFetchRequest":
        d = json.loads(raw)
        return KvPeerFetchRequest(
            peer_worker_id=int(d["peer_worker_id"]),
            src_worker_id=int(d.get("src_worker_id", 0)),
            request_id=str(d["request_id"]),
            hashes=[int(h) for h in d.get("hashes", [])],
            connection=d.get("connection") or {},
            accept_quant=int(d.get("accept_quant") or 0),
        )


@dataclass
class KVHitRateEvent:
    """Emitted per routing decision (ref scheduler.rs:28-32).

    ``predicted_ttft_ms`` carries the cost model's prediction for the
    chosen worker when the decision was cost-aware (-1 = overlap-mode
    fallback), so the metrics component can gauge routing's view of the
    fleet without a second event plane. Version skew: this decoder
    tolerates old events (field defaulted); a pre-field consumer
    decoding a NEW event drops it as a bad event for one upgrade
    window — hit-rate gauges are advisory, nothing routes on them."""

    # identifies the routed worker for operators replaying decision
    # events; the metrics gauges deliberately aggregate fleet-wide
    worker_id: int
    isl_blocks: int
    overlap_blocks: int
    predicted_ttft_ms: float = -1.0

    def to_bytes(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @staticmethod
    def from_bytes(raw: bytes) -> "KVHitRateEvent":
        d = json.loads(raw)
        return KVHitRateEvent(
            worker_id=d["worker_id"],
            isl_blocks=d["isl_blocks"],
            overlap_blocks=d["overlap_blocks"],
            predicted_ttft_ms=float(d.get("predicted_ttft_ms", -1.0)),
        )
