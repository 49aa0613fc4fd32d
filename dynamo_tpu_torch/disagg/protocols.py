"""Disaggregation wire types: a copy of ``dynamo_tpu/disagg/protocols.py``,
the same JSON bytes.

RemotePrefillRequest mirrors the reference system's ``remote_prefill.py``:
everything a prefill worker needs to compute the prompt's KV and the first
token, plus where to deliver the result. ``skip_blocks`` carries the decode
side's local prefix-cache hit, so only the uncached tail of the KV is
shipped.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional


@dataclass
class RemotePrefillRequest:
    request_id: str
    # the full PreprocessedRequest as a dict (token_ids, sampling, stops)
    request: dict
    # decode-side blocks already holding the first `skip_blocks` prompt
    # blocks (prefix-cache hit) — transfer starts after them
    skip_blocks: int
    # where the prefill worker delivers KV + first token:
    # ConnectionInfo dict of the decode host's KvTransferServer
    connection: dict
    # decode engine identity (diagnostics / metrics)
    engine_id: int = 0
    # W3C traceparent continuing the request's trace on the prefill
    # worker (None when tracing is off)
    trace: Optional[str] = None
    # decode-side wall clock at enqueue — the prefill worker derives the
    # queue-wait span from it (cross-host wall skew applies; the queue
    # wait is seconds-scale where it matters, so skew stays in the noise)
    enqueue_ts: float = 0.0

    def to_bytes(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "RemotePrefillRequest":
        d = json.loads(raw)
        # ignore unknown keys: version-skew safety for fields newer peers
        # may add (this is how `trace` itself shipped)
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


@dataclass
class DisaggConfig:
    """Conditional-disaggregation policy knobs
    (ref DisaggRouterConf, disagg_router.rs:25; docs/disagg_serving.md:46-52).

    A prompt goes to a remote prefill worker when its *uncached* prefill
    length exceeds ``max_local_prefill_length`` — unless the prefill
    queue is so deep that waiting would cost more than computing locally.
    """

    max_local_prefill_length: int = 512
    # remote prefill disabled above this queue depth (0 = no limit)
    max_prefill_queue_size: int = 0
    enabled: bool = True

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, raw) -> "DisaggConfig":
        if isinstance(raw, (bytes, bytearray)):
            raw = raw.decode()
        d = json.loads(raw)
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


def disagg_config_key(namespace: str, model: str) -> str:
    """Store key for the hot-reloadable policy
    (ref etcd path ``public/components/disagg_router/models/chat/{model}``)."""
    return f"{namespace}/components/disagg_router/models/{model}"
