"""Migration policy knobs + disconnect classification.

A copy of ``dynamo_tpu/resilience/policy.py``: the same signal text,
signatures and classification, so a frontend of either package migrates
the other's streams.

The migration layer only ever retries failures that a *different worker*
can plausibly absorb. Classification is three-way:

  * ``WORKER_LOST`` — the stream died with a worker-death signature:
    the response-plane TCP connection truncated/reset, the worker's
    ingress aborted on shutdown, a drain handed the stream off, or the
    fault harness killed the worker. The worker's discovery key (bound
    to its primary lease) vanishes with it — re-dispatch immediately,
    the router will not pick the corpse.
  * ``TRANSIENT`` — the *dispatch* failed before or without a worker
    verdict (hub connection lost mid-request, no responders during a
    membership gap, connect-back timeout). Retry after a short jittered
    backoff; the control plane heals underneath.
  * ``FATAL`` — the worker answered with a deterministic engine error
    (bad request, capacity, model failure). Another worker would say
    the same thing: surface it to the client unchanged.

Lease loss vs. TCP blip: when the classifier is given the discovery
client and the routed worker id (kv_router stamps it into the request
annotations), a worker-lost signature is refined — instance gone from
the store watch means lease loss (``lease_lost``); instance still
registered means the stream broke while the worker lives, which retries
with the transient backoff instead (the same worker may legitimately be
re-picked).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

#: terminal-chunk text a draining worker attaches when it hands an
#: in-flight stream back (engine._handoff_seq); carries the
#: "worker draining" signature below so migration re-dispatches it
MIGRATION_SIGNAL = "worker draining: stream handed off for migration"

#: error-message signatures that mean "the worker is gone, the request
#: is not at fault" (tcp.py truncation, component.py shutdown abort,
#: drain handoff, fault harness, engine scheduler death)
WORKER_LOST_SIGNATURES = (
    "response stream truncated",
    "worker shutdown: stream aborted",
    "worker hung up",
    "worker draining",
    "fault injected",
    "engine stopped",
)


class FailureKind(str, enum.Enum):
    WORKER_LOST = "worker_lost"
    LEASE_LOST = "lease_lost"  # worker-lost refined by the store watch
    TRANSIENT = "transient"
    FATAL = "fatal"

    @property
    def retryable(self) -> bool:
        return self is not FailureKind.FATAL


@dataclass
class MigrationPolicy:
    """Frontend migration knobs (dynamo_run --no-migration /
    --max-migrations / --migration-deadline)."""

    #: master off-switch: disabled => every failure surfaces unchanged
    enabled: bool = True
    #: re-dispatch attempts per request before surfacing the failure
    max_migrations: int = 3
    #: wall-clock budget (s) from a request's FIRST failure — bounds how
    #: long a client stream may stall across migrations
    deadline_s: float = 30.0
    #: base backoff (s) between transient re-dispatches (jittered up to
    #: 2x by attempt ordinal — deterministic, no RNG)
    backoff_s: float = 0.05


def classify_failure(
    message: Optional[str] = None,
    exc: Optional[BaseException] = None,
    worker_id: Optional[int] = None,
    client=None,
) -> FailureKind:
    """Map a stream failure to a FailureKind (see module doc).

    ``client`` is the discovery client whose store watch tracks live
    instances; ``worker_id`` is the instance the router pinned the
    request to (absent for round-robin dispatches).
    """
    if exc is not None:
        from .faultpoints import FaultInjected

        if isinstance(exc, FaultInjected):
            return FailureKind.WORKER_LOST
        if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
            return FailureKind.TRANSIENT
        # NoResponders / hub StoreError: dispatch never reached a worker
        from ..runtime.bus import BusError

        if isinstance(exc, (BusError,)):
            return FailureKind.TRANSIENT
        import asyncio

        if isinstance(exc, asyncio.TimeoutError):
            return FailureKind.TRANSIENT
        message = message or str(exc)
    msg = message or ""
    if any(sig in msg for sig in WORKER_LOST_SIGNATURES):
        if client is not None and worker_id is not None:
            try:
                alive = worker_id in set(client.instance_ids())
            except Exception:  # noqa: BLE001 — classification must not throw
                alive = False
            if alive:
                # the worker still holds its lease: a TCP blip, not a
                # death — retry on the transient (backoff) path
                return FailureKind.TRANSIENT
            return FailureKind.LEASE_LOST
        return FailureKind.WORKER_LOST
    return FailureKind.FATAL
