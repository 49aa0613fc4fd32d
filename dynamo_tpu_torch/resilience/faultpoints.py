"""Deterministic fault-injection harness.

A copy of ``dynamo_tpu/resilience/faultpoints.py``, with its spec grammar.
Named fault points sit at the request-lifecycle stages where real
deployments lose workers (admission, mid-prefill, mid-decode,
mid-KV-transfer, mid-drain, a peer serve) and fire *deterministically*:
an armed point counts hits and triggers on the Nth, a fixed number of
times. No randomness, no wall clocks, so a test that kills "the 3rd
segment of a KV stream" kills it on every run.

Arming is programmatic (``faultpoints.arm(...)`` from a test) or via the
``DYN_FAULTPOINTS`` environment variable for subprocess workers::

    DYN_FAULTPOINTS="mid_decode:kill@4,mid_kv_transfer:delay=0.2"

Spec grammar (comma-separated): ``point:action[=delay_s][@after][xN]``
— *action* is ``kill`` (raise :class:`FaultInjected` at the site) or
``delay`` (async sites sleep ``delay_s``); ``@after`` fires on the
Nth hit (default 1st); ``xN`` fires N times (default once, ``x-1``
unlimited).

A ``kill`` raises :class:`FaultInjected`, whose message carries the
"fault injected" worker-lost signature, so a caller treats it exactly like
a real worker death.

Unarmed sites cost one dict lookup on an empty registry.
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import dataclass, field
from typing import Optional

logger = logging.getLogger(__name__)

#: the lifecycle stages instrumented across the stack (engine admission /
#: prefill / decode, disagg KV handoff, drain coordinator)
POINTS = (
    "admission",
    "mid_prefill",
    "mid_decode",
    "mid_kv_transfer",
    "mid_drain",
    # fleet prefix cache: the peer-side serve of a kv-peer-fetch —
    # killing here is a worker dying mid-peer-pull (the puller must
    # degrade to recompute, the peer's tiers must stay intact)
    "mid_peer_serve",
    # PRESERVE-style weight pre-stage on the prefetch-hint path: a kill
    # here is the pre-stage plumbing dying — the hint's KV restore must
    # proceed untouched (the pre-stage is advisory, guarded separately)
    "pre_stage_weights",
    # elastic live resharding (engine.reshard): hit once per morph PHASE
    # — pre_stage (weight staging off the hold window), quiesced (loop
    # at a step boundary, device lock held), kv_staged (new-layout
    # weights+KV real, nothing committed), committed (the assignment
    # block ran). Arming kill@N walks the matrix; a kill at any phase
    # must leave the engine wholly on the old layout (N<=3) or wholly
    # on the new one (N=4), never half (docs/elastic_resharding.md)
    "mid_reshard",
)

ACTIONS = ("kill", "delay")

ENV_VAR = "DYN_FAULTPOINTS"


class FaultInjected(RuntimeError):
    """Raised at an armed ``kill`` point. The message carries the
    worker-lost signature, so migration treats it as a worker death."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"fault injected: worker killed at {point} (hit {hit})")
        self.point = point
        self.hit = hit


@dataclass
class _Arm:
    point: str
    action: str = "kill"
    after: int = 1  # fire on the Nth hit (1-based)
    times: int = 1  # firings before the arm goes inert (-1 = unlimited)
    delay_s: float = 0.0
    hits: int = 0
    fired: int = 0

    def take(self) -> bool:
        """Count one hit; True when this hit fires."""
        self.hits += 1
        if self.hits < self.after:
            return False
        if self.times >= 0 and self.fired >= self.times:
            return False
        self.fired += 1
        return True


class FaultPoints:
    """Process-global registry of armed fault points (see module doc)."""

    def __init__(self):
        self._arms: dict[str, _Arm] = {}
        #: (point, action, hit#) tuples of every firing — test forensics
        self.history: list[tuple[str, str, int]] = []

    # ---- arming ----

    def arm(
        self,
        point: str,
        action: str = "kill",
        after: int = 1,
        times: int = 1,
        delay_s: float = 0.0,
    ) -> _Arm:
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r}; known: {POINTS}")
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r}; known: {ACTIONS}")
        if after < 1:
            raise ValueError(f"after={after} must be >= 1")
        arm = _Arm(point, action, after=after, times=times, delay_s=delay_s)
        self._arms[point] = arm
        return arm

    def disarm(self, point: str) -> None:
        self._arms.pop(point, None)

    def reset(self) -> None:
        self._arms.clear()
        self.history.clear()

    def armed(self, point: Optional[str] = None) -> bool:
        if point is None:
            return bool(self._arms)
        return point in self._arms

    def arm_from_spec(self, spec: str) -> None:
        """Parse a ``DYN_FAULTPOINTS``-style spec (module doc grammar)."""
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            point, _, rest = part.partition(":")
            action, after, times, delay_s = "kill", 1, 1, 0.0
            if rest:
                if "x" in rest:
                    rest, _, t = rest.rpartition("x")
                    times = int(t)
                if "@" in rest:
                    rest, _, a = rest.partition("@")
                    after = int(a)
                if rest:
                    action, _, d = rest.partition("=")
                    if d:
                        delay_s = float(d)
            self.arm(point, action, after=after, times=times, delay_s=delay_s)

    # ---- firing ----

    def _fire(self, point: str) -> Optional[_Arm]:
        arm = self._arms.get(point)
        if arm is None or not arm.take():
            return None
        self.history.append((point, arm.action, arm.hits))
        logger.warning(
            "FAULT POINT %s fired: %s (hit %d)", point, arm.action, arm.hits
        )
        return arm

    def hit_sync(self, point: str, **ctx) -> None:
        """Synchronous site (scheduler loop, device paths). ``kill``
        raises; ``delay`` is ignored here — a sync sleep would stall the
        event loop, which is its own bug class, not this harness's."""
        if not self._arms:
            return
        arm = self._fire(point)
        if arm is None:
            return
        if arm.action == "kill":
            raise FaultInjected(point, arm.hits)
        logger.debug("delay fault at sync site %s ignored", point)

    async def hit(self, point: str, **ctx) -> None:
        """Async site. ``kill`` raises; ``delay`` sleeps ``delay_s``."""
        if not self._arms:
            return
        arm = self._fire(point)
        if arm is None:
            return
        if arm.action == "kill":
            raise FaultInjected(point, arm.hits)
        await asyncio.sleep(arm.delay_s)


#: the process-global registry every instrumented site consults
FAULTS = FaultPoints()

# module-level conveniences (the instrumented sites call these)
arm = FAULTS.arm
disarm = FAULTS.disarm
reset = FAULTS.reset
armed = FAULTS.armed
hit = FAULTS.hit
hit_sync = FAULTS.hit_sync

_env_spec = os.environ.get(ENV_VAR, "")
if _env_spec:
    # subprocess workers arm from the environment at import (the tests'
    # only lever into a worker they exec rather than construct)
    try:
        FAULTS.arm_from_spec(_env_spec)
    except Exception:  # noqa: BLE001 — a typo'd spec must not kill startup
        logger.exception("bad %s spec %r ignored", ENV_VAR, _env_spec)
