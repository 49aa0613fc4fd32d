"""Windowed per-worker tails from cumulative scrape histograms.

A copy of ``dynamo_tpu/autopilot/tails.py``: the KV router's tail-aware
routing reads it (``SchedulerConfig.tail_aware``, on by default).

The engine's ``load_metrics`` advertises CUMULATIVE latency histograms
(queue-wait / prefill / restore / handoff bucket vectors since process
start). Routing on a cumulative distribution is routing on history — a
worker that was slow an hour ago looks slow forever, and a worker that
*became* bimodal five seconds ago hides behind its good past. The
:class:`TailTracker` turns the cumulative vectors into a sliding-window
view router-side: it keeps a short deque of (scrape-ts, bucket-vector)
snapshots per worker and differences the newest snapshot against the
newest one at least ``window_s`` old — exact bucket-count subtraction,
the same loss-free algebra that makes histogram merge exact.

The windowed tail (default p99 of queue-wait + prefill) is the floor
:func:`~dynamo_tpu_torch.kv_router.costmodel.tail_adjusted_ttft_ms` folds
into the cost model's predicted TTFT, so a bimodal worker is priced at
its measured tail instead of the mean its EWMA calibration reports.

Counter resets (an engine restart makes a delta go negative) rebase the
worker's window to the newest snapshot — one tick of "no tail evidence"
instead of a garbage quantile. Everything is clock-injected so the
planner-sim replay and the hysteresis tests run on a fake clock.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

from ..engine.hist import Histogram

#: the TTFT-relevant worker families, in gate-first order: the FIRST
#: name gates the tail (min_count samples required); the rest add their
#: quantiles when they have any window samples at all
TAIL_FAMILIES = ("queue_wait_ms", "prefill_ms")


def delta_hist(cur_vec: dict, base_vec: Optional[dict]) -> Optional[Histogram]:
    """Exact windowed histogram: ``cur - base`` bucket by bucket.

    ``base_vec=None`` means the window predates the worker's first
    scrape — the cumulative vector IS the window. Returns None on a
    malformed vector, a bounds skew (schema-skewed peer), or a negative
    delta (counter reset): the caller treats all three as "no window
    evidence this tick" rather than a wrong number."""
    cur = Histogram.from_vec(cur_vec)
    if cur is None:
        return None
    if base_vec is None:
        return cur
    base = Histogram.from_vec(base_vec)
    if base is None or base.bounds != cur.bounds:
        return None
    out = Histogram(cur.bounds)
    total = 0
    for i in range(len(cur.counts)):
        d = cur.counts[i] - base.counts[i]
        if d < 0:
            return None  # counter reset — rebase upstream
        out.counts[i] = d
        total += d
    out.count = total
    out.sum = max(cur.sum - base.sum, 0.0)
    if total == 0:
        return out
    # the window's observed range is only known to bucket resolution:
    # clamp quantiles to the occupied buckets' edges (lower edge of the
    # first occupied bucket, upper edge of the last; the overflow
    # bucket's ceiling is the cumulative max — an overestimate bounded
    # by reality)
    occupied = [i for i, c in enumerate(out.counts) if c]
    lo_i, hi_i = occupied[0], occupied[-1]
    out.min = out.bounds[lo_i - 1] if lo_i > 0 else 0.0
    out.max = out.bounds[hi_i] if hi_i < len(out.bounds) else cur.max
    return out


class TailTracker:
    """Per-worker sliding-window tails over scraped histogram vectors."""

    def __init__(self, window_s: float = 60.0, q: float = 0.99,
                 min_count: int = 8,
                 families: tuple[str, ...] = TAIL_FAMILIES,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = window_s
        self.q = q
        #: window samples the gate family must hold before a tail is
        #: trusted — below this a worker simply has no tail evidence
        #: (cold / idle), and routing behaves exactly as before
        self.min_count = min_count
        self.families = tuple(families)
        self._clock = clock
        #: worker -> deque[(ts, {family: to_vec dict})], ts ascending
        self._snaps: dict[int, deque] = {}
        self._last_ts: dict[int, float] = {}
        self.rebases = 0

    def observe(self, worker_id: int, hists: Optional[dict],
                ts: Optional[float] = None) -> None:
        """Record one scrape's cumulative vectors. Deduped on ``ts``
        (many routing decisions ride one scrape) and pruned so at most
        one snapshot older than the window survives as the baseline."""
        if not hists:
            return
        now = self._clock() if ts is None else ts
        last = self._last_ts.get(worker_id)
        if last == now:
            return
        if ts is None and last is not None and now - last < 0.2:
            # unstamped callers (legacy producers) observe per routing
            # decision, not per scrape — rate-limit so a hot router
            # doesn't grow the snapshot deque per request
            return
        self._last_ts[worker_id] = now
        dq = self._snaps.setdefault(worker_id, deque())
        while dq and dq[-1][0] >= now:
            dq.pop()  # clock went backwards (re-seeded fake clock)
        dq.append((now, {
            f: hists[f] for f in self.families if f in hists
        }))
        cutoff = now - self.window_s
        while len(dq) > 2 and dq[1][0] <= cutoff:
            dq.popleft()

    def window_hist(self, worker_id: int, family: str) -> Optional[Histogram]:
        """The worker's windowed distribution for one family: newest
        snapshot minus the newest snapshot at least ``window_s`` old
        (or the oldest held — a shorter window early on beats no
        window). None = no evidence (single snapshot, reset, skew)."""
        dq = self._snaps.get(worker_id)
        if not dq or len(dq) < 2:
            return None
        cur_ts, cur = dq[-1]
        base = dq[0][1]
        for t, s in dq:
            if t <= cur_ts - self.window_s:
                base = s
            else:
                break
        cv = cur.get(family)
        if cv is None:
            return None
        h = delta_hist(cv, base.get(family))
        if h is None:
            # counter reset / bounds skew: rebase the worker's window
            # to the newest snapshot so the next scrape pairs cleanly
            self.rebases += 1
            self._snaps[worker_id] = deque([dq[-1]])
            return None
        return h

    def tail_ms(self, worker_id: int, q: Optional[float] = None) -> Optional[float]:
        """The worker's windowed TTFT tail floor in milliseconds:
        q-quantile of windowed queue-wait plus q-quantile of windowed
        prefill. None when the gate family holds fewer than
        ``min_count`` window samples — no evidence, no adjustment."""
        q = self.q if q is None else q
        gate = self.window_hist(worker_id, self.families[0])
        if gate is None or gate.count < self.min_count:
            return None
        total = gate.quantile(q) or 0.0
        for family in self.families[1:]:
            h = self.window_hist(worker_id, family)
            if h is not None and h.count > 0:
                total += h.quantile(q) or 0.0
        return total

    def forget(self, worker_id: int) -> None:
        """Drop a departed worker's snapshots (lease expiry)."""
        self._snaps.pop(worker_id, None)
        self._last_ts.pop(worker_id, None)
