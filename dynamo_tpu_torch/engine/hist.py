"""Fixed-bucket latency histograms in the wire form ``load_metrics`` emits.

A trimmed copy of ``dynamo_tpu/observability/hist.py`` (the port imports
nothing of the JAX package): the same log-spaced millisecond buckets and
the same ``to_vec`` dictionary, so a torch worker's ``hist_*`` entries
merge losslessly with a JAX worker's in the metrics plane. Only what the
engine needs is kept: ``observe`` and ``to_vec``.
"""

from __future__ import annotations

from typing import Iterable


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple[float, ...]:
    """Log-spaced bucket upper bounds from ``lo`` to >= ``hi``
    (``per_decade`` bounds per factor of 10), deduplicated ascending."""
    out: list[float] = []
    b = lo
    ratio = 10.0 ** (1.0 / per_decade)
    while b < hi * (1 + 1e-9):
        r = float(f"{b:.6g}")
        if not out or r > out[-1]:
            out.append(r)
        b *= ratio
    return tuple(out)


#: worker-internal distributions in milliseconds: 0.05ms .. ~60s
MS_BUCKETS = log_buckets(0.05, 60_000.0, per_decade=4)


class Histogram:
    """Counts per fixed bucket + an implicit ``+Inf`` overflow slot."""

    __slots__ = ("bounds", "counts", "sum", "count", "min", "max")

    def __init__(self, bounds: Iterable[float] = MS_BUCKETS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # first bound >= v (bisect; bounds are sorted)
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1

    def to_vec(self) -> dict:
        """Wire form for ``load_metrics`` (JSON-safe, bounds included)."""
        return {
            "b": list(self.bounds),
            "c": list(self.counts),
            "s": round(self.sum, 6),
            "n": self.count,
            "lo": (round(self.min, 6) if self.count else 0.0),
            "hi": round(self.max, 6),
        }
