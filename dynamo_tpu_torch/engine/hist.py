"""Fixed-bucket latency histograms in the wire form ``load_metrics`` emits.

A trimmed copy of ``dynamo_tpu/observability/hist.py`` (the port imports
nothing of the JAX package): the same log-spaced millisecond buckets and
the same ``to_vec`` dictionary, so a torch worker's ``hist_*`` entries
merge losslessly with a JAX worker's in the metrics plane. Kept: what the
engine needs (``observe``, ``to_vec``) and what the KV router's tail
tracker reads (``from_vec``, ``quantile``).
"""

from __future__ import annotations

from typing import Iterable, Optional


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

    @staticmethod
    def from_vec(v: dict) -> Optional["Histogram"]:
        """Tolerant decode (None on malformed input — a skewed peer's
        vector degrades to 'no histogram', never an exception on the
        scrape path)."""
        try:
            h = Histogram(tuple(float(b) for b in v["b"]))
            if h.bounds != tuple(sorted(h.bounds)):
                return None
            counts = [int(c) for c in v["c"]]
            if len(counts) != len(h.counts) or any(c < 0 for c in counts):
                return None
            h.counts = counts
            h.sum = float(v.get("s", 0.0))
            h.count = int(v.get("n", sum(counts)))
            h.min = float(v.get("lo", 0.0)) if h.count else float("inf")
            h.max = float(v.get("hi", 0.0))
            return h
        except (KeyError, TypeError, ValueError):
            return None

    def quantile(self, q: float) -> Optional[float]:
        """Linear interpolation inside the covering bucket, clamped to
        the observed [min, max] (exact for single-sample / single-value
        distributions). None when empty."""
        if self.count == 0:
            return None
        rank = q * self.count
        cum = 0.0
        lo = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                lo = self.bounds[i] if i < len(self.bounds) else lo
                continue
            if cum + c >= rank:
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (rank - cum) / c
                val = lo + (hi - lo) * frac
                return min(max(val, self.min), self.max)
            cum += c
            lo = self.bounds[i] if i < len(self.bounds) else lo
        return self.max
