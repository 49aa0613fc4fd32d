"""Prometheus-style service metrics (request counters).

A trimmed copy of ``dynamo_tpu/http/metrics.py`` (the reference's
lib/llm/src/http/service/metrics.rs): request counters by (model,
endpoint, status), an inflight gauge with an RAII guard, token counters,
and first-token / inter-token latency sums and counts, and registered
sources (a callable returning ``{name: value}``, e.g. the migration
wrapper's counters), each rendered as ``<prefix>_<name> <value>`` —
in the Prometheus text format at /metrics with no client dependency. The
log-bucket latency histograms, SLO classes and breach counters of the
reference are not ported yet.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict

logger = logging.getLogger(__name__)

REQUESTS_TOTAL = "http_service_requests_total"
INFLIGHT_REQUESTS = "http_service_inflight_requests"
TOKENS_TOTAL = "tokens_total"
FIRST_TOKEN_SECONDS = "http_service_first_token_seconds"
INTER_TOKEN_SECONDS = "http_service_inter_token_seconds"


class Metrics:
    def __init__(self, prefix: str = "dynamo_tpu_torch"):
        self.prefix = prefix
        self.requests_total: dict[tuple, int] = defaultdict(int)
        self.inflight: dict[tuple, int] = defaultdict(int)
        self.tokens_total: dict[tuple, int] = defaultdict(int)
        # (model, endpoint) -> [sum_seconds, count]
        self.first_token: dict[tuple, list] = defaultdict(lambda: [0.0, 0])
        self.inter_token: dict[tuple, list] = defaultdict(lambda: [0.0, 0])
        self._sources: list = []

    def register_source(self, fn) -> None:
        self._sources.append(fn)

    def inflight_guard(self, model: str, endpoint: str) -> "InflightGuard":
        return InflightGuard(self, model, endpoint)

    def observe_tokens(self, model: str, kind: str, n: int) -> None:
        self.tokens_total[(model, kind)] += n

    def render(self) -> str:
        p = self.prefix
        lines = [f"# TYPE {p}_{REQUESTS_TOTAL} counter"]
        for (model, endpoint, status), v in sorted(self.requests_total.items()):
            lines.append(
                f'{p}_{REQUESTS_TOTAL}{{model="{model}",endpoint="{endpoint}",'
                f'status="{status}"}} {v}'
            )
        lines.append(f"# TYPE {p}_{INFLIGHT_REQUESTS} gauge")
        for (model, endpoint), v in sorted(self.inflight.items()):
            lines.append(
                f'{p}_{INFLIGHT_REQUESTS}{{model="{model}",endpoint="{endpoint}"}} {v}'
            )
        lines.append(f"# TYPE {p}_{TOKENS_TOTAL} counter")
        for (model, kind), v in sorted(self.tokens_total.items()):
            lines.append(f'{p}_{TOKENS_TOTAL}{{model="{model}",kind="{kind}"}} {v}')
        for name, fam in ((FIRST_TOKEN_SECONDS, self.first_token),
                          (INTER_TOKEN_SECONDS, self.inter_token)):
            lines.append(f"# TYPE {p}_{name} summary")
            for (model, endpoint), (total, n) in sorted(fam.items()):
                labels = f'model="{model}",endpoint="{endpoint}"'
                lines.append(f"{p}_{name}_sum{{{labels}}} {total}")
                lines.append(f"{p}_{name}_count{{{labels}}} {n}")
        for src in self._sources:
            try:
                for k, v in sorted(src().items()):
                    lines.append(f"{p}_{k} {v}")
            except Exception:  # noqa: BLE001 — a bad source must not
                # break the whole exposition
                logger.debug("metrics source failed", exc_info=True)
        return "\n".join(lines) + "\n"


class InflightGuard:
    """RAII inflight gauge + status-coded counter (ref metrics.rs:187-311)."""

    def __init__(self, metrics: Metrics, model: str, endpoint: str):
        self._m = metrics
        self._key = (model, endpoint)
        self._status = "error"
        self._start = time.monotonic()
        self._last_token_t: float | None = None
        metrics.inflight[self._key] += 1

    def observe_token(self) -> None:
        """The first call records the first-token latency, later calls the
        inter-token gaps."""
        now = time.monotonic()
        fam = self._m.first_token if self._last_token_t is None else self._m.inter_token
        ref = self._start if self._last_token_t is None else self._last_token_t
        acc = fam[self._key]
        acc[0] += now - ref
        acc[1] += 1
        self._last_token_t = now

    def mark_ok(self) -> None:
        self._status = "success"

    def mark(self, status: str) -> None:
        self._status = status

    def done(self) -> None:
        m, (model, endpoint) = self._m, self._key
        m.inflight[self._key] -= 1
        m.requests_total[(model, endpoint, self._status)] += 1
