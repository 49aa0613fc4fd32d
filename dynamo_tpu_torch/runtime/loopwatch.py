"""Event-loop stall monitor for a serving process.

A worker's event loop carries its lease keepalives (a third of the 10 s
TTL apart), its TCP response writes and its bus traffic, while the engine
dispatches device steps from an executor thread. :class:`LoopStallMonitor`
measures how late the loop wakes a task that asked to sleep a fixed
interval: that lateness is the longest time anything else waiting on the
loop went unserved. It reports under the reference's runtime-sanitizer
scrape keys (``san_loop_stalls``, ``san_loop_stall_max_ms``), which
``WorkerLoad.from_stats`` reads as ``loop_stalls`` / ``loop_stall_max_ms``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional


class LoopStallMonitor:
    def __init__(self, interval_s: float = 0.02, stall_s: float = 1.0):
        self.interval_s = interval_s
        #: a wake-up this late counts as one stall (the reference
        #: sanitizer's default threshold)
        self.stall_s = stall_s
        self.stalls = 0
        self.max_ms = 0.0
        self._task: Optional[asyncio.Task] = None

    def start(self) -> "LoopStallMonitor":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(self.interval_s)
            late = time.perf_counter() - t0 - self.interval_s
            self.max_ms = max(self.max_ms, late * 1e3)
            if late >= self.stall_s:
                self.stalls += 1

    def counters(self) -> dict:
        return {"san_loop_stalls": self.stalls,
                "san_loop_stall_max_ms": round(self.max_ms, 3)}
