"""Graceful worker drain.

A copy of ``dynamo_tpu/resilience/drain.py`` without its tracing span.

:class:`DrainCoordinator` sequences a worker's retirement so that no
client stream ever observes it (ref: the reference framework's graceful
shutdown + the migration layer above):

  1. **stop admitting** — delete the endpoint's discovery keys
     (ServeHandle.deregister). The router stops picking this worker;
     requests racing the delete are bounced by the draining engine with
     the migration signal and re-dispatched by the frontend.
  2. **finish or hand off** — each engine drains: in-flight requests
     get ``deadline_s`` to finish naturally; stragglers are terminated
     with the migration signal (``prompt + tokens-so-far`` resumes on a
     surviving worker). Auxiliary loops (prefill consumers, listeners)
     are closed via ``closers``.
  3. **flush the response plane** — wait (bounded) for the ingress'
     in-flight streams to write their terminal chunks.
  4. **revoke the lease LAST** — ``drt.shutdown()``. The lease is the
     liveness primitive: revoking it earlier would erase discovery
     before the handoff chunks are on the wire, turning graceful drain
     into plain death.

``install_signal_handlers`` wires SIGTERM (and SIGINT if asked) to the
sequence — `kubectl delete pod` / instance preemption becomes a drain,
not a massacre (launch/dynamo_run.py's worker and prefill roles).
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import signal as _signal
from typing import Callable, Iterable, Optional

from . import faultpoints

logger = logging.getLogger(__name__)


class DrainCoordinator:
    def __init__(
        self,
        drt,
        engines: Iterable = (),
        handles: Iterable = (),
        closers: Iterable[Callable] = (),
        deadline_s: float = 15.0,
        on_done: Optional[Callable[[], None]] = None,
    ):
        self.drt = drt
        self.engines = list(engines)
        self.handles = list(handles)
        self.closers = list(closers)
        self.deadline_s = deadline_s
        self.on_done = on_done
        self._task: Optional[asyncio.Task] = None
        self.stats = {"drains_total": 0, "drain_errors": 0}

    @property
    def task(self) -> Optional[asyncio.Task]:
        """The drain started by :meth:`trigger` (None before it)."""
        return self._task

    # ---- signal wiring ----

    def install_signal_handlers(self, signals=(_signal.SIGTERM,)) -> None:
        loop = asyncio.get_running_loop()
        for sig in signals:
            try:
                loop.add_signal_handler(sig, self.trigger)
            except (NotImplementedError, RuntimeError):  # non-unix loops
                _signal.signal(sig, lambda *_a: self.trigger())

    def trigger(self) -> asyncio.Task:
        """Idempotent: the first trigger starts the drain; later ones
        (operator mashing ctrl-C, duplicate TERM) return the same task."""
        if self._task is None:
            logger.info("drain triggered (deadline %.1fs)", self.deadline_s)
            self._task = asyncio.get_running_loop().create_task(self._run())
        return self._task

    async def _run(self) -> None:
        try:
            await self.drain()
        except faultpoints.FaultInjected:
            # the harness killed us mid-drain: die like a real mid-drain
            # crash — no further teardown; surviving streams abort on the
            # worker-death path and migrate anyway
            logger.warning("fault injected mid-drain; aborting drain")
            self.stats["drain_errors"] += 1
        except Exception:  # noqa: BLE001
            logger.exception("drain failed")
            self.stats["drain_errors"] += 1
        finally:
            if self.on_done is not None:
                self.on_done()

    # ---- the sequence ----

    async def drain(self) -> dict:
        self.stats["drains_total"] += 1
        loop = asyncio.get_running_loop()
        hard_deadline = loop.time() + self.deadline_s
        # 1. stop admitting: vanish from discovery first
        for h in self.handles:
            await h.deregister()
        await faultpoints.hit("mid_drain")
        # auxiliary consumers (prefill queue loops etc.) stop taking
        # new work; their in-flight items redeliver elsewhere
        for c in self.closers:
            r = c()
            if inspect.isawaitable(r):
                await r
        # 2. drain the engines: finish within the deadline, hand off
        # the rest with the migration signal
        handed_off = 0
        for e in self.engines:
            remaining = max(hard_deadline - loop.time(), 0.0)
            res = await e.drain(deadline_s=remaining, handoff=True)
            handed_off += (res or {}).get("handed_off", 0)
        # 3. let the ingress flush terminal chunks onto the response
        # plane before the transport goes away
        while loop.time() < hard_deadline + 2.0 and any(
            h.inflight_count() for h in self.handles
        ):
            await asyncio.sleep(0.02)
        for h in self.handles:
            await h.stop()
        # 4. lease revocation LAST (drt.shutdown revokes + joins)
        await self.drt.shutdown()
        logger.info("drain complete (%d streams handed off)", handed_off)
        return {"drained": True, "handed_off": handed_off}
