"""Runtime + Worker + DistributedRuntime.

A copy of ``dynamo_tpu/runtime/runtime.py`` (the reference's runtime layer,
lib/runtime/src/{runtime,worker,distributed}.rs): a process-wide asyncio
runtime with a cancellation-token
tree, a ``Worker`` main() wrapper with signal handling and a graceful
shutdown timeout (exit code 911 on overrun, ref worker.rs:16-80), and the
``DistributedRuntime`` which owns the control-plane store connection (with
the process's *primary lease* — the liveness primitive), the message bus,
and the lazily-started TCP response-plane server.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Awaitable, Callable, Optional

from ..utils.config import RuntimeConfig, WorkerConfig
from .bus import LocalBus
from .component import Namespace
from .engine import CancellationToken
from .hub import connect_hub
from .store import LeaseKeeper, LocalStore
from .tcp import TcpStreamServer

logger = logging.getLogger(__name__)

EXIT_CODE_SHUTDOWN_OVERRUN = 911


class Runtime:
    """Process-wide runtime: cancellation root + background task tracking
    (ref runtime.rs:38-117)."""

    def __init__(self):
        self.cancellation = CancellationToken()
        self._tasks: set[asyncio.Task] = set()

    def child_token(self) -> CancellationToken:
        return self.cancellation.child_token()

    def spawn(self, coro: Awaitable, name: Optional[str] = None) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro, name=name)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    def shutdown(self) -> None:
        self.cancellation.cancel()

    async def join(self, timeout: Optional[float] = None, cancel: bool = False) -> bool:
        """Wait for background tasks; returns False on timeout. With
        ``cancel=True``, cancel everything first (daemon-style tasks like
        serve loops never end on their own)."""
        pending = [t for t in self._tasks if not t.done()]
        if cancel:
            for t in pending:
                t.cancel()
        if not pending:
            return True
        done, still = await asyncio.wait(pending, timeout=timeout)
        for t in still:
            t.cancel()
        return not still


class DistributedRuntime:
    """Runtime + control-plane store + bus + response-plane server
    (ref distributed.rs:31-129).

    ``store``/``bus`` may be local in-process instances or remote hub
    clients (dynamo_tpu_torch.runtime.hub) — everything above this class is
    transport-agnostic.
    """

    PRIMARY_LEASE_TTL = 10.0

    def __init__(self, store=None, bus=None, host: str = "127.0.0.1"):
        self.runtime = Runtime()
        self.store = store if store is not None else LocalStore()
        self.bus = bus if bus is not None else LocalBus()
        self._tcp_server: Optional[TcpStreamServer] = None
        self._tcp_starting: Optional[asyncio.Future] = None
        self._host = host
        self.primary_lease_id: int = 0
        self._lease_keeper: Optional[LeaseKeeper] = None
        self._started = False
        self._shut_down = False
        self._hub_conn = None  # hub connection owned by this runtime, if any

    @classmethod
    async def from_settings(
        cls,
        store=None,
        bus=None,
        host: Optional[str] = None,
        hub_url: Optional[str] = None,
    ):
        """Build from the layered config (defaults ← TOML ← ``DYN_RUNTIME_*``
        env, ref config.rs:86-88): resolves the response-plane host and, when
        ``store``/``bus`` are not given and a hub is configured (``hub_url``
        arg or ``DYN_RUNTIME_HUB_URL``), connects both to that TCP hub. The
        hub connection is owned by the runtime and closed on shutdown."""
        cfg = RuntimeConfig.from_settings(hub_url=hub_url)
        hub_conn = None
        if store is None and bus is None and cfg.hub_url:
            store, bus, hub_conn = await connect_hub(cfg.hub_url)
        drt = cls(store=store, bus=bus, host=host or cfg.response_host)
        drt._hub_conn = hub_conn
        await drt.start()
        return drt

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        loop = asyncio.get_running_loop()
        if not getattr(loop, "_dyn_blocking_pool", None):
            # bound the default-executor pool used for blocking work
            # (tokenize, host staging IO) — ref config.rs max_blocking_threads
            cfg = RuntimeConfig.from_settings()
            loop._dyn_blocking_pool = ThreadPoolExecutor(
                max_workers=cfg.max_blocking_threads,
                thread_name_prefix="dyn-blocking",
            )
            loop.set_default_executor(loop._dyn_blocking_pool)
        # local stores (including latency-wrapped ones) need their lease
        # reaper started in this loop; remote hub stores have no start()
        starter = getattr(self.store, "start", None)
        if starter is not None:
            starter()
        lease = self.store.grant_lease(self.PRIMARY_LEASE_TTL)
        if asyncio.iscoroutine(lease):
            lease = await lease
        self.primary_lease_id = lease
        self._lease_keeper = LeaseKeeper(
            self.store,
            lease,
            self.PRIMARY_LEASE_TTL,
            on_lost=self.runtime.shutdown,
        )
        self._lease_keeper.start()

    @property
    def worker_id(self) -> int:
        """Stable identity of this process in the cluster = its lease id
        (the reference uses the etcd lease id the same way)."""
        return self.primary_lease_id

    async def tcp_server(self) -> TcpStreamServer:
        """Lazily-started response-plane server (ref distributed.rs lazy TCP).

        Single-flight: concurrent first callers must share one instance —
        otherwise streams register on a half-started server that a racing
        caller then overwrites."""
        if self._tcp_server is None:
            if self._tcp_starting is None:

                async def _start() -> TcpStreamServer:
                    srv = TcpStreamServer(host=self._host)
                    await srv.start()
                    return srv

                fut = asyncio.ensure_future(_start())
                self._tcp_starting = fut

                def _done(f: asyncio.Future) -> None:
                    # Publish the server even if every awaiter was cancelled
                    # mid-shield — otherwise the shielded start completes
                    # unobserved, a later caller starts a second server, and
                    # the first listening socket leaks. On failure, drop the
                    # future so a transient error isn't replayed forever.
                    if self._tcp_starting is f:
                        self._tcp_starting = None
                    if not f.cancelled() and f.exception() is None:
                        if self._tcp_server is None and not self._shut_down:
                            self._tcp_server = f.result()
                        else:  # racing second start / post-shutdown orphan
                            srv = f.result()
                            asyncio.ensure_future(srv.close())

                fut.add_done_callback(_done)
            starting = self._tcp_starting
            await asyncio.shield(starting)
            self._tcp_server = starting.result()
        return self._tcp_server

    def namespace(self, name: str) -> Namespace:
        return Namespace(self, name)

    async def shutdown(self) -> None:
        self._shut_down = True
        if self._tcp_starting is not None:
            self._tcp_starting.cancel()
        self.runtime.shutdown()
        if self._lease_keeper:
            await self._lease_keeper.stop(revoke=True)
            self._lease_keeper = None
        if self._tcp_server:
            # TcpServer.close() is async and awaits the asyncio server's
            # wait_closed() itself (runtime/tcp.py)
            await self._tcp_server.close()
            self._tcp_server = None
        await self.runtime.join(timeout=5.0, cancel=True)
        if self._hub_conn is not None:
            await self._hub_conn.close()
            self._hub_conn = None


class Worker:
    """main() wrapper: run an async entrypoint under signal handling with a
    graceful-shutdown deadline (ref worker.rs:16-80).

    ``drt`` is the runtime, or an async factory of it that the worker awaits
    in its own loop before ``fn`` runs: whatever must come before the lease
    (loading weights, building kernels, warmup) goes there, so it never
    starves the lease's keepalives."""

    def __init__(
        self,
        drt: Optional[
            DistributedRuntime | Callable[[], Awaitable[DistributedRuntime]]
        ] = None,
    ):
        self.drt = drt

    def execute(self, fn: Callable[[DistributedRuntime], Awaitable[None]]) -> None:
        try:
            asyncio.run(self._run(fn))
        except KeyboardInterrupt:
            pass

    async def _run(self, fn: Callable[[DistributedRuntime], Awaitable[None]]) -> None:
        drt = self.drt
        if callable(drt):
            drt = await drt()
        drt = drt or DistributedRuntime()
        await drt.start()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, drt.runtime.shutdown)
            except NotImplementedError:  # pragma: no cover - non-unix
                pass
        main_task = loop.create_task(fn(drt))
        cancel_wait = loop.create_task(drt.runtime.cancellation.cancelled())
        done, _ = await asyncio.wait(
            [main_task, cancel_wait], return_when=asyncio.FIRST_COMPLETED
        )
        if main_task in done:
            cancel_wait.cancel()
            main_task.result()  # propagate errors
            await drt.shutdown()
            return
        # external shutdown requested: give main a grace period
        timeout = WorkerConfig.from_settings().graceful_shutdown_timeout
        main_task.cancel()
        try:
            await asyncio.wait_for(asyncio.gather(main_task, return_exceptions=True), timeout)
        except asyncio.TimeoutError:
            logger.error("graceful shutdown overran %ss; exiting 911", timeout)
            sys.exit(EXIT_CODE_SHUTDOWN_OVERRUN)
        await drt.shutdown()
