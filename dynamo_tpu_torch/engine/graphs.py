"""CUDA graphs of the decode window and the speculative verify.

Counterpart of the reference engine's per-key program cache
(``dynamo_tpu/engine/engine.py``: each program key is one compiled XLA
program, and a first dispatch pays its compile). Here each graph key is
one ``torch.cuda.CUDAGraph``:

  * the engine's host state enters through :class:`StaticInputs`, named
    device tensors that are views of one byte buffer, filled from a pinned
    host twin by ONE copy per dispatch; a graph reads them by address, so
    they are updated in place and never rebound;
  * the first dispatch of a key runs the program eagerly on a side stream
    (its result is the dispatch's; the run builds the kernels, sizes every
    shared device buffer and sets every kernel attribute), then captures
    it on the same stream into the runner's one memory pool; every later
    dispatch of the key replays the graph on the caller's stream;
  * the state a program writes (KV caches, scale planes, penalty counts)
    lives outside the graphs, which update it in place; :meth:`run` checks
    that those tensors are the ones the graph captured;
  * a graph's outputs are static tensors of the pool, overwritten by the
    next replay of any graph: the caller reads them before its next
    dispatch;
  * a capture or a replay that fails raises: nothing falls back to the
    eager program on the card.

On the CPU (``capture=False``), :meth:`GraphRunner.run` takes the same
static inputs and calls the program where the card would replay it.

Kernel launch counters (every wrapper registers its counters in
``ops/_cuda.py``'s ``COUNTED``): a capture launches nothing, so the counts
the wrappers added while capturing are taken back, and every replay, which
launches those kernels, adds them again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops import _cuda

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32}


def _launch_counts() -> dict:
    """Every registered kernel wrapper's launch counters: ``(wrapper,
    counter) -> count`` (``launches`` and its subsets such as
    ``verify_launches``)."""
    return {(f, a): getattr(f, a) for f, names in _cuda.COUNTED for a in names}


class StaticInputs:
    """Named static tensors on ``device``, views of one byte buffer that
    :meth:`load` fills from host arrays with one copy (pinned and
    asynchronous on the card, where the next load first waits for the
    previous copy to finish reading the host buffer)."""

    def __init__(self, device: torch.device, fields: dict):
        """``fields``: name -> (shape, numpy dtype of int32 / int64 /
        float32); each field starts 8-byte aligned."""
        layout, total = {}, 0
        for name, (shape, dt) in fields.items():
            dt = np.dtype(dt)
            layout[name] = (total, tuple(shape), dt)
            total += -(-int(np.prod(shape)) * dt.itemsize // 8) * 8
        cuda = device.type == "cuda"
        self._host = torch.zeros(max(total, 8), dtype=torch.uint8, pin_memory=cuda)
        self._dev = torch.zeros(max(total, 8), dtype=torch.uint8, device=device)
        self._copied = torch.cuda.Event() if cuda else None
        host = self._host.numpy()
        self.host, self.dev = {}, {}
        for name, (off, shape, dt) in layout.items():
            n = int(np.prod(shape)) * dt.itemsize
            self.host[name] = host[off:off + n].view(dt).reshape(shape)
            self.dev[name] = self._dev[off:off + n].view(_TORCH_DTYPES[dt]).view(shape)

    def load(self, **arrays: np.ndarray) -> dict:
        """Write ``arrays`` into their fields and copy the buffer to the
        device; returns the device tensors by name. Fields not named keep
        their last values."""
        if self._copied is not None:
            self._copied.synchronize()
        for name, a in arrays.items():
            self.host[name][...] = a
        self._dev.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        return self.dev


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    out: object  # the program's outputs: static tensors of the pool
    holds: tuple  # data_ptr of each state tensor the graph writes or reads
    launches: dict  # (wrapper, counter) -> launches per replay


class GraphRunner:
    """One CUDA graph per graph key (module docstring)."""

    def __init__(self, device: torch.device, capture: bool):
        self.device = device
        self.capture = capture and device.type == "cuda"
        self.graphs: dict[tuple, _Graph] = {}
        self.dispatched: set[tuple] = set()  # keys run at least once
        self.replays = 0
        self._pool = self._stream = None
        if self.capture:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)

    def run(self, key: tuple, program: Callable[[], object],
            holds: tuple = ()):
        """The outputs of ``program`` (a function of the static inputs and
        of the state tensors ``holds``, reading nothing back from the
        card): the graph of ``key`` replayed, or on the key's first
        dispatch the eager run, followed by the capture."""
        ptrs = tuple(t.data_ptr() for t in holds)
        g = self.graphs.get(key)
        if g is not None:
            if g.holds != ptrs:
                raise RuntimeError(f"graph {key}: a state tensor it captured "
                                   "was replaced (state must update in place)")
            g.graph.replay()
            self.replays += 1
            for (f, a), n in g.launches.items():
                setattr(f, a, getattr(f, a) + n)
            return g.out
        self.dispatched.add(key)
        if not self.capture:
            return program()
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            out = program()
            before = _launch_counts()
            graph = torch.cuda.CUDAGraph()
            # thread_local: the event loop's thread may read the card (a
            # metrics scrape) while the executor's thread captures
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                captured = program()
            finally:
                graph.capture_end()
        caller.wait_stream(self._stream)
        launched = {k: n - before.get(k, 0) for k, n in _launch_counts().items()
                    if n != before.get(k, 0)}
        for (f, a), n in launched.items():
            setattr(f, a, getattr(f, a) - n)
        self.graphs[key] = _Graph(graph, captured, ptrs, launched)
        return out

    def pool_bytes(self) -> int:
        """Device bytes the graphs' memory pool holds (0 without graphs)."""
        if not self.capture:
            return 0
        pid = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pid)
