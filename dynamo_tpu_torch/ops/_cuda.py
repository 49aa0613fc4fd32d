"""Build and load the hand-written CUDA kernels (``dynamo_tpu_torch/csrc``).

Each ``.cu`` file compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`. Nothing here
runs at import time: the first kernel launch (or an explicit
:func:`build_all`) compiles every source in parallel, one ``nvcc`` process
per file, into ``dynamo_tpu_torch/_build/`` (listed in ``.gitignore``).
Libraries are keyed by a hash of their source and the headers beside it
(``*.cuh``), so an edited kernel is rebuilt and a stale one is never
loaded.

Wrappers pass tensor pointers from ``data_ptr()`` and the current stream
from ``torch.cuda.current_stream().cuda_stream`` as ``c_void_p``; every C
entry point returns the launch's ``cudaGetLastError()``, and
:func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: source file -> [(C function, argtypes)]; restype is c_int for all
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PAGED_ATTENTION = (
    [_P] * 8 + [_I] + [_P] * 3 + [_I] * 9
    + [_F, _I, _P, _I, _P, _P, _I, _P] + [_I] * 3 + [_P, _P]
)
SOURCES = {
    # the tiers' block copies (ops/block_copy.py)
    "block_copy.cu": {
        "block_gather_launch": [_P] * 9 + [_I] * 7 + [_P],
        "block_scatter_launch": [_P] * 9 + [_I] * 8 + [_P],
        "block_scatter_dequant_launch": [_P] * 7 + [_I] * 10 + [_P],
        "block_scatter_requant_launch": [_P] * 9 + [_I] * 9 + [_P],
    },
    "kv_cache_append.cu": {
        "kv_cache_append_tokens_launch": [_P] * 6 + [_I] * 10 + [_P],
        "kv_cache_append_quantized_launch": [_P] * 11 + [_I] * 8 + [_P],
    },
    "mla_attention.cu": {
        "mla_attention_launch": (
            [_P] * 11 + [_I] * 8 + [_F] + [_I] * 6 + [_P, _P, _I, _P]
        ),
    },
    "moe_gmm.cu": {
        "ragged_int8_gmm_launch": [_P] * 5 + [_I] * 5 + [_P] * 2 + [_I] * 2 + [_P],
    },
    "paged_attention.cu": {"paged_attention_launch": _PAGED_ATTENTION},
    # the same kernels at head widths 192 and 256, built in parallel
    "paged_attention_wide.cu": {"paged_attention_wide_launch": _PAGED_ATTENTION},
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin): the "
            "CUDA kernels of dynamo_tpu_torch build on a machine with the "
            "CUDA toolkit"
        )
    return path


def _lib_path(src: str) -> Path:
    """The library of ``src``, named by a hash of the source and of every
    header of ``csrc/`` (a source may include any of them)."""
    h = hashlib.sha256((SRC_DIR / src).read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every stale source in parallel; returns the wall seconds
    spent (0.0 when every library was already built). Raises with the
    compiler's output when any build fails. The ptxas report (registers,
    shared memory, spills per kernel) lands beside each library as
    ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in SOURCES if not _lib_path(s).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        out = _lib_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log.decode()}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_logs() -> dict[str, str]:
    """The compiler output of each built library (ptxas -v report)."""
    out = {}
    for src in SOURCES:
        log = _lib_path(src).with_suffix(".log")
        if log.exists():
            out[src] = log.read_text()
    return out


def lib(src: str) -> ctypes.CDLL:
    """The loaded library of ``src`` (building every stale source first)."""
    with _lock:
        if src not in _libs:
            build_all()
            cdll = ctypes.CDLL(str(_lib_path(src)))
            for fn, argtypes in SOURCES[src].items():
                f = getattr(cdll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[src] = cdll
        return _libs[src]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_sm_counts: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached per index)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


_buffers: dict = {}


def device_buffer(kind: str, device: torch.device, n: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """One buffer per (kind, device), grown when a launch needs more, so a
    launch on the device's stream allocates nothing. ``"tickets"``: the
    split counters of the decode bodies, int32, zero when made and zero
    between launches (the block that merges a unit's splits zeroes its
    counter), shared by every kernel on the stream; any other kind is
    scratch that each launch writes before it reads.

    A CUDA graph holds the buffer's address, so it is never made or grown
    while the stream captures: the eager run of the same shapes before a
    capture sizes it, and a request to grow during one raises (a tickets
    buffer made inside a graph's pool would not stay zero between
    launches)."""
    buf = _buffers.get((kind, device))
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"device_buffer {kind!r}: asked for {n} elements "
                f"(holding {0 if buf is None else buf.numel()}) while the "
                "stream captures a CUDA graph; an eager run of the same "
                "shapes must come first"
            )
        make = torch.zeros if kind == "tickets" else torch.empty
        buf = make(max(n, 1024), dtype=dtype, device=device)
        _buffers[kind, device] = buf
    return buf


#: (wrapper, its counters' names) of every kernel wrapper that counts its
#: launches, registered by :func:`counted` where the wrapper is defined
#: (``engine/graphs.py`` reads these counters around a graph's capture)
COUNTED: list = []


def counted(fn, *subsets: str):
    """Register the kernel wrapper ``fn``: its ``launches`` counter, and
    ``subsets``, counters of the launches it also counts apart, start at
    0. The wrapper adds to them where it launches its kernel."""
    names = ("launches",) + subsets
    for name in names:
        setattr(fn, name, 0)
    COUNTED.append((fn, names))
    return fn


def launch_counts() -> dict:
    """``{wrapper: {counter: launches}}`` of every registered wrapper, so a
    process that serves (a worker's stats endpoint) can report which
    kernels its path ran."""
    return {fn.__name__: {name: getattr(fn, name) for name in names}
            for fn, names in COUNTED}


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The kernels take CUDA tensors on one device, contiguous. Anything
    else raises — a CUDA-less call is an error, never a silent reroute."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(
            f"{name}: the CUDA kernel needs CUDA tensors, got {dev}"
        )
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def require_int32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: index tensors must be int32, "
                             f"got {t.dtype}")
