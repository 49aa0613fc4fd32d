#!/usr/bin/env python3
"""Time the nvcc build of each CUDA source of the port, one at a time.

    python3 scripts/torch_build_times.py [--parent DIR] [--rounds N] [SOURCE ...]

Each source of ``dynamo_tpu_torch/csrc`` is compiled alone with the flags the
port builds with (``ops/_cuda.NVCC_FLAGS``), so a source's time is its own and
not the parallel build's longest. With ``--parent`` (the root of another
checkout, e.g. a ``git archive`` of the parent commit unpacked into a
gitignored directory) every source is built from both trees in turns (parent,
this, this, parent, ...), so the two are compared on one machine. Prints the
median seconds per source and tree and the kernel entries ptxas compiled.
Needs nvcc (the machine with the card); the libraries go to a scratch
directory under the package's gitignored ``_build``.
"""

from __future__ import annotations

import argparse
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build_once(nvcc: str, flags: list, src: Path, out: Path) -> tuple[float, int]:
    """Wall seconds of one nvcc build of ``src``, and how many kernel entries
    ptxas compiled."""
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *flags, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    return secs, len(re.findall(r"Compiling entry function", log))


def main(argv=None) -> int:
    from dynamo_tpu_torch.ops import _cuda

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, default=None,
                   help="root of another checkout to build in turns")
    p.add_argument("--rounds", type=int, default=2,
                   help="builds per source and tree")
    p.add_argument("sources", nargs="*", default=list(_cuda.SOURCES),
                   help="sources of csrc/ to build (default: all)")
    args = p.parse_args(argv)
    nvcc = _cuda._nvcc()
    trees = {"this": ROOT}
    if args.parent is not None:
        trees = {"parent": args.parent.resolve(), "this": ROOT}
    scratch = _cuda.BUILD_DIR / "timing"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    try:
        for name in args.sources:
            times = {t: [] for t in trees}
            entries = {}
            for r in range(args.rounds):
                order = list(trees) if r % 2 == 0 else list(trees)[::-1]
                for tree in order:
                    src = trees[tree] / "dynamo_tpu_torch" / "csrc" / name
                    secs, n = build_once(nvcc, _cuda.NVCC_FLAGS, src,
                                         scratch / f"{tree}-{r}.so")
                    times[tree].append(secs)
                    entries[tree] = n
            print(f"{name}: " + "; ".join(
                f"{tree} median {statistics.median(ts):.1f} s of "
                f"{[round(x, 1) for x in ts]}, {entries[tree]} kernel entries"
                for tree, ts in times.items()), flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
