"""The host's launch calls per traced request: the trace's `cuda_runtime`
and `cuda_driver` events that launch a kernel or a CUDA graph
(`cudaLaunchKernel`, `cuLaunchKernel`, `cudaLaunchKernelExC`,
`cudaGraphLaunch`, ...) ÷ the traced requests. An eager forward launches
each of its kernels from the host; a replayed one launches a graph for
many kernels, which `launches_per_request.serve` still counts one by
one."""

import collections
import json
from pathlib import Path

from harness import readers
from harness.cell import TRACE_FILE

UNIT, MOVES, LAYER = "launches", "serve_latency_p95_ms", "serving"
CATEGORIES = ("cuda_runtime", "cuda_driver")


def launches(name: str) -> bool:
    """Whether a runtime or driver call of this name launches a kernel or a
    graph."""
    return "GraphLaunch" in name or ("Launch" in name and "Kernel" in name)


def counts(run):
    """{call name: launch calls per traced request}, or None without a
    serving run's sound trace."""
    tr = readers.traced(run, "serve")
    if tr is None:
        return None
    path = Path(__file__).resolve().parents[2] / TRACE_FILE
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    n = collections.Counter(
        ev["name"] for ev in events if ev.get("ph") == "X"
        and ev.get("cat") in CATEGORIES and launches(ev["name"]))
    return {k: v / tr.iters for k, v in sorted(n.items())}


def read(run):
    c = counts(run)
    return None if c is None else sum(c.values())


def info(run):
    c = counts(run)
    return None if c is None else "; ".join(f"{k} {v!r}" for k, v in
                                           c.items())
