"""Tracing and timing: `torch.profiler` traces (Chrome trace JSON, viewable
in Perfetto), a steady-state timer (CUDA events on the card, the host
clock on the CPU), named regions, and the device-busy time of a trace."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str = "gridgcn_trace"):
    """Profile a scope, CPU and (when present) CUDA activity, and write a
    Chrome trace to `logdir/trace.json`: `with trace("logs") as prof:
    fn()`. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def steady_state_time(fn: Callable, *args, warmup: int = 2,
                      iters: int = 10, device="cuda") -> float:
    """Seconds per call of `fn(*args)` after `warmup` calls: CUDA events
    around `iters` calls on a CUDA device (the default), the host clock
    on the CPU."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def annotate(name: str):
    """A named region in profiler traces."""
    return torch.profiler.record_function(name)


def busy_ms_per_iter(logdir: str, iters: int) -> float | None:
    """Device-busy ms per iteration of the trace that `trace(logdir)`
    wrote: `utils.traceview`'s exclusive attribution, summed over the
    devices (each the union of its streams). None when the trace holds no
    device events (a CPU run); a missing trace raises FileNotFoundError."""
    from gridgcn_torch.utils.traceview import exclusive_times, load_events

    busy_ps = sum(sum(exclusive_times(events).values())
                  for events in load_events(logdir).values())
    return busy_ps / iters / 1e9 if busy_ps else None
