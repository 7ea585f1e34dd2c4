"""Tracing and timing: `torch.profiler` traces (Chrome trace JSON, viewable
in Perfetto), a steady-state timer (CUDA events on the card, the host
clock on the CPU), named regions, and the device-busy time of a profile."""

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


def busy_ms_per_iter(prof, iters: int) -> float | None:
    """Device-busy ms per iteration of a finished `torch.profiler` profile:
    the self time of its device events, summed. None when the profiler
    recorded no device events (a CPU run)."""
    from torch.autograd import DeviceType

    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / iters if busy_us else None
