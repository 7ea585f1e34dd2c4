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
def trace(logdir: str = "gridgcn_trace", cpu: bool = True):
    """Profile a scope, CPU and (when present) CUDA activity, and write a
    Chrome trace to `logdir/trace.json`: `with trace("logs") as prof:
    fn()`. Yields the profiler. With CUDA the scope ends by synchronizing
    every card, so the work it queued is done before the profiler stops.
    `cpu=False` leaves the host's operators out where CUDA is present
    (the trace keeps the device records and the launch calls that
    `busy_ms_per_iter` reads, and is a fraction of the size).

    On the card, torch's profiler (2.11, CUDA 12.8, H100) can drop device
    records in a process that has already traced a few tens of thousands
    of device events: it counts them as out of the trace's time window
    (`Out-of-range` in its log at KINETO_LOG_LEVEL=0), and the trace then
    lacks some or all of a call's kernels although their launches are
    recorded. `busy_ms_per_iter` refuses such a trace; a trace that must
    be complete is taken in a process of its own."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CPU] if cpu or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        for d in range(torch.cuda.device_count() if cuda else 0):
            torch.cuda.synchronize(d)
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
    devices (each the union of its streams). None for a trace without
    device events where CUDA is absent (a CPU run). Where CUDA is
    available a trace without device events, or one whose kernel
    launches lack their kernel records (`traceview.lost_records`), raises
    RuntimeError: it was taken with the card's activity on, and an idle
    or short reading would be false. A missing trace raises
    FileNotFoundError."""
    from gridgcn_torch.utils.traceview import exclusive_ms, lost_records

    busy = sum(exclusive_ms(logdir, iters).values())
    if not torch.cuda.is_available():
        return busy or None
    if not busy:
        raise RuntimeError(f"the trace under {logdir} holds no device "
                           "events (kernel, gpu_memcpy, gpu_memset)")
    lost, launches = lost_records(logdir)
    if lost:
        raise RuntimeError(f"the trace under {logdir} lost the kernel "
                           f"records of {lost} of its {launches} kernel "
                           "launches")
    return busy


def timed_trace(fn: Callable, iters: int, logdir: str, device="cuda",
                warmup: int = 2, counter: Callable[[], int] | None = None
                ) -> dict:
    """fn() timed, then traced: {"wall_ms": ms per call after `warmup`
    calls (`steady_state_time`: CUDA events on the card, the host clock
    on the CPU), "busy_ms": device-busy ms per call of one trace of
    `iters` calls into `logdir` (`trace(cpu=False)`; None on the CPU)},
    with "per_call": how much `counter()` (a launch count) grew per call
    under the trace, and "refused": the reason where `busy_ms_per_iter`
    refused the trace (it lost device records; busy_ms stays None: a
    refused trace is never read)."""
    rec = {"wall_ms": steady_state_time(fn, warmup=warmup, iters=iters,
                                        device=device) * 1e3,
           "busy_ms": None}
    n0 = counter() if counter else 0
    with trace(logdir, cpu=False):
        for _ in range(iters):
            fn()
    if counter:
        rec["per_call"] = (counter() - n0) / iters
    try:
        rec["busy_ms"] = busy_ms_per_iter(logdir, iters)
    except RuntimeError as e:
        rec["refused"] = str(e)
    return rec


def in_fresh_process(fn: Callable, *args):
    """fn(*args) in a spawned process of its own, whose profiler has
    traced nothing yet (see `trace`); returns its result and re-raises
    its exception. fn must be importable (a module-level function) and
    its arguments and result picklable."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        return ex.submit(fn, *args).result()


def retaking(run: Callable[[], list], retakes: int = 2) -> tuple[list, int]:
    """run() (a list of `timed_trace` records, each in a fresh process)
    again while any record was refused, at most `retakes` times; each
    refusal is printed. Returns (the records, the number of retakes).
    Raises when the last run still has a refused record."""
    for attempt in range(retakes + 1):
        records = run()
        refused = [r["refused"] for r in records if "refused" in r]
        if not refused:
            return records, attempt
        print(f"trace refused ({refused[0]}): "
              + ("taken again in a fresh process" if attempt < retakes
                 else "no retake left"), flush=True)
    raise RuntimeError(f"traces lost device records {retakes + 1} times: "
                       f"{refused}")
