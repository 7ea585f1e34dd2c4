"""The traced run's readings, from a `torch.profiler` Chrome trace.

Copied from the port's `utils/traceview.py` and `utils/profiling.py`
(frozen here, so that a later change to the port cannot change how the
benchmark reads its traces): the device categories, exclusive time per
kernel (each instant charged to the innermost active event, so the values
sum to the union of a device's streams: its busy time), and the refusal
of a trace whose kernel launches lack their kernel records. Added here:
the device's idle gaps by the host operation that was open during each.
The program's own spans are read by `program_spans.py`."""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Iterable, List, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function",
                   "cuda_runtime", "cuda_driver")
TOP = 10                # entries of each breakdown list

Event = Tuple[int, int, str]   # (start_ps, end_ps, name)


class LostRecords(RuntimeError):
    """The trace lost device records: none of its per-layer readings is
    sound (a lost kernel would read as idle time)."""


def _ps(us: float) -> int:
    """Chrome trace microseconds (nanosecond resolution) to picoseconds."""
    return round(us * 1e3) * 1000


def exclusive_times(events: Iterable[Event]) -> dict:
    """Exclusive (self) time per event name, in picoseconds: each instant
    of the timeline goes to the most recently started still-active event,
    so the values sum to the busy time (the union of the events)."""
    bounds: List[Tuple[int, int, str]] = []
    for s, e, n in events:
        if e > s:
            bounds.append((s, 0, n))
            bounds.append((e, 1, n))
    bounds.sort(key=lambda b: (b[0], b[1]))
    excl: dict = collections.defaultdict(int)
    active: List[str] = []
    prev = None
    for t, kind, n in bounds:
        if prev is not None and active and t > prev:
            excl[active[-1]] += t - prev
        if kind == 0:
            active.append(n)
        else:
            for i in range(len(active) - 1, -1, -1):
                if active[i] == n:
                    del active[i]
                    break
        prev = t
    return dict(excl)


def union_intervals(events: Iterable[Event]) -> list:
    """The union of the events' intervals, as sorted disjoint [s, e)."""
    out: list = []
    for s, e, _ in sorted(events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def capture(fn, n: int, path: str) -> float:
    """fn(0) … fn(n − 1) under torch's profiler (host and device activity)
    into the Chrome trace `path`; returns the seconds from the first call
    to the end of the last one's device work (the traced window)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(path), exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    return window


@dataclasses.dataclass
class TraceRecord:
    iters: int              # requests or steps traced
    window_s: float         # the traced window's length (host clock)
    busy_s: float           # device busy, averaged over the devices
    kernels: int            # kernel events (launches that ran)
    kernel_s: dict          # {kernel name: device seconds, total}
    exclusive_s: dict       # {kernel name: exclusive device seconds}
    idle_gaps: list         # [[host op, seconds]], longest total first

    def breakdown(self) -> dict:
        ops = sorted(self.exclusive_s.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:160], s] for n, s in ops[:TOP]],
                "idle_gaps": [[n[:160], s] for n, s in self.idle_gaps[:TOP]]}


def read(path: str, iters: int, window_s: float) -> TraceRecord:
    """The readings of trace `path` of `iters` calls. Raises LostRecords
    when a kernel launch has no kernel record, or when the trace holds no
    device event."""
    with open(path) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("ph") == "X"]
    device = [ev for ev in events if ev.get("cat") in DEVICE_CATEGORIES]
    if not device:
        raise LostRecords(f"the trace {path} holds no device events")
    done = {ev["args"].get("correlation") for ev in device}
    launch_calls = [ev for ev in events
                    if ev.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "Launch" in ev["name"] and "Kernel" in ev["name"]]
    lost = sum(ev["args"].get("correlation") not in done
               for ev in launch_calls)
    if lost:
        raise LostRecords(f"the trace {path} lost the kernel records of "
                          f"{lost} of its {len(launch_calls)} kernel "
                          "launches")

    per_dev = collections.defaultdict(list)
    kernel_s = collections.defaultdict(float)
    for ev in device:
        s = _ps(ev["ts"])
        per_dev[ev["args"].get("device", 0)].append(
            (s, s + _ps(ev["dur"]), ev["name"]))
        if ev["cat"] == "kernel":
            kernel_s[ev["name"]] += ev["dur"] / 1e6
    exclusive = collections.defaultdict(float)
    for evs in per_dev.values():
        for n, ps in exclusive_times(evs).items():
            exclusive[n] += ps / 1e12
    busy = sum(exclusive.values()) / len(per_dev)

    return TraceRecord(
        iters=iters, window_s=window_s, busy_s=busy,
        kernels=sum(ev["cat"] == "kernel" for ev in device),
        kernel_s=dict(kernel_s), exclusive_s=dict(exclusive),
        idle_gaps=_idle_gaps(events, per_dev))


def _idle_gaps(events: list, per_dev: dict) -> list:
    """[[host op, seconds]]: the gaps in each device's busy union between
    its first and last event, summed by the innermost host operation open
    at each gap's middle (over the threads that launched work), longest
    total first."""
    launchers = {ev["tid"] for ev in events
                 if ev.get("cat") in ("cuda_runtime", "cuda_driver")}
    host = collections.defaultdict(list)
    for ev in events:
        if ev.get("cat") in HOST_CATEGORIES and ev["tid"] in launchers:
            host[ev["tid"]].append((_ps(ev["ts"]),
                                    _ps(ev["ts"]) + _ps(ev["dur"]),
                                    ev["name"]))
    for evs in host.values():
        evs.sort(key=lambda e: (e[0], -e[1]))
    gaps = []
    for evs in per_dev.values():
        u = union_intervals(evs)
        gaps += [(a[1], b[0]) for a, b in zip(u, u[1:]) if b[0] > a[1]]
    gaps.sort()
    totals = collections.defaultdict(float)
    sweeps = {tid: [0, []] for tid in host}     # next event, open stack
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        best = None
        for tid, evs in host.items():
            nxt, stack = sweeps[tid]
            while nxt < len(evs) and evs[nxt][0] <= mid:
                while stack and stack[-1][1] <= evs[nxt][0]:
                    stack.pop()
                stack.append(evs[nxt])
                nxt += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            sweeps[tid][0] = nxt
            if stack and (best is None or stack[-1][0] > best[0]):
                best = stack[-1]
        totals[best[2] if best else "(no host operation)"] += \
            (g1 - g0) / 1e12
    return sorted(([n, s] for n, s in totals.items()), key=lambda x: -x[1])
