"""Device-trace analysis: aggregate a `torch.profiler` trace by kernel
(the JAX package's `utils/traceview.py`, on Chrome trace JSON in place of
xplane protos).

This module turns the `logdir/trace.json` that `utils.profiling.trace`
writes into the two tables that matter on a device timeline:

  * total per-kernel duration — misleading where streams overlap (the
    column then sums to more than the device was busy);
  * EXCLUSIVE per-kernel time — a sweep over event boundaries attributing
    each instant to the innermost (most recently started) active event.
    Summing it gives the device's busy time (the union over its streams),
    so the top rows are the actual critical path.

Usage:
    from gridgcn_torch.utils.profiling import trace
    with trace("tr"):
        ...                      # run the request a few times
    python -m gridgcn_torch.utils.traceview tr --iters 10
"""

from __future__ import annotations

import collections
import json
import os
from typing import Iterable, List, Tuple

Event = Tuple[int, int, str]   # (start_ps, end_ps, kernel name)

# the Chrome trace categories of work on the card: kernels, copies and
# fills ("gpu_user_annotation" spans wrap kernels and are not work)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def exclusive_times(events: Iterable[Event]) -> dict[str, int]:
    """Exclusive (self) time per event name, in picoseconds.

    Each instant of the timeline is attributed to the most recently started
    still-active event ("innermost"), so an event overlapped by another
    stream's only gets charged for the time nothing else runs inside it.
    The values sum to total busy time.
    """
    bounds: List[Tuple[int, int, str]] = []
    for s, e, n in events:
        if e > s:
            bounds.append((s, 0, n))
            bounds.append((e, 1, n))
    bounds.sort(key=lambda b: (b[0], b[1]))

    excl: dict[str, int] = collections.defaultdict(int)
    active: List[str] = []          # started-order stack (latest last)
    prev: int | None = None
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


def _ps(us: float) -> int:
    """Chrome trace microseconds (nanosecond resolution) to picoseconds."""
    return round(us * 1e3) * 1000


def load_events(logdir: str) -> dict[str, List[Event]]:
    """Read the device events of `logdir/trace.json`.

    Returns one event list PER device (keyed "cuda:<index>"), every stream
    of a device merged: the innermost-active attribution of
    `exclusive_times` then gives the union of the device's streams, and
    two devices are never merged (an event on one would steal exclusive
    time from one running at the same time on the other). A trace with no
    device events (a CPU run) gives {}."""
    per_device: dict[str, List[Event]] = collections.defaultdict(list)
    for ev in _trace_events(logdir):
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        start = _ps(ev["ts"])
        per_device[f"cuda:{ev['args']['device']}"].append(
            (start, start + _ps(ev["dur"]), ev["name"]))
    for events in per_device.values():
        events.sort()
    return dict(per_device)


def _trace_events(logdir: str) -> list:
    path = os.path.join(logdir, "trace.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no trace.json under {logdir}")
    with open(path) as f:
        return json.load(f)["traceEvents"]


def lost_records(logdir: str) -> tuple[int, int]:
    """(kernel launches without a kernel record, kernel launches) of
    `logdir`'s trace: the host's launch calls (`cuda_runtime` and
    `cuda_driver` events such as cudaLaunchKernel, cuLaunchKernelEx),
    each matched to the device events by its correlation id; a complete
    trace of synchronized work loses none. Copies and fills are not
    counted: a fill of no bytes (cuBLAS's, in addmm) has no record."""
    events = _trace_events(logdir)
    done = {ev["args"].get("correlation") for ev in events
            if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES}
    launches = [ev["args"].get("correlation") for ev in events
                if ev.get("ph") == "X"
                and ev.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in ev["name"] and "Kernel" in ev["name"]]
    return sum(c not in done for c in launches), len(launches)


def exclusive_ms(logdir: str, iters: int = 1) -> dict[str, float]:
    """Exclusive ms per iteration of each kernel name in `logdir`'s trace,
    attributed within each device's own timeline, then summed across the
    devices; the values sum to the busy time. {} for a CPU trace."""
    excl: dict[str, float] = collections.defaultdict(float)
    for events in load_events(logdir).values():
        for n, ps in exclusive_times(events).items():
            excl[n] += ps / iters / 1e9
    return dict(excl)


def report(logdir: str, iters: int = 1, topn: int = 30) -> str:
    devices = load_events(logdir)
    if not devices:
        return (f"no device events under {logdir} "
                "(CPU traces carry none; run on the card)")
    excl = exclusive_ms(logdir)
    span = (max(ev[1] for e in devices.values() for ev in e) - min(
        e[0][0] for e in devices.values())) / 1e9
    busy = sum(excl.values())
    lines = [
        f"span {span:.2f} ms, busy {busy:.2f} ms, "
        f"idle {span - busy:.2f} ms"
        + (f"  ({iters} iters => {busy / iters:.2f} ms/iter busy)"
           if iters > 1 else "")
    ]
    for n, ms in sorted(excl.items(), key=lambda kv: -kv[1])[:topn]:
        lines.append(f"{ms / iters:9.4f} ms  {n[:110]}")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("logdir")
    p.add_argument("--iters", type=int, default=1,
                   help="iterations captured; per-kernel times are divided "
                   "by it")
    p.add_argument("--topn", type=int, default=30)
    args = p.parse_args(argv)
    print(report(args.logdir, iters=args.iters, topn=args.topn))


if __name__ == "__main__":
    main()
