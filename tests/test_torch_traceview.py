"""The port's device-trace analysis (gridgcn_torch.utils.traceview) and
the busy time built on it (utils.profiling.busy_ms_per_iter), on the CPU.

`exclusive_times` is held against the JAX package's on its own cases and
on 200 random event sets (the same dicts, exactly: integer picoseconds).
`load_events` reads the Chrome trace JSON that `profiling.trace` writes:
a hand-written trace shows which events count (kernels, copies and fills
of each device, every stream of a device merged, devices apart), and a
real CPU trace shows that a run without a card has no device events.
"""

import json

import numpy as np
import pytest
import torch

from gridgcn_tpu.utils import traceview as jtraceview
from gridgcn_torch.utils import profiling, traceview

torch.set_num_threads(1)

# the JAX package's cases (tests/test_utils.py), with their dicts
JAX_CASES = [
    # copy-start [0, 100) wraps fusion.a [10, 40) and fusion.b [60, 80)
    ([(0, 100, "copy"), (10, 40, "a"), (60, 80, "b")],
     {"copy": 50, "a": 30, "b": 20}),
    # nested same-name and zero-length events
    ([(0, 10, "x"), (2, 8, "x"), (5, 5, "zero")], {"x": 10}),
    # disjoint with idle gap: busy = 6, not span (=10)
    ([(0, 4, "p"), (8, 10, "q")], {"p": 4, "q": 2}),
]


@pytest.mark.parametrize("events,want", JAX_CASES, ids=range(len(JAX_CASES)))
def test_exclusive_times_on_the_jax_cases(events, want):
    got = traceview.exclusive_times(events)
    assert got == want == jtraceview.exclusive_times(events)


def test_exclusive_times_equals_jax_on_random_event_sets():
    """200 random sets (overlapping, nested, repeated names, zero-length
    events): the same dict as the JAX package's, summing to the union of
    the events' intervals."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(0, 12))
        start = rng.integers(0, 100, n)
        end = start + rng.integers(0, 40, n)
        names = rng.choice(list("abcd"), n)
        events = sorted((int(s), int(e), str(m))
                        for s, e, m in zip(start, end, names))
        got = traceview.exclusive_times(events)
        assert got == jtraceview.exclusive_times(events)
        covered = set()
        for s, e, _ in events:
            covered.update(range(s, e))
        assert sum(got.values()) == len(covered)


def _event(cat, name, ts, dur, device=0, stream=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": device,
            "tid": stream, "ts": ts, "dur": dur,
            "args": {"device": device, "stream": stream}}


SYNTHETIC = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}},
    # host work: ignored
    _event("cpu_op", "aten::mm", 0.0, 50.0),
    _event("cuda_runtime", "cudaLaunchKernel", 1.0, 2.0),
    _event("gpu_user_annotation", "request", 10.0, 30.0),
    # device 0, stream 7: a kernel, a copy; stream 20: a fill overlapping
    _event("kernel", "void knn3_mxu_kernel<3, 2>(float const*)",
           10.0, 5.5),
    _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 20.0, 2.001),
    _event("gpu_memset", "Memset (Device)", 12.0, 6.0, stream=20),
    # device 1: apart, at the same time as device 0
    _event("kernel", "void other_kernel()", 10.0, 1.25, device=1),
]}


def _write(tmp_path, trace):
    (tmp_path / "trace.json").write_text(json.dumps(trace))
    return str(tmp_path)


def test_load_events_merges_streams_keeps_devices_apart(tmp_path):
    logdir = _write(tmp_path, SYNTHETIC)
    ev = traceview.load_events(logdir)
    assert sorted(ev) == ["cuda:0", "cuda:1"]
    # microseconds (nanosecond resolution) become integer picoseconds
    assert ev["cuda:0"] == [
        (10_000_000, 15_500_000, "void knn3_mxu_kernel<3, 2>(float const*)"),
        (12_000_000, 18_000_000, "Memset (Device)"),
        (20_000_000, 22_001_000, "Memcpy HtoD (Pageable -> Device)")]
    assert ev["cuda:1"] == [(10_000_000, 11_250_000, "void other_kernel()")]
    # device 0's busy time is the union of its two streams: [10, 18) and
    # [20, 22.001) µs; device 1's is its own
    busy = profiling.busy_ms_per_iter(logdir, 1)
    assert busy == pytest.approx((8.0 + 2.001 + 1.25) / 1e3, abs=1e-12)
    assert profiling.busy_ms_per_iter(logdir, 2) == pytest.approx(busy / 2)
    # the fill started last: it takes [12, 18) from the kernel
    assert traceview.exclusive_times(ev["cuda:0"]) == {
        "void knn3_mxu_kernel<3, 2>(float const*)": 2_000_000,
        "Memset (Device)": 6_000_000,
        "Memcpy HtoD (Pageable -> Device)": 2_001_000}


def test_main_reports_the_synthetic_trace(tmp_path, capsys):
    traceview.main([_write(tmp_path, SYNTHETIC), "--iters", "2",
                    "--topn", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    # span 10 .. 22.001 µs, busy 11.251 µs over both devices; the top two
    # by exclusive time, per iteration
    assert lines == [
        "span 0.01 ms, busy 0.01 ms, idle 0.00 ms  "
        "(2 iters => 0.01 ms/iter busy)",
        "   0.0030 ms  Memset (Device)",
        "   0.0010 ms  Memcpy HtoD (Pageable -> Device)"]


def test_a_cpu_trace_has_no_device_events(tmp_path):
    a = torch.rand(64, 64)
    with profiling.trace(str(tmp_path)):
        torch.mm(a, a)
    assert traceview.load_events(str(tmp_path)) == {}
    assert traceview.report(str(tmp_path)).startswith("no device events")
    assert profiling.busy_ms_per_iter(str(tmp_path), 1) is None


def test_a_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        traceview.load_events(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        profiling.busy_ms_per_iter(str(tmp_path / "none"), 1)
