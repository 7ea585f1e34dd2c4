"""The trace reader on a hand-made Chrome trace: the busy union over two
streams, the idle gaps by the host operation open during each, and the
refusal of a trace that lost a kernel record. (The program's spans are
`program_spans.py`'s, tested in test_portbench_program_spans.py.)"""

import json

import pytest

from harness import tracing


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _trace(tmp_path, lose=False):
    ev = [
        # host: a span around a layer with its GCA inside, an op outside
        _x("user_annotation", "gridgcn/gridconv0", 0, 100),
        _x("user_annotation", "gridgcn/gca", 50, 40),
        _x("cpu_op", "aten::nonzero", 100, 60),
        # launches (host thread 1) and their kernels (device 0)
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 2, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 120, 2, correlation=3),
        _x("kernel", "k_a", 20, 30, tid=7, device=0, stream=7,
           correlation=1),
        _x("kernel", "k_b", 40, 30, tid=8, device=0, stream=8,
           correlation=2),
        _x("kernel", "k_c", 130, 10, tid=7, device=0, stream=7,
           correlation=3),
    ]
    if lose:
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", 150, 2,
                     correlation=4))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_busy_union_spans_and_gaps(tmp_path):
    rec = tracing.read(_trace(tmp_path), iters=2, window_s=0.001)
    # k_a [20, 50) and k_b [40, 70) overlap: the union is 50 µs, + k_c 10
    assert rec.busy_s == pytest.approx(60e-6)
    assert rec.kernels == 3
    assert rec.exclusive_s["k_a"] == pytest.approx(20e-6)
    assert rec.exclusive_s["k_b"] == pytest.approx(30e-6)
    assert rec.kernel_s["k_a"] == pytest.approx(30e-6)
    # the one gap [70, 130) has aten::nonzero open at its middle
    assert rec.idle_gaps == [["aten::nonzero", pytest.approx(60e-6)]]
    b = rec.breakdown()
    assert b["device_ops"][0][0] == "k_b" and len(b["idle_gaps"]) == 1


def test_refuses_a_trace_that_lost_records(tmp_path):
    with pytest.raises(tracing.LostRecords, match="1 of its 4"):
        tracing.read(_trace(tmp_path, lose=True), iters=2, window_s=0.001)


def test_refuses_a_trace_without_device_events(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        _x("cpu_op", "aten::add", 0, 10)]}))
    with pytest.raises(tracing.LostRecords):
        tracing.read(str(path), iters=1, window_s=0.001)


def test_readers_skip_a_refused_trace():
    from types import SimpleNamespace

    from harness import readers

    run = SimpleNamespace(driver="serve", trace=None, window_s=1.0, calls=4)
    assert readers.idle_share(run, "serve") is None
    assert readers.launches_per_call(run, "serve") is None
    assert readers.mfu(run, "serve", passes=1) is None
