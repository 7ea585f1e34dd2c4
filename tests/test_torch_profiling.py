"""`utils.profiling.busy_ms_per_iter` never reads a trace without device
events as an idle card, nor one that lost device records as a shorter
busy time: where CUDA is available such traces raise; on the CPU, where
no trace has device events, it is None."""

import json

import pytest
import torch

from gridgcn_torch.utils import profiling, traceview

torch.set_num_threads(1)


def _write(tmp_path, events) -> str:
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    return str(tmp_path)


CPU_ONLY = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 10.0,
     "dur": 4.0, "args": {}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "ts": 11.0, "dur": 2.0, "args": {"correlation": 7}},
    {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler", "ts": 0.0,
     "dur": 30.0, "args": {}},
    {"ph": "i", "cat": "kernel", "name": "not a complete event", "ts": 12.0,
     "args": {"device": 0}}]


def test_no_device_events_raise_where_cuda_is_available(tmp_path,
                                                        monkeypatch):
    logdir = _write(tmp_path, CPU_ONLY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="no device events"):
        profiling.busy_ms_per_iter(logdir, 1)


def test_no_device_events_read_none_on_the_cpu(tmp_path):
    assert profiling.busy_ms_per_iter(_write(tmp_path, CPU_ONLY), 1) is None


def test_a_cpu_trace_reads_none(tmp_path):
    a = torch.rand(32, 32)
    with profiling.trace(str(tmp_path)) as prof:
        torch.mm(a, a)
    assert profiling.busy_ms_per_iter(str(tmp_path), 1) is None
    assert "aten::mm" in {e.key for e in prof.key_averages()}


def test_device_events_read_as_busy_where_cuda_is_available(tmp_path,
                                                            monkeypatch):
    events = CPU_ONLY + [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 12.0, "dur": 3.0,
         "args": {"device": 0, "stream": 7, "correlation": 7}}]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert profiling.busy_ms_per_iter(_write(tmp_path, events), 3) == \
        pytest.approx(0.001)


def test_launches_without_kernel_records_raise(tmp_path, monkeypatch):
    """Two kernel launches, a copy and a fill of no bytes (no record) on
    the host, the kernel record of one launch lost: refused, where the
    complete trace reads."""
    runtime = [
        {"ph": "X", "cat": cat, "name": name, "ts": ts,
         "dur": 1.0, "args": {"correlation": c}}
        for cat, name, ts, c in (
            ("cuda_runtime", "cudaLaunchKernel", 11.0, 7),
            ("cuda_runtime", "cudaMemcpyAsync", 13.0, 8),
            ("cuda_driver", "cuLaunchKernelEx", 15.0, 9),
            ("cuda_runtime", "cudaMemsetAsync", 16.0, 11),
            ("cuda_runtime", "cudaStreamSynchronize", 17.0, 10))]
    device = [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 2.0,
         "args": {"device": 0, "stream": 7, "correlation": c}}
        for cat, name, ts, c in (("kernel", "k", 12.0, 7),
                                 ("gpu_memcpy", "Memcpy HtoD", 14.0, 8),
                                 ("kernel", "k2", 16.0, 9))]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    full = _write(tmp_path, runtime + device)
    assert traceview.lost_records(full) == (0, 2)
    assert profiling.busy_ms_per_iter(full, 1) == pytest.approx(0.006)
    lost = tmp_path / "lost"
    lost.mkdir()
    _write(lost, runtime + device[:2])
    assert traceview.lost_records(str(lost)) == (1, 2)
    with pytest.raises(RuntimeError, match="1 of its 2 kernel launches"):
        profiling.busy_ms_per_iter(str(lost), 1)
