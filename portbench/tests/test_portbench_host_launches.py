"""`host_launches_per_request.serve` on hand-made Chrome traces: the host's
kernel and graph launch calls per traced request, an eager trace's one
call a kernel and a replayed trace's one call a graph, and None without a
serving run's sound trace."""

import json
import shutil
from types import SimpleNamespace

import pytest

from harness import spec

NAME = "host_launches_per_request.serve"


def _x(cat, name, ts, corr, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 1,
            "pid": 1, "tid": 1, "args": {"correlation": corr, **args}}


# two requests, eager: each kernel its own launch call, beside calls that
# launch nothing
EAGER = [
    _x("cuda_runtime", "cudaLaunchKernel", 1, 1),
    _x("cuda_runtime", "cudaLaunchKernelExC", 2, 2),
    _x("cuda_driver", "cuLaunchKernel", 3, 3),
    _x("cuda_runtime", "cudaMemcpyAsync", 4, 4),
    _x("cuda_runtime", "cudaStreamIsCapturing", 5, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 6, 6),
    *[_x("kernel", f"k{i}", 10 + i, i, device=0) for i in (1, 2, 3, 6)],
]
# two requests replayed: one graph launch for many kernels
REPLAYED = [
    _x("cuda_runtime", "cudaGraphLaunch", 1, 1),
    _x("cuda_runtime", "cudaGraphLaunch", 2, 2),
    _x("cuda_runtime", "cudaStreamIsCapturing", 3, 3),
    *[_x("kernel", f"k{i}", 10 + i, 1 + i % 2, device=0) for i in range(9)],
]


@pytest.fixture
def reader(tmp_path):
    """The reader in a copy of the benchmark's folder, its trace where the
    traced run leaves it."""
    root = tmp_path / "root"
    shutil.copytree(spec.BENCH_DIR / "metrics", root / "portbench/metrics")
    trace = root / "build/portbench/trace.json"
    trace.parent.mkdir(parents=True)

    def write(events):
        trace.write_text(json.dumps({"traceEvents": events}))
    return spec.load_reader(root / "portbench/metrics" / f"{NAME}.py"), write


def _run(driver="serve", trace=True):
    return SimpleNamespace(driver=driver, trace=SimpleNamespace(iters=2)
                           if trace else None)


@pytest.mark.parametrize("events,per_request,names", [
    (EAGER, 2.0, ["cuLaunchKernel", "cudaLaunchKernel",
                  "cudaLaunchKernelExC"]),
    (REPLAYED, 1.0, ["cudaGraphLaunch"])])
def test_launch_calls_per_request(reader, events, per_request, names):
    mod, write = reader
    write(events)
    assert mod.read(_run()) == per_request
    info = mod.info(_run())
    assert [part.split()[0] for part in info.split("; ")] == names


def test_none_without_a_serving_trace(reader):
    mod, write = reader
    write(EAGER)
    assert mod.read(_run(trace=False)) is None
    assert mod.info(_run(trace=False)) is None
    assert mod.read(_run(driver="train")) is None


def test_the_entry_lists_the_serving_cells():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    entry, = (m for m in bench["per_layer"] if m["name"] == NAME)
    mod = spec.load_reader(spec.BENCH_DIR / "metrics" / f"{NAME}.py")
    assert (mod.UNIT, mod.MOVES, mod.LAYER) == (
        entry["unit"], entry["moves"], entry["layer"])
    assert entry["better"] == "lower"
    assert sorted(entry["workloads"]) == sorted(
        w["name"] for w in bench["workloads"])
