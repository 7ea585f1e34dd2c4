"""The program's spans in a hand-made Chrome trace: device time and kernel
launches by the innermost span open at the launch (matched by
`correlation`), the device's idle gaps charged to the innermost span open
at each gap's middle, "(outside the program)" where none is, host self
time, the coverage share, and the readers on it: a number from the
program's spans, None where the harness refused the trace or where the
trace has no program span. The CAGQ and GCA readers also on a trace of
two encoder layers and a decoder stage whose grid query has CAGQ's spans
outside every layer."""

import json
import shutil
from types import SimpleNamespace

import pytest

from harness import program_spans, spec

READERS = ["rng_launches_per_request.serve", "cagq_idle_share.serve",
           "decoder_device_ms.serve", "fetch_device_ms.serve",
           "unspanned_launch_share.serve", "cagq_device_ms.serve",
           "gca_device_ms.serve"]
REQ = ("request",)
LAYER = REQ + ("gridconv0",)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _span(name, ts, dur):
    return _x("user_annotation", "gridgcn/" + name, ts, dur)


def _launch(corr, ts, dev_cat, dev_name, dev_ts, dev_dur):
    """A host launch at ts (thread 1) and its device record (device 0)."""
    call = ("cudaLaunchKernel" if dev_cat == "kernel"
            else "cudaMemcpyAsync")
    return [_x("cuda_runtime", call, ts, 1, correlation=corr),
            _x(dev_cat, dev_name, dev_ts, dev_dur, tid=7, device=0,
               stream=7, correlation=corr)]


# µs: one request #3 with a layer (a draw inside voxelize, then gca), a
# launch under the request alone, a decoder stage with its 3-NN, the
# fetch, and a kernel launched after the request under no span
EVENTS = [
    _span("request#3", 0, 200), _span("copy_in", 0, 10),
    _span("gridconv0", 10, 90), _span("voxelize", 10, 50),
    _span("jaxrng", 20, 20), _span("gca", 60, 40),
    _span("up0", 105, 45), _span("knn3", 105, 15),
    _span("fetch", 150, 50),
    _x("cpu_op", "aten::add", 300, 5),            # no span, no launch
    *_launch(1, 2, "gpu_memcpy", "Memcpy HtoD", 5, 4),
    *_launch(2, 25, "kernel", "k_rng", 32, 8),
    *_launch(3, 45, "kernel", "k_vox", 50, 5),
    *_launch(4, 70, "kernel", "k_gca", 75, 22),
    *_launch(5, 101, "kernel", "k_req", 103, 2),
    *_launch(6, 110, "kernel", "k_knn", 112, 6),
    *_launch(7, 125, "kernel", "k_mlp", 127, 8),
    *_launch(8, 155, "gpu_memcpy", "Memcpy DtoH", 160, 30),
    *_launch(9, 210, "kernel", "k_out", 215, 5),
]
# device gaps (µs) and the span open at each middle: 9-32 jaxrng,
# 40-50 voxelize, 55-75 gca, 97-103 the request (gridconv0 ended at 100),
# 105-112 knn3, 118-127 and 135-160 up0, 190-215 none (after the request)
IDLE = {LAYER + ("voxelize", "jaxrng"): 23, LAYER + ("voxelize",): 10,
        LAYER + ("gca",): 20, REQ: 6, REQ + ("up0", "knn3"): 7,
        REQ + ("up0",): 34, (): 25}
# of the request's 100 µs idle, CAGQ's voxelize and its draw hold 33
DEVICE = {REQ + ("copy_in",): 4, LAYER + ("voxelize", "jaxrng"): 8,
          LAYER + ("voxelize",): 5, LAYER + ("gca",): 22, REQ: 2,
          REQ + ("up0", "knn3"): 6, REQ + ("up0",): 8,
          REQ + ("fetch",): 30, (): 5}


def test_split_by_span():
    s = program_spans.split_events(EVENTS, iters=2)
    assert s.requests == [3]
    for path, us in DEVICE.items():
        assert s.rows[path].device_s == pytest.approx(us * 1e-6), path
        assert s.rows[path].kernels == (0 if path in (
            REQ + ("copy_in",), REQ + ("fetch",)) else 1), path
    for path, row in s.rows.items():
        assert row.idle_s == pytest.approx(IDLE.get(path, 0) * 1e-6), path
    assert () in s.rows and s.rows[()].spans == 0
    # host self: the request less its four children; voxelize less its draw
    assert s.rows[REQ].host_self_s == pytest.approx(5e-6)
    assert s.rows[LAYER].host_self_s == pytest.approx(0.0, abs=1e-12)
    assert s.rows[LAYER + ("voxelize",)].host_self_s == \
        pytest.approx(30e-6)
    # inclusive sums and the coverage's launches
    assert s.per_request("device_s", lambda p: p[:2] == LAYER) == \
        pytest.approx(35e-6 / 2)
    assert s.total("kernels", program_spans.unspanned) == 2
    assert s.total("kernels", lambda p: True) == 7
    rows = {r.split(" | ")[0].strip(): r.split(" | ")[1:]
            for r in s.table().splitlines()[1:]}
    # device ms, kernels, idle self, idle with children, host self, spans
    assert [float(v) for v in rows["request/gridconv0"]] == pytest.approx(
        [35e-3 / 2, 1.5, 0.0, 53e-3 / 2, 0.0, 0.5], abs=1e-12)
    assert [float(v) for v in rows[program_spans.OUTSIDE]] == \
        pytest.approx([5e-3 / 2, 0.5, 25e-3 / 2, 25e-3 / 2, 0.0, 0.0])


def test_no_program_span_reads_none():
    plain = [e for e in EVENTS if e["cat"] != "user_annotation"]
    assert program_spans.split_events(plain, iters=2) is None


@pytest.fixture
def readers(tmp_path):
    """The readers in a copy of the benchmark's folder under tmp_path,
    with the hand-made trace where the traced run leaves its trace."""
    root = tmp_path / "root"
    shutil.copytree(spec.BENCH_DIR / "metrics", root / "portbench/metrics")
    trace = root / "build/portbench/trace.json"
    trace.parent.mkdir(parents=True)

    def write(events):
        trace.write_text(json.dumps({"traceEvents": events}))
    write(EVENTS)
    mods = {n: spec.load_reader(root / "portbench/metrics" / f"{n}.py")
            for n in READERS}
    return mods, write


def _run(trace=True):
    return SimpleNamespace(driver="serve", trace=SimpleNamespace(iters=2)
                           if trace else None)


def test_readers(readers):
    mods, _ = readers
    run = _run()
    got = {n: m.read(run) for n, m in mods.items()}
    assert got == pytest.approx({
        "rng_launches_per_request.serve": 0.5,
        "cagq_idle_share.serve": 100 * 33 / 100,
        "decoder_device_ms.serve": 14e-3 / 2,
        "fetch_device_ms.serve": 30e-3 / 2,
        "unspanned_launch_share.serve": 100 * 2 / 7,
        # gridconv0 less its gca: the draw 8 µs and voxelize's own 5
        "cagq_device_ms.serve": 13e-3 / 2,
        "gca_device_ms.serve": 22e-3 / 2})
    for n, m in mods.items():
        assert m.info(run), n
    assert "gridconv0/voxelize/jaxrng" in \
        mods["rng_launches_per_request.serve"].info(run)


def test_readers_read_none_without_a_sound_trace_or_spans(readers):
    mods, write = readers
    for m in mods.values():
        assert m.read(_run(trace=False)) is None
        assert m.info(_run(trace=False)) is None
    write([e for e in EVENTS if e["cat"] != "user_annotation"])
    run = _run()
    for m in mods.values():
        assert m.read(run) is None and m.info(run) is None
    train = SimpleNamespace(driver="train", trace=SimpleNamespace(iters=2))
    assert all(m.read(train) is None for m in mods.values())


# µs: two layers, each CAGQ (voxelize, then group) and GCA, then a decoder
# stage whose grid query runs voxelize outside every layer
LAYERS = [
    _span("request#0", 0, 300),
    _span("gridconv0", 0, 100), _span("voxelize", 0, 30),
    _span("group", 30, 20), _span("gca", 50, 50),
    _span("gridconv1", 100, 100), _span("sample", 100, 40),
    _span("gca", 140, 60),
    _span("up0", 200, 100), _span("voxelize", 200, 50),
    *_launch(1, 5, "kernel", "k_vox0", 10, 3),
    *_launch(2, 35, "kernel", "k_grp0", 40, 4),
    *_launch(3, 60, "kernel", "k_gca0", 65, 7),
    *_launch(4, 110, "kernel", "k_smp1", 115, 11),
    *_launch(5, 150, "kernel", "k_gca1", 155, 13),
    *_launch(6, 210, "kernel", "k_vox_up", 215, 17),
]


def test_cagq_and_gca_by_layer(readers):
    mods, write = readers
    write(LAYERS)
    run = _run()
    # CAGQ: 3 + 4 (layer 0) + 11 (layer 1); the decoder's voxelize is not
    # a layer's; GCA: 7 + 13
    assert mods["cagq_device_ms.serve"].read(run) == pytest.approx(
        18e-3 / 2)
    assert mods["gca_device_ms.serve"].read(run) == pytest.approx(20e-3 / 2)
    assert "request/gridconv1/sample" in \
        mods["cagq_device_ms.serve"].info(run)
    # a program without the layers' spans (gca alone) gives neither
    write([e for e in LAYERS if "gridgcn/gridconv" not in e["name"]])
    run = _run()                # a new traced run: its trace read anew
    assert mods["cagq_device_ms.serve"].read(run) is None
    assert mods["gca_device_ms.serve"].read(run) is None
