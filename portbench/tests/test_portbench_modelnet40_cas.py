"""The `modelnet40_cas` configuration and its cell `modelnet40_cas.serve`:
the benchmark's plain classifier (`reference/classification.py`) against
the port's `GridGCNClassifier` on a tiny configuration with CAS in every
layer; the frozen generator `generators/shapes40.py` against the port's
`synthetic_shapes40` and on its own; the cell's files, pool and requests;
and the head's reader `head_device_ms.serve` on a hand-made classifier
request."""

import dataclasses
import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

import tiny
from harness import spec, traffic, weights
from reference.config import from_dict as ref_from_dict
from reference.serve import ServeReference

KEY = np.array([0, 77], np.uint32)
CELL = "modelnet40_cas.serve"


def _cls_config():
    """`synthetic_tiny` with CAS (2 rounds) in every layer, float32."""
    from gridgcn_torch.configs import presets

    cfg = presets.synthetic_tiny()
    layers = tuple(dataclasses.replace(s, sampler="cas", cas_iters=2)
                   for s in cfg.model.layers)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, layers=layers))


@pytest.mark.parametrize("seed", [4, 2**31 + 3])
def test_served_classifier_against_the_benchmarks_reference(seed):
    """The classifier the configuration names, found by that name in the
    benchmark's own `reference/`, against the port served in float32 on
    seeded random weights: logits [B, C]."""
    from gridgcn_torch.api import Predictor
    from gridgcn_torch.configs import base

    cell = spec.load_cell(CELL)
    net = spec.reference_network(cell.config_file, cell.bench_dir)
    assert net.__module__ == "reference.classification"
    port_cfg = _cls_config()
    ref_cfg = ref_from_dict(base.to_dict(port_cfg))
    sd = weights.make_state_dict(ref_cfg.model, seed, "cpu", net)
    pool = traffic.make_pool({"generator": "shapes40", "pool": 4,
                              "params": {"num_points": 256}}, seed)
    got = Predictor(port_cfg, sd, device="cpu")(pool.xyz, rng=KEY)
    want = ServeReference(ref_cfg, sd, "cpu", net=net)(pool.xyz, KEY).numpy()
    assert got.shape == want.shape == (4, port_cfg.model.num_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.ptp(want))


def test_tests_classifier_builds_the_same_module_tree(tmp_path):
    """The classifier file the tests add (`added/reference/classifier.py`)
    and the benchmark's own hold the same weights by name and shape."""
    from gridgcn_torch.configs import base, presets

    shutil.copytree(tiny.ADDED / "reference", tmp_path / "reference")
    added = spec.reference_network(
        {"reference_model": "classifier:GridGCNClassifier"}, tmp_path)
    own = spec.reference_network(spec.load_cell(CELL).config_file)
    assert added.__name__ == own.__name__ == "GridGCNClassifier"
    assert added is not own
    mc = ref_from_dict(base.to_dict(presets.modelnet40_cas())).model
    assert weights.layout(mc, added) == weights.layout(mc, own)


@pytest.mark.parametrize("seed", [0, 2**31 + 12345])
def test_shapes40_is_the_ports_geometry(seed):
    """Drawn class by class from one stream, as the port's
    `synthetic_shapes40` draws its clouds, the generator's clouds are the
    port's, bit for bit."""
    from gridgcn_torch.data.synthetic import synthetic_shapes40

    pts, labels = synthetic_shapes40(42, 1024, seed)
    gen = spec._load(spec.BENCH_DIR / "generators/shapes40.py",
                     "portbench_generator_shapes40", "generate")
    rng = np.random.default_rng(seed)
    for p, label in zip(pts, labels):
        np.testing.assert_array_equal(gen.cloud(rng, int(label), 1024), p)


def test_shapes40_clouds():
    gen = spec.load_generator(spec.BENCH_DIR, "shapes40")
    params = {"num_points": 1024}
    seed = 2**31 + 99
    xyz, feat, label = gen(seed, True, params)
    assert xyz.shape == (1024, 3) and xyz.dtype == np.float32
    assert feat is None and label.dtype == np.int32 and 0 <= label < 40
    assert np.abs(xyz).max() <= 1.0
    again = gen(seed, True, params)
    np.testing.assert_array_equal(xyz, again[0])
    assert again[2] == label and gen(seed, False, params)[2] is None
    np.testing.assert_array_equal(gen(seed, False, params)[0], xyz)
    assert not np.array_equal(gen(seed + 1, False, params)[0], xyz)
    # every class is reachable, each cloud's class drawn from its seed
    classes = {int(gen(s, True, {"num_points": 64})[2]) for s in range(400)}
    assert classes == set(range(40))


def test_shapes40_pool_labels_per_cloud():
    wl = {"generator": "shapes40", "pool": 8, "labels": True,
          "params": {"num_points": 128}}
    pool = traffic.make_pool(wl, 2**31 + 3)
    assert pool.xyz.shape == (8, 128, 3) and pool.feat is None
    assert pool.labels.shape == (8,) and pool.labels.dtype == np.int32


def test_cell_sizes():
    """Its files found by name, a pool of 64 clouds of 1024 points without
    features, cut into 4 requests of 16, judged against the plain
    classifier; the metrics it reports."""
    cell = spec.load_cell(CELL)
    wl = cell.workload
    assert cell.config_name == "modelnet40_cas" and wl["driver"] == "serve"
    assert cell.config_file["config"]["model"]["task"] == "cls"
    assert {s["sampler"] for s in
            cell.config_file["config"]["model"]["layers"]} == {"cas"}
    assert spec.reference_network(
        cell.config_file, cell.bench_dir).__name__ == "GridGCNClassifier"
    pool = traffic.make_pool(wl, 2**31 + 21, cell.bench_dir)
    assert pool.xyz.shape == (64, 1024, 3) and pool.feat is None
    assert pool.labels is None
    reqs = traffic.requests(pool, int(wl["batch"]))
    assert len(reqs) == 4 and all(r.xyz.shape == (16, 1024, 3)
                                  for r in reqs)
    per_layer = {m.name for m in cell.per_layer}
    assert "head_device_ms.serve" in per_layer
    assert not per_layer & {"knn3_mxu_roofline.serve",
                            "decoder_device_ms.serve",
                            "crop_points_per_s.serve"}
    assert [m.name for m in cell.end_to_end] == ["serve_latency_p95_ms",
                                                 "setup_s"]


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


# µs: a classifier's request: a layer, then the head (pool, head MLP,
# logits) and the fetch
CLASSIFIER = [
    _span("request#0", 0, 200), _span("copy_in", 0, 10),
    _span("gridconv0", 10, 90), _span("voxelize", 10, 30),
    _span("gca", 40, 60), _span("head", 100, 60), _span("fetch", 160, 40),
    *_launch(1, 15, "kernel", "k_vox", 20, 5),
    *_launch(2, 45, "kernel", "k_gca", 50, 9),
    *_launch(3, 105, "kernel", "k_pool", 110, 3),
    *_launch(4, 120, "kernel", "k_mlp", 125, 4),
    *_launch(5, 140, "kernel", "k_logits", 150, 2),
    *_launch(6, 165, "gpu_memcpy", "Memcpy DtoH", 170, 20),
]


def test_head_reader(tmp_path):
    """The head's device time a request, beside the fetch's; nothing
    where no head span opens or no sound trace was taken."""
    root = tmp_path / "root"
    shutil.copytree(spec.BENCH_DIR / "metrics", root / "portbench/metrics")
    trace = root / "build/portbench/trace.json"
    trace.parent.mkdir(parents=True)
    mods = {n: spec.load_reader(root / "portbench/metrics" / f"{n}.py")
            for n in ("head_device_ms.serve", "fetch_device_ms.serve",
                      "unspanned_launch_share.serve")}
    head = mods["head_device_ms.serve"]
    run = SimpleNamespace(driver="serve", trace=SimpleNamespace(iters=2))
    # a trace that opens no head span: nothing to read
    trace.write_text(json.dumps({"traceEvents": [
        e for e in CLASSIFIER if e["name"] != "gridgcn/head"]}))
    assert head.read(run) is None
    assert head.read(SimpleNamespace(driver="serve", trace=None)) is None
    trace.write_text(json.dumps({"traceEvents": CLASSIFIER}))
    run = SimpleNamespace(driver="serve", trace=SimpleNamespace(iters=2))
    # the pool 3, the head MLP 4 and the logits 2, over 2 requests
    assert head.read(run) == pytest.approx(9e-3 / 2)
    assert "request/head" in head.info(run)
    assert mods["fetch_device_ms.serve"].read(run) == pytest.approx(
        20e-3 / 2)
    assert mods["unspanned_launch_share.serve"].read(run) == 0.0
