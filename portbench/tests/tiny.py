"""A tiny copy of the benchmark for the CPU tests: the benchmark's folder
copied into a temporary root, with small configurations and cells added as
files and entries only:

  * `tiny`: the `synthetic_tiny_seg` preset made like `scannet_seg` (CAS
    in layer 0, the kernel-path decoder, bf16 with f32 BatchNorm, the
    ignore label, dropout), with a serving and a training cell;
  * `tiny_feat`: the same with three input channels, served one cloud a
    request from a generator that gives colour-like features
    (`added/generators/shapes.py`, copied in);
  * `tiny_cls`: the `synthetic_tiny` classifier made like
    `modelnet40_cas` (CAS in every layer, served in bf16), two clouds a
    request, its reference network a file copied into the root's
    `reference/` (`added/reference/classifier.py`) and named by the
    configuration's `"reference_model"`."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
ADDED = Path(__file__).resolve().parent / "added"    # files a PR would add
SERVE, TRAIN = "tiny.serve", "tiny.train"
FEAT, CLS = "tiny_feat.serve", "tiny_cls.serve"
# the training cell's metrics: their readers stay in metrics/ while no cell
# of BENCHMARK.json reports them, and the tiny training cell reads them
TRAIN_METRICS = [
    {"name": "train_points_per_s", "unit": "points/s", "better": "higher",
     "bound": 0.25, "source": "host_clock"},
    {"name": "launches_per_step.train", "unit": "launches",
     "better": "lower", "source": "device_trace", "layer": "training",
     "moves": "train_points_per_s"},
    {"name": "knn3_mxu_roofline.train", "unit": "%", "better": "higher",
     "source": "device_trace", "layer": "kernels",
     "moves": "train_points_per_s"},
    {"name": "idle_share.train", "unit": "%", "better": "lower",
     "source": "device_trace", "layer": "device",
     "moves": "train_points_per_s"},
    {"name": "mfu.train", "unit": "%", "better": "higher",
     "source": "host_clock", "layer": "whole step",
     "moves": "train_points_per_s"},
]


def tiny_config() -> dict:
    from gridgcn_torch.configs import base, presets

    cfg = presets.synthetic_tiny_seg()
    layers = list(cfg.model.layers)
    layers[0] = dataclasses.replace(layers[0], sampler="cas", cas_iters=2)
    ups = tuple(dataclasses.replace(u, method="pallas")
                for u in cfg.model.up_layers)
    model = dataclasses.replace(
        cfg.model, layers=tuple(layers), up_layers=ups, dtype="bfloat16",
        bn_dtype="float32", ignore_label=0, dropout=0.5)
    data = dataclasses.replace(cfg.data, augment=True, num_points=2048)
    return base.to_dict(dataclasses.replace(cfg, model=model, data=data))


def feat_config() -> dict:
    """`tiny` with three input channels (xyz, then three colour-like
    ones)."""
    cfg = tiny_config()
    cfg["name"] = "tiny_feat"
    cfg["model"]["in_channels"] = 3
    cfg["data"]["num_feats"] = 3
    return cfg


def cls_config() -> dict:
    from gridgcn_torch.configs import base, presets

    cfg = presets.synthetic_tiny()
    layers = tuple(dataclasses.replace(spec, sampler="cas", cas_iters=2)
                   for spec in cfg.model.layers)
    model = dataclasses.replace(cfg.model, layers=layers,
                                eval_dtype="bfloat16")
    data = dataclasses.replace(cfg.data, num_points=1024)
    return base.to_dict(dataclasses.replace(cfg, model=model, data=data))


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """A checkout-like root under tmp: BENCHMARK.json with the tiny cells
    and the benchmark's folder with the files they add; returns the
    root."""
    root = Path(tmp) / "root"
    shutil.copytree(BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copytree(ADDED, root / "portbench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    configs = {
        "tiny": {"preset": "synthetic_tiny_seg", "config": tiny_config()},
        "tiny_feat": {"preset": "synthetic_tiny_seg",
                      "config": feat_config()},
        "tiny_cls": {"preset": "synthetic_tiny", "config": cls_config(),
                     "reference_model": "classifier:GridGCNClassifier"},
    }
    for name, f in configs.items():
        (root / f"portbench/configs/{name}.json").write_text(json.dumps(
            {"name": name, "source": "test", "reduced": [], **f}))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    lim = limits or {}
    common = {"config": "tiny", "chips": 1, "pool": 4,
              "generator": "scene_surface", "params": {"num_points": 2048},
              "why": "test"}
    serve_limits = {"logit_rel_err": 0.05, "logit_max_gap": 0.2}
    serve = {"driver": "serve", "labels": False, "warmup": 1,
             "trace_iters": 2}
    cells = {
        SERVE: {**common, **serve, "batch": 2, "check": {
            "sample": 3, "limits": lim.get(SERVE, serve_limits)}},
        FEAT: {**common, **serve, "config": "tiny_feat", "batch": 1,
               "generator": "shapes",
               "params": {"num_points": 2048, "channels": 3},
               "check": {"sample": 3, "limits": lim.get(FEAT,
                                                        serve_limits)}},
        CLS: {**common, **serve, "config": "tiny_cls", "batch": 2,
              "generator": "shapes", "params": {"num_points": 1024},
              "check": {"sample": 3, "limits": lim.get(CLS,
                                                       serve_limits)}},
        TRAIN: {**common, "driver": "train", "batch": 4, "pool": 8,
                "labels": True,
                "warmup": 0, "trace_iters": 1, "check": {
                    "steps": 3, "limits": lim.get(TRAIN, {
                        "grad_gap_median": 0.03, "change_gap": 0.5})}},
    }
    for name, w in cells.items():
        (root / f"portbench/workloads/{name}.json").write_text(
            json.dumps({"name": name, **w}))
    bench["workloads"] += [{"name": n, "config": w["config"],
                            "traffic": n.split(".")[1], "chips": 1,
                            "why": "test"} for n, w in cells.items()]
    have = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for m in TRAIN_METRICS:
        if m["name"] not in have:
            part = "per_layer" if "moves" in m else "end_to_end"
            bench[part].append({**m, "workloads": []})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m.get("moves", m["name"]).startswith(
                ("serve", "train")):
            kind = "serve" if m.get("moves", m["name"]).startswith(
                "serve") else "train"
            m["workloads"] += [SERVE, FEAT, CLS] if kind == "serve" \
                else [TRAIN]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
