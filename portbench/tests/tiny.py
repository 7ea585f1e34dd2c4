"""A tiny copy of the benchmark for the CPU tests: the benchmark's folder
copied into a temporary root, with one small configuration (the
`synthetic_tiny_seg` preset made like `scannet_seg`: CAS in layer 0, the
kernel-path decoder, bf16 with f32 BatchNorm, the ignore label, dropout)
and a serving and a training cell on it, added as files only."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
SERVE, TRAIN = "tiny.serve", "tiny.train"
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


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """A checkout-like root under tmp: BENCHMARK.json with the two tiny
    cells and the benchmark's folder; returns the root."""
    root = Path(tmp) / "root"
    shutil.copytree(BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg_file = {"name": "tiny", "preset": "synthetic_tiny_seg",
                "source": "test", "reduced": [], "config": tiny_config()}
    (root / "portbench/configs/tiny.json").write_text(json.dumps(cfg_file))
    lim = limits or {}
    common = {"config": "tiny", "chips": 1, "pool": 4,
              "generator": "scene_surface", "params": {"num_points": 2048},
              "why": "test"}
    cells = {
        SERVE: {**common, "driver": "serve", "batch": 2, "labels": False,
                "warmup": 1, "trace_iters": 2, "check": {
                    "sample": 3, "limits": lim.get(SERVE, {
                        "logit_rel_err": 0.05, "logit_max_gap": 0.2})}},
        TRAIN: {**common, "driver": "train", "batch": 4, "pool": 8,
                "labels": True,
                "warmup": 0, "trace_iters": 1, "check": {
                    "steps": 3, "limits": lim.get(TRAIN, {
                        "grad_gap_median": 0.03, "change_gap": 0.5})}},
    }
    for name, w in cells.items():
        (root / f"portbench/workloads/{name}.json").write_text(
            json.dumps({"name": name, **w}))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"] += [{"name": n, "config": "tiny",
                            "traffic": n.split(".")[1], "chips": 1,
                            "why": "test"} for n in cells]
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
            m["workloads"].append(SERVE if kind == "serve" else TRAIN)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
