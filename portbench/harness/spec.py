"""A cell's files, found by the names in `BENCHMARK.json`: the workload
`workloads/<cell>.json`, its configuration (the file that
`BENCHMARK.json` names), and a reader `metrics/<metric>.py` for each metric
the cell reports. Adding a cell, a configuration or a metric adds files and
entries; no code here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]     # the benchmark's folder
ROOT = BENCH_DIR.parent                             # the checkout


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    entry: dict                 # its BENCHMARK.json entry
    reader: object              # its module: read(run) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                 # its BENCHMARK.json entry
    workload: dict              # workloads/<name>.json
    config_name: str
    config_file: dict           # the configuration's file
    end_to_end: list
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(path: Path):
    """The metric reader module at `path` (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise ValueError(f"{path} defines no read(run)")
    return mod


def _reports(entry: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in e2e_names if "moves" in entry else True


def load_cell(name: str, root: Path | None = None) -> Cell:
    """Cell `name` of `root/BENCHMARK.json` (root: the checkout), every
    file it needs loaded; a missing file raises."""
    root = ROOT if root is None else root
    bench = load_json(root / "BENCHMARK.json")
    bench_dir = root / bench["paths"][0]
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(entries)}")
    entry = entries[name]
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    config_file = load_json(root / cfg_entry["file"])

    def metric(m: dict) -> Metric:
        reader = load_reader(bench_dir / "metrics" / f"{m['name']}.py")
        return Metric(m["name"], m["unit"], m, reader)

    e2e = [metric(m) for m in bench["end_to_end"]
           if _reports(m, name, set())]
    names = {m.name for m in e2e}
    per_layer = [metric(m) for m in bench["per_layer"]
                 if _reports(m, name, names)]
    return Cell(name=name, entry=entry, workload=workload,
                config_name=entry["config"], config_file=config_file,
                end_to_end=e2e, per_layer=per_layer)
