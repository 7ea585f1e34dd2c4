"""A cell's files, found by the names in `BENCHMARK.json` and in those
files: the workload `workloads/<cell>.json`, its configuration (the file
that `BENCHMARK.json` names), a reader `metrics/<metric>.py` for each
metric the cell reports, the traffic's generator
`generators/<workload's "generator">.py`, and the reference network that
the configuration names under `"reference_model"` (`"<module>:<Class>"`,
the module a file `reference/<module>.py`). Adding a cell, a
configuration, a metric, a generator or a reference network adds files and
entries; no code here names one but the default reference network."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]     # the benchmark's folder
ROOT = BENCH_DIR.parent                             # the checkout
# the reference network of a configuration that names none
DEFAULT_REFERENCE = "segmentation:GridGCNSegmentation"


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
    bench_dir: Path             # the benchmark's folder in its checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load(path: Path, name: str, needs: str):
    """The module in file `path`, loaded under `name`, which has to define
    the callable `needs`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, needs, None)):
        raise ValueError(f"{path} defines no {needs}")
    return mod


def _safe(stem: str) -> str:
    return stem.replace(".", "_").replace("-", "_")


def load_reader(path: Path):
    """The metric reader module at `path` (its name may hold dots)."""
    return _load(path, "portbench_metric_" + _safe(path.stem), "read")


def load_generator(bench_dir: Path, name: str):
    """`generate(seed, return_labels, params)` of the traffic generator
    `generators/<name>.py`: one cloud's (xyz [N, 3] float32, feat [N, C]
    float32 or None, labels int32 or None)."""
    path = bench_dir / "generators" / f"{name}.py"
    return _load(path, "portbench_generator_" + _safe(name),
                 "generate").generate


def reference_network(config_file: dict, bench_dir: Path = BENCH_DIR):
    """The reference network's class that the configuration names under
    `"reference_model"` (default DEFAULT_REFERENCE): `<Class>` of the file
    `reference/<module>.py` in the benchmark folder `bench_dir`. It is the
    module `reference.<module>` (a file of another checkout is loaded
    under that name, so that it imports the reference's other modules as
    its own). The class is built as `Class(model_config)` and called as
    `model(xyz, feat, mask, key)`."""
    import reference

    module, _, cls = config_file.get(
        "reference_model", DEFAULT_REFERENCE).partition(":")
    path = (bench_dir / "reference" / f"{module}.py").resolve()
    if path.parent == Path(reference.__path__[0]).resolve():
        mod = importlib.import_module(f"reference.{module}")
    else:
        mod = _load(path, f"reference.{module}", cls)
    return getattr(mod, cls)


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
                end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)
