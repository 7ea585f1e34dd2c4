"""BENCHMARK.json against the contract's shape, and every cell's files
found by name."""

import json
import re

import pytest

from harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_and_units():
    assert set(BENCH) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[part]:
            extra = {"workloads"} if part in ("end_to_end",
                                              "per_layer") else set()
            assert KEYS[part] <= set(e) <= KEYS[part] | extra, e
            assert NAME.match(e["name"]), e["name"]
    for c in BENCH["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found(name):
    cell = spec.load_cell(name)
    assert cell.workload["name"] == name
    assert cell.workload["config"] == cell.entry["config"]
    assert cell.workload["chips"] == cell.entry["chips"]
    assert cell.workload["params"]["num_points"] == \
        cell.config_file["config"]["data"]["num_points"]
    e2e = [m.name for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:            # each reads its cell's own metric
        assert m.entry["moves"] in e2e
    assert set(cell.workload["check"]["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_generator_and_reference_found(name):
    """Each cell's generator file and the reference network its
    configuration names (the default where it names none)."""
    cell = spec.load_cell(name)
    gen = spec.load_generator(cell.bench_dir, cell.workload["generator"])
    assert callable(gen)
    net = spec.reference_network(cell.config_file, cell.bench_dir)
    module, _, cls = cell.config_file.get(
        "reference_model", spec.DEFAULT_REFERENCE).partition(":")
    assert net.__name__ == cls and net.__module__ == f"reference.{module}"


def test_metric_files_match_their_entries():
    import tiny

    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"] + [
            m for m in tiny.TRAIN_METRICS if m["name"] not in named]:
        mod = spec.load_reader(spec.BENCH_DIR / "metrics" / f"{m['name']}.py")
        assert mod.UNIT == m["unit"], m["name"]
        assert mod.MOVES == m.get("moves") and mod.LAYER == m.get("layer")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_hold_their_preset(entry):
    from gridgcn_torch.configs import base, presets

    f = json.loads((spec.ROOT / entry["file"]).read_text())
    assert f["name"] == entry["name"] and f["reduced"] == entry["reduced"]
    assert f["config"] == json.loads(json.dumps(base.to_dict(
        presets.get(f["preset"]))))
