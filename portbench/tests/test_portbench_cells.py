"""Whole runs on the CPU at a tiny size (the harness's look for a card
skipped): a cell added as files only is picked up, a sound run comes out
correct, and the control and every fault a cell can have come out not
correct. The command itself refuses to run without a card, or in a
directory that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import tiny
from harness import cell, controls, spec

SEED = 3
# limits of the tiny cells (bf16 like scannet_seg, at 2048 points), from
# their readings at seeds 1-4 on the CPU: serving, the program's at most
# 0.023 / 0.023 and the control's at least 0.12 / 0.15 (logit_rel_err /
# logit_max_gap); training, the program's grad_gap_median at most 0.0099
# and change_gap at most 0.077, the control's grad_gap_median at least
# 0.016. At this size the control separates by 1.6x at the least; the
# cells' own limits come from readings at their full size on the card.
LIMITS = {tiny.SERVE: {"logit_rel_err": 0.06, "logit_max_gap": 0.1},
          tiny.TRAIN: {"grad_gap_median": 0.025, "change_gap": 0.5}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"), LIMITS)


def _run(root, name, seed=SEED):
    return cell.run_cell(name, seed, 0.3, False, device="cpu", root=root,
                         log=lambda m: None)


def test_added_cell_is_found(root):
    c = spec.load_cell(tiny.SERVE, root)
    assert c.config_name == "tiny" and c.workload["batch"] == 2
    assert {m.name for m in c.end_to_end} == {
        "serve_points_per_s", "serve_latency_p95_ms", "setup_s"}
    assert "launches_per_request.serve" in {m.name for m in c.per_layer}
    t = spec.load_cell(tiny.TRAIN, root)
    assert {m.name for m in t.end_to_end} == {"train_points_per_s",
                                              "setup_s"}


@pytest.mark.parametrize("name", [tiny.SERVE, tiny.TRAIN])
def test_sound_run_is_correct(root, name):
    out = _run(root, name)
    res = out["result"]
    assert res["correct"], out["checked"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m.name for m in
                                   spec.load_cell(name, root).end_to_end}
    assert list(out["checked"]) == list(LIMITS[name])


@pytest.mark.parametrize("seed", [1, 3])
def test_control_is_not_correct(root, monkeypatch, seed):
    monkeypatch.setattr(cell, "ServeDriver", controls.ControlServe)
    monkeypatch.setattr(cell, "TrainDriver", controls.ControlTrain)
    for name in (tiny.SERVE, tiny.TRAIN):
        assert not _run(root, name, seed)["result"]["correct"], name


def test_altered_answer_is_not_correct(root, monkeypatch):
    monkeypatch.setattr(cell, "ServeDriver", controls.AlteredServe)
    out = _run(root, tiny.SERVE)
    assert not out["result"]["correct"]
    assert out["checked"]["logit_max_gap"]["value"] > 0.5


def test_unchanged_state_is_not_correct(root, monkeypatch):
    from gridgcn_torch.train import steps

    monkeypatch.setattr(steps.Adam, "update", lambda self, g, n: None)
    out = _run(root, tiny.TRAIN)
    assert not out["result"]["correct"]
    # every parameter unmoved reads 1; BatchNorm statistics that still
    # moved from the unmoved parameters may read more
    assert out["checked"]["change_gap"]["value"] >= 1.0


def test_half_batch_is_not_correct(root, monkeypatch):
    monkeypatch.setattr(cell, "TrainDriver", controls.half_batch_train)
    assert not _run(root, tiny.TRAIN)["result"]["correct"]


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "scannet_whole_scene.b4", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _command(spec.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_command_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _command(tmp_path, env)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on the card: correct, and its
    result line the contract's."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "scannet_whole_scene.b4", "--seed", "5", "--seconds", "3",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_readings_script(root, monkeypatch, capsys):
    """portbench/readings.py on the tiny cells, each side a run of the
    harness's own: the program correct, the control and the fault not,
    and the control's numbers above the program's above float32's."""
    import readings

    monkeypatch.setattr(spec, "ROOT", root)
    for name in (tiny.SERVE, tiny.TRAIN):
        assert readings.main(["--workload", name, "--seeds", str(SEED),
                              "--seconds", "0.3", "--device", "cpu",
                              "--sides", *readings.SIDES]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    got = {(r["workload"], r["side"]): r for r in rows}
    assert len(got) == 8
    assert cell.ServeDriver.__name__ == "ServeDriver"    # restored
    for name, key in ((tiny.SERVE, "logit_rel_err"),
                      (tiny.TRAIN, "grad_gap_median")):
        assert got[name, "program"]["correct"]
        assert not got[name, "control"]["correct"]
        assert not got[name, "fault"]["correct"]
        r = {side: got[name, side]["readings"][key]
             for side in ("control", "program", "program32")}
        assert r["control"] > r["program"] > r["program32"]
        assert list(got[name, "program"]["checked"]) == list(LIMITS[name])
