"""The spatial trainer and evaluator CLIs on the CPU: `train --spatial
resident|resident-ml --mesh 2`, `--scene-batch 2`, and `evaluate
--whole-scene --mesh 2 --resident|--resident-ml|--scene-batch 2`, all in
one spawn of 2 gloo workers (`tests/torch_resident_worker.py::cli`).

Gates: the records in the JAX package's kinds and order; the first step's
loss, accuracy and gradient norm against JAX's `train_spatial` on its
2-device mesh from the same step-0 checkpoint at the train-step gates
(1e-5 relative); resume from the epoch's checkpoint; the scene-batched
schedule sized by its optimizer steps (4 scenes // B = 2 a epoch, where
the JAX package takes 4); `--scene-batch` evaluating a config whose
layer-1 n_centers (15) the mesh does not divide, where the JAX package's
evaluator raises building a 1-D tier-3 forward it does not use.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.configs.base import apply_overrides as japply
from gridgcn_tpu.parallel.resident_ml import make_resident_ml_forward
from gridgcn_tpu.parallel.mesh import make_mesh as jmake_mesh
from gridgcn_tpu.train import train as jtrain
from gridgcn_torch.configs.base import apply_overrides
from gridgcn_torch.parallel import mesh as pmesh
from gridgcn_torch.parallel.launch import launch
from tests import torch_resident_worker
from tests.test_torch_cli import records, save_step0
from tests.test_torch_models import to_port

torch.set_num_threads(1)

OVER = {"data.dataset": "synthetic_scene", "data.synthetic_size": 4,
        "data.num_points": 512, "train.epochs": 2, "train.log_every": 1}


def _odd(cfg):
    layers = (cfg.model.layers[0],
              dataclasses.replace(cfg.model.layers[1], n_centers=15))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, layers=layers))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_cli")
    jcfg = japply(jpresets.get("synthetic_tiny_seg"),
                  {**OVER, "train.ckpt_dir": str(tmp / "jax")})
    pcfg = apply_overrides(to_port(jcfg),
                           {"train.ckpt_dir": str(tmp / "port")})
    save_step0(jcfg, pcfg, tmp / "jax", tmp / "port")
    # the port's workers run while JAX's train_spatial runs here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(launch, torch_resident_worker.cli,
                          pmesh.mesh_devices("cpu", 2), str(tmp),
                          [f"{k}={v}" for k, v in OVER.items()], _odd(pcfg),
                          timeout_s=400)
        jtrain.train_spatial(jcfg, mesh_devices=2,
                             log_path=str(tmp / "j.jsonl"), tier="resident")
        out = job.result()
    return tmp, out


def _kinds(recs):
    return [r["kind"] for r in recs]


def test_spatial_train_records_and_first_step_match_jax(runs):
    tmp, _ = runs
    want, got = records(tmp / "j.jsonl"), records(tmp / "t2.jsonl")
    assert _kinds(got) == _kinds(want) == [
        "config", "capacity", "restore"] + (["train_step"] * 4
                                            + ["epoch"]) * 2
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b), (a["kind"], sorted(a), sorted(b))
    assert got[0]["spatial"] is True
    a, b = got[3], want[3]
    assert a["step"] == b["step"] == 1
    for k in ("loss", "acc", "grad_norm"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    assert got[-1]["ghost_overflow"] == 0


def test_spatial_train_resumes(runs):
    """Without its last checkpoint, the run restores epoch 0's (step 4),
    trains epoch 1 only, and logs epoch 1's records again as the first
    run logged them."""
    tmp, _ = runs
    got = records(tmp / "t2_resume.jsonl")
    assert _kinds(got) == ["config", "capacity", "restore"] + \
        ["train_step"] * 4 + ["epoch"]
    assert got[2]["step"] == 4 and got[2]["epoch"] == 1
    assert [r["step"] for r in got[3:7]] == [5, 6, 7, 8]
    first = records(tmp / "t2.jsonl")[-5:]
    for a, b in zip(got[3:], first):
        assert a["kind"] == b["kind"]
        for k in ("step", "loss", "acc", "grad_norm"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)


def test_scene_batched_schedule_counts_optimizer_steps(runs):
    """4 scenes in groups of 2 are 2 optimizer steps an epoch, and the
    cosine schedule spans those (the JAX package sizes it by the 4
    scenes)."""
    tmp, out = runs
    assert out["steps"] == 4
    assert out["sched"] == out["want"] != out["jax_sized"]
    got = records(tmp / "t3_sb.jsonl")
    assert _kinds(got) == ["config", "capacity"] + (
        ["train_step"] * 2 + ["epoch"]) * 2


def test_evaluate_resident_flags_run(runs):
    """`evaluate --whole-scene --mesh 2` with --resident and --resident-ml
    (exit 0 where the port exited 2): one whole_scene_eval record over
    the 8 test scenes."""
    tmp, _ = runs
    for name in ("e2", "e3"):
        (rec,) = records(tmp / f"{name}.jsonl")
        assert rec["kind"] == "whole_scene_eval" and rec["scenes"] == 8
        assert 0.0 <= rec["overall_acc"] <= 1.0


def test_scene_batch_eval_builds_no_1d_forward(runs):
    """`--scene-batch 2 --resident-ml` on a config whose layer-1
    n_centers (15) does not divide the mesh (2) but divides its rings
    (1): the port evaluates; the JAX evaluator's unused 1-D tier-3
    forward refuses that config."""
    tmp, _ = runs
    (rec,) = records(tmp / "e3_sb.jsonl")
    assert rec["kind"] == "whole_scene_eval" and rec["scene_batch"] == 2
    jcfg = _odd(jpresets.get("synthetic_tiny_seg"))
    with pytest.raises(ValueError, match="not divisible"):
        make_resident_ml_forward(jcfg, jmake_mesh(2))
