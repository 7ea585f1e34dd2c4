"""The trainer's and evaluator's `--mesh N` on the CPU: N gloo workers
started by `parallel.launch` (world 2 here), against the port's
single-device runs and the JAX package's tier-1 whole-scene eval.

Tolerances: the data-parallel trainer against the single-device trainer
on the same global batches at the multi-step gates of
`tests/test_torch_cli.py` (loss 1e-5 relative, accuracy 1e-3, gradient
norm 2e-3 relative, eval metrics 1e-2, every parameter within Adam's
largest step per step): the two sum the batch in another order, and
Adam's ±lr steps on rounding-noise gradients add up over the 4 steps.
The data-parallel crop eval against the single-device eval exactly (an
integer confusion matrix summed over the ranks). The tier-1 whole-scene
eval against JAX's tier 1 on its 2-device mesh at 1e-3 (the whole-scene
gate of `tests/test_torch_cli.py`).
"""

import numpy as np
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.configs.base import apply_overrides as japply
from gridgcn_tpu.train import evaluate as jevaluate
from gridgcn_torch.configs.base import apply_overrides
from gridgcn_torch.train import evaluate, train
from gridgcn_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_cli import OVERRIDES, records, save_step0
from tests.test_torch_models import to_port

torch.set_num_threads(1)

TRAIN = {**OVERRIDES, "data.augment": True, "model.dropout": 0.3}


@pytest.fixture(scope="module")
def step0(tmp_path_factory):
    """One step-0 checkpoint of JAX's init in each package."""
    tmp = tmp_path_factory.mktemp("mesh_cli")
    jcfg = japply(jpresets.get("synthetic_tiny_seg"),
                  {**OVERRIDES, "train.ckpt_dir": str(tmp / "jax")})
    pcfg = apply_overrides(to_port(jcfg),
                           {"train.ckpt_dir": str(tmp / "port")})
    save_step0(jcfg, pcfg, tmp / "jax", tmp / "port")
    return tmp


def test_train_mesh_2_matches_single_device_train(tmp_path):
    """`train --mesh 2 --device cpu` (augmentation and dropout on) against
    the port's single-device `train()` from the same init and batches:
    the same records, rank 0's checkpoint within Adam's bound."""
    over = [f"{k}={v}" for k, v in TRAIN.items()]
    single = apply_overrides(to_port(jpresets.get("synthetic_tiny_seg")),
                             {**TRAIN, "train.ckpt_dir":
                              str(tmp_path / "one")})
    state = train.train(single, log_path=str(tmp_path / "one.jsonl"),
                        device="cpu")
    train.main(["--preset", "synthetic_tiny_seg", "--device", "cpu",
                "--mesh", "2", "--log", str(tmp_path / "two.jsonl"),
                *over, f"train.ckpt_dir={tmp_path / 'two'}"])
    one, two = records(tmp_path / "one.jsonl"), records(tmp_path / "two.jsonl")
    kinds = ["config", "capacity"] + ["train_step"] * 4 + ["epoch", "eval"]
    assert [r["kind"] for r in one] == [r["kind"] for r in two] == kinds
    for a, b in zip(one[1:], two[1:]):
        assert sorted(a) == sorted(b)
        if a["kind"] == "capacity":
            assert a == b
        elif a["kind"] in ("train_step", "epoch"):
            assert a.get("step") == b.get("step")
            assert a.get("lr") == b.get("lr")
            np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
            assert abs(b["acc"] - a["acc"]) <= 1e-3
            if "grad_norm" in a:
                np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                           rtol=2e-3)
        else:
            for k in ("overall_acc", "mean_class_acc", "miou"):
                assert abs(b[k] - a[k]) <= 1e-2, k
    two = str(tmp_path / "two")
    ckpt = CheckpointManager(two, CheckpointManager.load_config(two))
    assert ckpt.steps() == [4]
    got = ckpt.read()["model"]
    want = state.model.state_dict()
    bound = 4 * 3.2 * single.train.lr
    assert max(float((got[k] - v).abs().max()) for k, v in want.items()) \
        <= bound


def test_evaluate_mesh_2_is_the_single_device_eval(step0, tmp_path):
    """The data-parallel crop eval (through the CLI, rank 0's log) gives
    the single-device eval's metrics exactly."""
    port = str(step0 / "port")
    want = evaluate.evaluate(port, device="cpu")
    log = tmp_path / "e.jsonl"
    evaluate.main(["--ckpt-dir", port, "--device", "cpu", "--mesh", "2",
                   "--log", str(log)])
    recs = records(log)
    assert [r["kind"] for r in recs] == ["config", "eval"]
    for k in ("overall_acc", "mean_class_acc", "miou"):
        assert recs[1][k] == float(want[k]), k


def test_evaluate_whole_scene_mesh_2_matches_jax_tier1(step0, tmp_path):
    """`evaluate --whole-scene --mesh 2`: tier 1, one slab per rank, the
    vote-invariant halo and capacity, against JAX's tier 1."""
    j = jevaluate.evaluate_whole_scenes(str(step0 / "jax"), votes=1,
                                        mesh_devices=2)
    log = tmp_path / "w.jsonl"
    evaluate.main(["--ckpt-dir", str(step0 / "port"), "--device", "cpu",
                   "--mesh", "2", "--whole-scene", "--votes", "1",
                   "--log", str(log)])
    rec = records(log)
    assert [r["kind"] for r in rec] == ["whole_scene_eval"]
    assert rec[0]["scenes"] > 1
    for k in ("overall_acc", "mean_class_acc", "miou", "voxel_acc"):
        np.testing.assert_allclose(rec[0][k], float(j[k]), atol=1e-3,
                                   err_msg=k)
