"""The port's convergence protocol (`scripts/convergence_torch.py`): each
arm's config equals the JAX script's (`scripts/convergence.py`), captured
by patching its trainer inside the test; and opt-in gates on the card,
the counterparts of `tests/test_tpu_hw.py`'s convergence gates.

The gates are marked `cuda` and run only with GRIDGCN_TORCH_CONVERGENCE=1
on a machine with a card (minutes each; no JAX needed there):

    GRIDGCN_TORCH_CONVERGENCE=1 python -m pytest --noconftest -m cuda \\
        tests/test_torch_convergence.py
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


def _jax_config(arm: str, **kw):
    """The config the JAX script's arm trains, caught where it would start
    training (its `_train_and_read`, or `train_spatial` for the spatial
    arm); the script itself is not edited."""
    import gridgcn_tpu.train.train as jtrain

    conv = _script("convergence")
    got = []

    def capture(cfg, *a, **k):
        got.append(cfg)
        raise _Captured

    old = (conv._train_and_read, jtrain.train_spatial)
    conv._train_and_read, jtrain.train_spatial = capture, capture
    try:
        with pytest.raises(_Captured):
            getattr(conv, f"run_{arm}")(**kw)
    finally:
        conv._train_and_read, jtrain.train_spatial = old
    return got[0]


@pytest.mark.parametrize("arm,jax_kw,port", [
    ("cls", dict(epochs=30), lambda ct: ct.cls_config(30)),
    ("seg", dict(epochs=60), lambda ct: ct.seg_config(60)),
    ("seg", dict(epochs=7, extra={"model.dtype": "bfloat16"}),
     lambda ct: ct.seg_config(7, {"model.dtype": "bfloat16"})),
    ("spatial", dict(epochs=60), lambda ct: ct.spatial_config(60)),
    ("s3dis", dict(epochs=60), lambda ct: ct.s3dis_config(60)),
    ("field", dict(epochs=60, seed=1), lambda ct: ct.field_config(60, 1)),
])
def test_arm_configs_equal_jax(arm, jax_kw, port):
    """Every field of the arm's config through `to_dict`, the checkpoint
    directory aside (each script makes its own)."""
    from gridgcn_tpu.configs.base import to_dict as jto_dict

    from gridgcn_torch.configs.base import to_dict

    want = jto_dict(_jax_config(arm, **jax_kw))
    got = to_dict(port(_script("convergence_torch")))
    for d in (want, got):
        d["train"].pop("ckpt_dir")
    assert got == want


def test_script_refuses_a_missing_card():
    """--device defaults to cuda and refuses without a card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        _script("convergence_torch").main(["--run", "cls"])


# ------------------------------------------------------------ on the card --

def _gate_run(arm: str, epochs: int, tmp_path) -> dict:
    """Run one arm of the port's script on the card for `epochs` epochs
    and return its {"run": ...} record."""
    import torch

    if os.environ.get("GRIDGCN_TORCH_CONVERGENCE") != "1":
        pytest.skip("set GRIDGCN_TORCH_CONVERGENCE=1 to run on the card")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flag = "--epochs-cls" if arm == "cls" else "--epochs-seg"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "convergence_torch.py"),
         "--run", arm, flag, str(epochs), "--out-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads([line for line in out.stdout.splitlines()
                       if line.startswith('{"run"')][-1])


def _target(name: str) -> dict:
    with open(os.path.join(REPO, "gridgcn_torch", "train",
                           "accuracy_targets.json")) as f:
        return json.load(f)[name]


@pytest.mark.cuda
def test_preset_scale_convergence_cls_on_the_card(tmp_path):
    """modelnet40_full on synthetic_shapes40 for 12 epochs: the best held-out
    accuracy reaches the recorded target less its short-run allowance."""
    t = _target("modelnet40_full_shapes40")
    rec = _gate_run("cls", 12, tmp_path)
    assert rec["best"] >= t["target"] - t["short_run_allowance"], rec


@pytest.mark.cuda
def test_preset_scale_convergence_s3dis_on_the_card(tmp_path):
    """s3dis_seg (the featured input path) for 12 epochs: the final mIoU
    reaches the target less the allowance."""
    t = _target("s3dis_seg_surface")
    rec = _gate_run("s3dis", 12, tmp_path)
    assert rec["final_miou"] >= t["target"] - t["short_run_allowance"], rec


@pytest.mark.cuda
def test_preset_scale_convergence_field_on_the_card(tmp_path):
    """The sensitive gate: s3dis_seg on the feature-field task for 12
    epochs, the final overall accuracy against the target less the
    allowance."""
    t = _target("s3dis_seg_field")
    rec = _gate_run("field", 12, tmp_path)
    assert rec["final_overall_acc"] >= \
        t["target"] - t["short_run_allowance"], rec
