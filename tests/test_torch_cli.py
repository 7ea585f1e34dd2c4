"""The port's trainer and evaluator (gridgcn_torch.train.train / .evaluate)
and `api.load_predictor` against the JAX package's on the CPU.

Both trainers start from one step-0 checkpoint: the JAX package's
`init_model` draws the weights, `utils/convert.py` gives the port's
state_dict, and each package writes them with its own
`CheckpointManager`, so each `train()` restores them. One epoch of
synthetic_tiny_seg at batch 16 (4 steps, a record per step) then runs in
each, with flax's batch statistics summed pairwise (`pairwise_bn` in
`tests/test_torch_train.py`, which says why). The evaluators run on the
step-0 checkpoints, the same weights in both packages.
"""

import dataclasses
import json
import shutil

import numpy as np
import jax
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.configs.base import apply_overrides as japply
from gridgcn_tpu.models.build import init_model as jinit_model
from gridgcn_tpu.train import evaluate as jevaluate
from gridgcn_tpu.train import steps as jsteps
from gridgcn_tpu.train import train as jtrain
from gridgcn_tpu.utils.checkpoint import CheckpointManager as JManager
from gridgcn_torch import api
from gridgcn_torch.configs.base import apply_overrides
from gridgcn_torch.data.pipeline import make_dataset
from gridgcn_torch.models.build import build_model
from gridgcn_torch.train import evaluate, steps, train
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.checkpoint import CheckpointManager
from gridgcn_torch.utils.convert import convert_flax_variables
from tests.test_eval_protocols import _tiny_s3dis_cfg, _write_fake_s3dis
from tests.test_torch_models import to_port
from tests.test_torch_train import _compute_stats_pairwise

torch.set_num_threads(1)

OVERRIDES = {"data.batch_size": 16, "train.epochs": 1, "train.log_every": 1}


def save_step0(jcfg, pcfg, jdir, tdir):
    """The JAX package's init of jcfg, saved at step 0 by each package's
    CheckpointManager (with PRNGKey(seed)) → the port's state_dict."""
    model, variables = jinit_model(jcfg, seed=jcfg.train.seed)
    jstate = jsteps.create_train_state(jcfg, model, variables, 4)
    jm = JManager(str(jdir), jcfg, keep=jcfg.train.keep_ckpts)
    jm.save(0, jax.device_get(jstate),
            jax.device_get(jax.random.PRNGKey(jcfg.train.seed)))
    jm.wait()
    sd = convert_flax_variables(jax.tree.map(np.asarray, variables))
    state = steps.create_train_state(pcfg, build_model(pcfg.model), sd, 4,
                                     device="cpu")
    CheckpointManager(str(tdir), pcfg).save(
        0, state, jaxrng.PRNGKey(pcfg.train.seed))
    return sd


def records(path):
    out = []
    for line in open(path):
        rec = json.loads(line)
        rec.pop("t")
        out.append(rec)
    return out


def capture_confusions(monkeypatch, module, convert):
    """Record every confusion matrix that `module`'s train() evaluates."""
    got = []
    make = module.make_eval_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(*b):
            cm = step(*b)
            got.append(convert(cm))
            return cm
        return run

    monkeypatch.setattr(module, "make_eval_step", recording)
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers from one step-0 checkpoint (and copies of that
    checkpoint for the evaluators): logs, eval confusion matrices, the
    port's final state."""
    tmp = tmp_path_factory.mktemp("cli")
    jcfg = japply(jpresets.get("synthetic_tiny_seg"),
                  {**OVERRIDES, "train.ckpt_dir": str(tmp / "jax")})
    pcfg = apply_overrides(to_port(jcfg),
                           {"train.ckpt_dir": str(tmp / "port")})
    sd = save_step0(jcfg, pcfg, tmp / "jax", tmp / "port")
    shutil.copytree(tmp / "jax", tmp / "jax0")
    shutil.copytree(tmp / "port", tmp / "port0")
    with pytest.MonkeyPatch.context() as mp:
        import flax.linen.normalization as normalization
        mp.setattr(normalization, "_compute_stats", _compute_stats_pairwise)
        jcms = capture_confusions(mp, jtrain, np.asarray)
        tcms = capture_confusions(mp, train, lambda cm: cm.numpy())
        jstate = jtrain.train(jcfg, log_path=str(tmp / "jax.jsonl"))
        state = train.train(pcfg, log_path=str(tmp / "port.jsonl"),
                            device="cpu")
    # JAX's trained weights through the port's eval step, as train() runs it
    jsd = convert_flax_variables({
        "params": jax.tree.map(np.asarray, jstate.params),
        "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    jport = steps.create_train_state(pcfg, build_model(pcfg.model), jsd, 4,
                                     device="cpu")
    ev = steps.make_eval_step(pcfg)
    val = make_dataset(pcfg.data, "test", 4, "seg")
    jport_cm = sum(ev(jport, b, jaxrng.PRNGKey(10_000)).numpy()
                   for b in val.batches(16, seed=0, shuffle=False,
                                        drop_last=False))
    return dict(tmp=tmp, jcfg=jcfg, pcfg=pcfg, sd=sd, state=state,
                jlog=records(tmp / "jax.jsonl"),
                tlog=records(tmp / "port.jsonl"), jcms=jcms, tcms=tcms,
                jport_cm=jport_cm, jsd=jsd)


def test_train_matches_jax_from_one_checkpoint(runs):
    """The same records in the same order; the config, capacity and restore
    records equal; each step's loss at the tolerance of
    `test_torch_train.check` (1e-5 relative) and the same lr.

    Unlike `check`, the four steps run on without syncing the two states,
    so Adam's ±lr steps on rounding-noise gradients (the biases before a
    batch-statistics BatchNorm, `steps.noise_gradient_params`) add up:
    measured here, those biases differ by up to 0.0121 after 4 steps (every
    one of the 8 largest parameter differences is such a bias), the
    gradient norm by 5.7e-4 relative and the accuracy by one point of
    4096. Under running statistics the eval no longer cancels these
    biases, and 49 of 8192 eval points (0.6%) take another class. The eval
    path itself is held with JAX's trained weights in the port's eval
    step: its confusion matrix equals JAX's up to 0.1% of the points
    (measured: 0)."""
    jlog, tlog = runs["jlog"], runs["tlog"]
    kinds = ["config", "capacity", "restore"] + ["train_step"] * 4 + [
        "epoch", "eval"]
    assert [r["kind"] for r in jlog] == kinds
    assert [r["kind"] for r in tlog] == kinds
    jc, tc = (json.loads(log[0].pop("config")) for log in (jlog, tlog))
    for c in (jc, tc):
        c["train"].pop("ckpt_dir")
    assert jc == tc
    for j, t in zip(jlog, tlog):
        assert sorted(j) == sorted(t), (j, t)
        if j["kind"] in ("config", "capacity", "restore"):
            assert j == t
        elif j["kind"] in ("train_step", "epoch"):
            assert j.get("step") == t.get("step")
            assert j.get("lr") == t.get("lr")
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
            assert abs(t["acc"] - j["acc"]) <= 1e-3
            if "grad_norm" in j:
                np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                           rtol=2e-3)
        else:
            for k in ("overall_acc", "mean_class_acc", "miou"):
                assert abs(t[k] - j[k]) <= 1e-2, k
    assert len(runs["jcms"]) == len(runs["tcms"]) == 2
    jcm, tcm = sum(runs["jcms"]), sum(runs["tcms"])
    total = jcm.sum()
    assert total == tcm.sum() == runs["jport_cm"].sum() == 32 * 256
    assert np.abs(jcm - runs["jport_cm"]).sum() / 2 <= 1e-3 * total
    assert np.abs(jcm - tcm).sum() / 2 <= 1e-2 * total
    # every parameter and statistic within Adam's largest step (3.2 lr,
    # `test_torch_train.check`) in each of the 4 steps; the largest gaps
    # are the noise biases' and the running means they feed
    noise = steps.noise_gradient_params(
        runs["pcfg"], [n for n, _ in runs["state"].model.named_parameters()])
    noise |= {n.replace("_dense", "_bn")[:-len("bias")] + "running_mean"
              for n in noise}
    got = runs["state"].model.state_dict()
    gaps = {k: float((got[k] - want).abs().max())
            for k, want in runs["jsd"].items()}
    noise &= set(gaps)
    assert max(gaps.values()) <= 4 * 3.2 * runs["pcfg"].train.lr
    assert max(gaps[k] for k in noise) > 4 * max(
        g for k, g in gaps.items() if k not in noise)
    assert runs["state"].step == 4
    assert CheckpointManager(str(runs["tmp"] / "port"),
                             runs["pcfg"]).steps() == [0, 4]


def test_resumed_run_equals_uninterrupted(tmp_path):
    """Two epochs; then the newest checkpoint is deleted and train() runs
    again: it restores step 4, trains the second epoch again and ends in
    the same state, records and checkpoint bit for bit."""
    cfg = apply_overrides(to_port(jpresets.get("synthetic_tiny_seg")), {
        **OVERRIDES, "train.epochs": 2, "train.ckpt_dir": str(tmp_path / "ck"),
        "data.augment": True, "model.dropout": 0.3})
    full = train.train(cfg, log_path=str(tmp_path / "a.jsonl"), device="cpu")
    mgr = CheckpointManager(cfg.train.ckpt_dir, cfg)
    assert mgr.steps() == [4, 8]
    want = mgr.read()
    (tmp_path / "ck" / "ckpt-8.pt").unlink()
    resumed = train.train(cfg, log_path=str(tmp_path / "b.jsonl"),
                          device="cpu")
    a, b = records(tmp_path / "a.jsonl"), records(tmp_path / "b.jsonl")
    assert [r["kind"] for r in b] == ["config", "capacity", "restore"] + [
        "train_step"] * 4 + ["epoch", "eval"]
    assert b[2] == {"kind": "restore", "step": 4, "epoch": 1}
    tail = [r for r in a if r.get("epoch") == 1 or r.get("step", 0) > 4]
    assert [{k: v for k, v in r.items() if k != "points_per_sec"}
            for r in tail] == [
        {k: v for k, v in r.items() if k != "points_per_sec"} for r in b[3:]]
    assert resumed.step == full.step == 8
    got = mgr.read()
    for k, v in want["model"].items():
        assert torch.equal(v, got["model"][k]), k
    for x, y in zip(want["optimizer"]["mu"] + want["optimizer"]["nu"],
                    got["optimizer"]["mu"] + got["optimizer"]["nu"]):
        assert torch.equal(x, y)
    assert torch.equal(want["rng"], got["rng"])


def test_evaluate_matches_jax(runs, tmp_path):
    """The crop eval of one set of weights: the same metrics to 1e-3 (a
    point in a thousand); the port's --latency record, and its rotation
    voting (the voting step itself is held against JAX's in
    `tests/test_torch_metrics.py`)."""
    jdir, tdir = runs["tmp"] / "jax0", runs["tmp"] / "port0"
    j = jevaluate.evaluate(str(jdir))
    log = str(tmp_path / "e.jsonl")
    t = evaluate.evaluate(str(tdir), device="cpu", latency=True,
                          log_path=log)
    for k in ("overall_acc", "mean_class_acc", "miou"):
        np.testing.assert_allclose(float(t[k]), float(j[k]), atol=1e-3,
                                   err_msg=k)
    evaluate.evaluate(str(tdir), votes=2, device="cpu", log_path=log)
    recs = records(tmp_path / "e.jsonl")
    assert [r["kind"] for r in recs] == ["config", "eval", "latency",
                                         "config", "eval"]
    assert recs[1]["step"] == 0 and recs[2]["batch_ms"] > 0
    assert (recs[4]["votes"], recs[4]["step"]) == (2, 0)


def test_evaluate_whole_scenes_matches_jax(runs):
    jdir, tdir = runs["tmp"] / "jax0", runs["tmp"] / "port0"
    j = jevaluate.evaluate_whole_scenes(str(jdir), votes=2)
    t = evaluate.evaluate_whole_scenes(str(tdir), votes=2, device="cpu")
    for k in ("overall_acc", "mean_class_acc", "miou", "voxel_acc"):
        np.testing.assert_allclose(float(t[k]), float(j[k]), atol=1e-3,
                                   err_msg=k)


def test_evaluate_s3dis_rooms_matches_jax(tmp_path):
    _write_fake_s3dis(tmp_path)
    jcfg = _tiny_s3dis_cfg(tmp_path)
    pcfg = to_port(jcfg)
    save_step0(jcfg, pcfg, tmp_path / "jax", tmp_path / "port")
    j = jevaluate.evaluate_s3dis_rooms(str(tmp_path / "jax"), votes=2)
    log = tmp_path / "rooms.jsonl"
    t = evaluate.evaluate_s3dis_rooms(str(tmp_path / "port"), votes=2,
                                      log_path=str(log), device="cpu")
    for k in ("overall_acc", "mean_class_acc", "miou"):
        np.testing.assert_allclose(float(t[k]), float(j[k]), atol=1e-3,
                                   err_msg=k)
    rec = records(log)
    assert rec[0]["kind"] == "s3dis_room_eval" and rec[0]["rooms"] == 2


@pytest.mark.parametrize("name,summary,code", [
    ("s3dis", {"miou": 0.60}, None), ("s3dis", {"miou": 0.10}, 1),
    ("scannet", {"miou": 0.9}, 2), ("modelnet40", {"overall_acc": 0.931},
                                    None)])
def test_check_target_matches_jax(capsys, name, summary, code):
    outs = []
    for check in (jevaluate.check_target, evaluate.check_target):
        if code is None:
            check(name, summary)
        else:
            with pytest.raises(SystemExit) as e:
                check(name, summary)
            assert e.value.code == code
        outs.append(capsys.readouterr())
    assert outs[0] == outs[1]
    assert ("PASS" in outs[1].out) == (code is None)


def test_accuracy_targets_are_a_copy():
    """The port's targets are the JAX package's, value for value; the port
    adds only its own runs on the card (`measured_h100*` keys)."""
    import os

    import gridgcn_tpu.train as jtrain_pkg
    import gridgcn_torch.train as ttrain_pkg

    files = [os.path.join(os.path.dirname(p.__file__),
                          "accuracy_targets.json")
             for p in (jtrain_pkg, ttrain_pkg)]
    a, b = (json.load(open(f)) for f in files)
    b = {k: ({f: x for f, x in v.items() if not f.startswith("measured_h100")}
             if isinstance(v, dict) else v) for k, v in b.items()}
    assert a == b


@pytest.mark.parametrize("argv,match", [
    (["--spatial", "resident"], None),
    (["--preset", "synthetic_tiny_seg", "--spatial", "resident", "--mesh",
      "2", "--scene-batch", "2"], "tier-3"),
    (["--preset", "synthetic_tiny_seg", "--spatial", "resident-ml",
      "--mesh", "2", "--scene-batch", "3"], "must divide"),
    (["--spatial", "resident", "--mesh", "2"], "segmentation protocol")],
    ids=[f"argv{i}" for i in range(4)])
def test_train_cli_refuses_unported_flags(argv, match, capsys):
    """The spatial flags' misuses are refused before any worker starts, as
    the JAX package refuses them: --spatial without --mesh (exit 2),
    --scene-batch with tier 2 or a B that does not divide the mesh, a
    classification preset (their runs: `tests/test_torch_cli_spatial.py`)."""
    if match is None:
        with pytest.raises(SystemExit) as e:
            train.main(argv)
        assert e.value.code == 2
        assert "--spatial requires --mesh" in capsys.readouterr().err
    else:
        with pytest.raises(ValueError, match=match):
            train.main(argv)


@pytest.mark.parametrize("argv,match", [
    (["--resident", "--whole-scene"], "require --mesh"),
    (["--resident-ml", "--whole-scene"], "require --mesh"),
    (["--scene-batch", "2", "--whole-scene"], "requires --resident-ml")],
    ids=[f"argv{i}" for i in range(3)])
def test_evaluate_cli_refuses_unported_flags(argv, match):
    """The resident tiers' misuses are refused before any checkpoint is
    read (their runs: `tests/test_torch_cli_spatial.py`)."""
    with pytest.raises(ValueError, match=match):
        evaluate.main(["--ckpt-dir", "checkpoints", *argv])


def test_clis_default_to_cuda_and_raise_without_it(runs, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--preset", "synthetic_tiny",
                    f"train.ckpt_dir={tmp_path / 'ck'}"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(["--ckpt-dir", str(runs["tmp"] / "port0")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.load_predictor(str(runs["tmp"] / "port0"))


def test_cli_main_trains_and_evaluates_on_the_cpu(tmp_path):
    """The entry points as a user runs them: overrides, --device cpu,
    --log; then the evaluator with rotation voting."""
    ck, log = tmp_path / "ck", tmp_path / "m.jsonl"
    train.main(["--preset", "synthetic_tiny", "--device", "cpu", "--log",
                str(log), "train.epochs=1", "train.eval_every=0",
                f"train.ckpt_dir={ck}", "data.batch_size=32"])
    kinds = [r["kind"] for r in records(log)]
    assert kinds == ["config", "capacity", "epoch"]
    assert CheckpointManager.load_config(str(ck)).data.batch_size == 32
    evaluate.main(["--ckpt-dir", str(ck), "--device", "cpu", "--votes",
                   "2", "--log", str(tmp_path / "e.jsonl")])
    rec = records(tmp_path / "e.jsonl")[-1]
    assert (rec["kind"], rec["votes"], rec["step"]) == ("eval", 2, 2)


def test_load_predictor_serves_the_checkpoint(runs):
    tdir = runs["tmp"] / "port0"
    pred = api.load_predictor(str(tdir), device="cpu")
    want = api.Predictor(runs["pcfg"], runs["sd"], device="cpu")
    assert pred.step == 0
    xyz = np.random.default_rng(0).uniform(-1, 1, (2, 256, 3))
    for rng in (None, jaxrng.PRNGKey(3)):
        np.testing.assert_array_equal(pred(xyz, rng=rng),
                                      want(xyz, rng=rng))
    trained = api.load_predictor(str(runs["tmp"] / "port"), device="cpu")
    assert trained.step == 4
    again = api.load_predictor(str(runs["tmp"] / "port"), step=0,
                               device="cpu")
    np.testing.assert_array_equal(again(xyz), pred(xyz))
    with pytest.raises(FileNotFoundError):
        api.load_predictor(str(runs["tmp"] / "port"), step=3, device="cpu")


def test_auto_capacity_proposes_and_applies(tmp_path):
    """On an over-dropping layer 0 (nv=1 on surface scenes) the trainer
    logs the smallest (nv, resolution) that fits and, with 'apply', trains
    with it: the checkpoint's config carries the new nv."""
    from gridgcn_torch.configs import presets
    from gridgcn_torch.data.pipeline import make_dataset
    from gridgcn_torch.utils.debug import propose_layer0_capacity

    base = presets.get("synthetic_scene_seg")
    l0 = dataclasses.replace(base.model.layers[0], nv=1)
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, layers=(l0,) + base.model.layers[1:]))
    cfg = apply_overrides(cfg, {
        "train.epochs": 1, "train.eval_every": 0, "train.ckpt_every": 0,
        "data.synthetic_size": 8, "data.num_points": 1024,
        "train.ckpt_dir": str(tmp_path / "ck")})
    ds = make_dataset(cfg.data, "train", cfg.model.num_classes, "seg")
    prop = propose_layer0_capacity(cfg, ds.points)
    assert prop["within_budget"] and prop["nv"] > 1
    assert prop["tried"][0]["dropped_frac"] > prop["budget"]

    log = tmp_path / "auto.jsonl"
    state = train.train(cfg, log_path=str(log), auto_capacity="apply",
                        device="cpu")
    recs = records(log)
    audit = [r for r in recs if r["kind"] == "capacity"]
    proposal = [r for r in recs if r["kind"] == "capacity_proposal"]
    assert audit and audit[0]["over_budget"]
    assert proposal and proposal[0]["applied"]
    assert proposal[0]["nv"] == prop["nv"]
    assert [r["kind"] for r in recs][-1] == "epoch"
    saved = CheckpointManager.load_config(cfg.train.ckpt_dir)
    assert saved.model.layers[0].nv == prop["nv"]
    assert state.step == 2
