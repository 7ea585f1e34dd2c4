"""The port's utilities against the JAX package's on the CPU: the JSONL
metric logger (the same lines apart from `t`), the checkpoint manager
(roundtrip into a fresh state, keep-last-k, the config binding, None on an
empty directory), the layer-0 capacity audit and proposal (the same dicts
on the same points), `check_capacity`, the NaN guards and the profiling
helpers. Mirrors `tests/test_train.py` and `tests/test_utils.py`."""

import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.utils import debug as jdebug
from gridgcn_tpu.utils.logging import MetricLogger as JMetricLogger
from gridgcn_torch.configs import presets
from gridgcn_torch.configs.base import apply_overrides
from gridgcn_torch.data.pipeline import make_dataset
from gridgcn_torch.models.build import init_model
from gridgcn_torch.ops.voxelize import build_voxel_table
from gridgcn_torch.train import steps
from gridgcn_torch.utils import debug, jaxrng, profiling
from gridgcn_torch.utils.checkpoint import CheckpointManager
from gridgcn_torch.utils.logging import MetricLogger

torch.set_num_threads(1)


def records(logger_cls, **metrics):
    buf = io.StringIO()
    log = logger_cls(stream=buf)
    log.log("train_step", **metrics)
    log.close()
    rec = json.loads(buf.getvalue())
    assert rec.pop("t") >= 0
    return rec


def test_metric_logger_lines_equal_jax(tmp_path):
    common = dict(step=3, loss=0.5, name="x", flags=[True, False],
                  vec=np.array([1, 2]), one=np.float32(0.25),
                  arr=np.array([1.25]))
    want = records(JMetricLogger, **common, dev=jnp.asarray(2.5),
                   dvec=jnp.asarray([1.0, 3.0]))
    got = records(MetricLogger, **common, dev=torch.tensor(2.5),
                  dvec=torch.tensor([1.0, 3.0]))
    assert got == want
    assert got["arr"] == 1.25 and got["vec"] == [1, 2]
    path = tmp_path / "m.jsonl"
    log = MetricLogger(str(path), stream=io.StringIO())
    log.log("epoch", epoch=0, acc=torch.tensor(0.5))
    log.log("eval", epoch=0, miou=0.25)
    log.close()
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert [(l["kind"], l["epoch"]) for l in lines] == [("epoch", 0),
                                                         ("eval", 0)]


def test_metric_logger_tensorboard(tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    tb = tmp_path / "tb"
    log = MetricLogger(stream=io.StringIO(), tensorboard_dir=str(tb))
    log.log("train_step", step=3, loss=0.5, note="skipped-non-numeric")
    log.log("epoch", epoch=1, acc=0.75)
    log.close()
    acc = EventAccumulator(str(tb))
    acc.Reload()
    tags = acc.Tags()["scalars"]
    assert "train_step/loss" in tags and "epoch/acc" in tags
    assert not any(t.endswith("note") for t in tags)
    ev = acc.Scalars("train_step/loss")[0]
    assert (ev.step, ev.value) == (3, 0.5)


def _state(cfg, seed):
    model, sd = init_model(cfg.model, torch.Generator().manual_seed(seed))
    return steps.create_train_state(cfg, model, sd, 8, device="cpu")


def _equal_states(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for x, y in zip(a.tx.mu + a.tx.nu, b.tx.mu + b.tx.nu):
        assert torch.equal(x, y)
    assert a.step == b.step


def test_checkpoint_roundtrip_and_keep_last(tmp_path):
    """A trained state saved at each of 4 steps with keep=2: the newest two
    remain; restoring into a fresh state (another init) gives the saved
    parameters, BatchNorm statistics, Adam moments, step and key bit for
    bit, and the same eval; the config roundtrips through the directory."""
    cfg = apply_overrides(presets.get("synthetic_tiny_seg"),
                          {"train.ckpt_dir": str(tmp_path / "ck")})
    ds = make_dataset(cfg.data, "train", cfg.model.num_classes, "seg")
    state = _state(cfg, 0)
    step = steps.make_train_step(cfg)
    rng = jaxrng.PRNGKey(3)
    mgr = CheckpointManager(cfg.train.ckpt_dir, cfg, keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore(_state(cfg, 1)) is None
    batches = ds.batches(cfg.data.batch_size, seed=0)
    for _ in range(4):
        state, _ = step(state, next(batches), rng)
        mgr.save(state.step, state, rng)
    mgr.wait()
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4

    fresh = _state(cfg, 123)
    out = mgr.restore(fresh, jaxrng.PRNGKey(0))
    assert out["state"] is fresh
    _equal_states(fresh, state)
    np.testing.assert_array_equal(out["rng"], rng)
    assert out["rng"].dtype == np.uint32
    older = mgr.restore(_state(cfg, 5), step=3)["state"]
    assert older.step == 3
    ev = steps.make_eval_step(cfg)
    batch = next(ds.batches(cfg.data.batch_size, seed=1))
    assert torch.equal(ev(state, batch, rng), ev(fresh, batch, rng))
    assert CheckpointManager.load_config(cfg.train.ckpt_dir) == cfg
    assert not list((tmp_path / "ck").glob("*.tmp"))


def test_checkpoint_dir_rejects_config_change(tmp_path):
    cfg = presets.get("synthetic_tiny")
    CheckpointManager(str(tmp_path), cfg, keep=1)
    CheckpointManager(str(tmp_path), cfg, keep=1)
    changed = apply_overrides(cfg, {"train.lr": cfg.train.lr * 2})
    with pytest.raises(ValueError, match="different config"):
        CheckpointManager(str(tmp_path), changed, keep=1)


def test_checkpoint_dir_survives_additive_schema_change(tmp_path):
    cfg = presets.get("synthetic_tiny")
    CheckpointManager(str(tmp_path), cfg, keep=1)
    cfg_path = tmp_path / "config.json"
    d = json.loads(cfg_path.read_text())
    assert d["model"].pop("eval_dtype") == ""
    cfg_path.write_text(json.dumps(d))
    CheckpointManager(str(tmp_path), cfg, keep=1)
    d["train"]["lr"] = cfg.train.lr * 2
    cfg_path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match="different config"):
        CheckpointManager(str(tmp_path), cfg, keep=1)


def _skewed_points():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 0.05, (2, 256, 3)).astype(np.float32)
    pts[:, 0] = [1.0, 1.0, 1.0]
    return pts, rng.uniform(0, 1, (2, 256, 3)).astype(np.float32)


def test_capacity_audit_and_proposal_equal_jax():
    """The same dicts as the JAX package's on an over-dropping cloud set
    (all points in one corner: the proposal doubles nv to 64, then the
    resolution), a healthy one, and surface-scene crops under
    synthetic_scene_seg's layer 0."""
    skewed, uniform = _skewed_points()
    scene_cfg = presets.get("synthetic_scene_seg")
    scenes = make_dataset(scene_cfg.data, "train", 4, "seg").points[:2, :256]
    for name, pts, budget in (("synthetic_tiny", skewed, 0.05),
                              ("synthetic_tiny", uniform, 0.05),
                              ("synthetic_tiny", uniform, 0.0),
                              ("synthetic_scene_seg", scenes, 0.0)):
        cfg, jcfg = presets.get(name), jpresets.get(name)
        got = debug.audit_layer0_capacity(cfg, pts, budget=budget)
        assert got == jdebug.audit_layer0_capacity(jcfg, pts, budget=budget)
        got = debug.propose_layer0_capacity(cfg, pts, budget=budget)
        assert got == jdebug.propose_layer0_capacity(jcfg, pts,
                                                     budget=budget)
    report = debug.audit_layer0_capacity(presets.get("synthetic_tiny"),
                                         skewed)
    assert report["over_budget"] and report["dropped_frac"] > 0.5
    prop = debug.propose_layer0_capacity(presets.get("synthetic_tiny"),
                                         skewed)
    assert [t["nv"] for t in prop["tried"]] == [8, 16, 32, 64, 8]
    assert prop["resolution"] == 16


def test_check_capacity_flags_overflow():
    xyz = torch.rand((1, 500, 3), generator=torch.Generator().manual_seed(0))
    mask = torch.ones((1, 500), dtype=torch.bool)
    key = jaxrng.PRNGKey(42)
    stats = debug.check_capacity(build_voxel_table(xyz, mask, 8, 500, key))
    assert int(stats["dropped_points"].sum()) == 0
    tight = build_voxel_table(xyz, mask, 2, 2, key)
    with pytest.raises(ValueError, match="drops"):
        debug.check_capacity(tight, max_dropped_frac=0.05)


def test_nan_guards():
    assert torch.equal(debug.checkify_call(torch.sqrt, torch.tensor(4.0)),
                       torch.tensor(2.0))
    with pytest.raises(ValueError, match="not finite"):
        debug.checkify_call(torch.log, torch.tensor([1.0, -1.0]))
    with pytest.raises(ValueError, match="not finite"):
        debug.checkify_call(lambda x: {"a": x, "b": x / 0}, torch.ones(2))
    assert not torch.is_anomaly_enabled()
    x = torch.tensor(-1.0, requires_grad=True)
    with debug.debug_mode():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).backward()
    assert not torch.is_anomaly_enabled()


def test_profiling_helpers_on_the_cpu(tmp_path):
    a = torch.rand(64, 64)
    dt = profiling.steady_state_time(torch.mm, a, a, warmup=1, iters=3,
                                     device="cpu")
    assert 0 < dt < 10
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("matmul"):
            torch.mm(a, a)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "gridgcn/matmul"
               for e in trace["traceEvents"])
    # no device events on the CPU
    assert profiling.busy_ms_per_iter(str(tmp_path), 1) is None
    assert jax.devices()[0].platform == "cpu"
