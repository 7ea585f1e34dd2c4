"""A classifier and a model with per-point features, each added as files
and entries only (`tiny.py`: the configuration, the workload, the
generator `added/generators/shapes.py` and, for the classifier, the
reference network `added/reference/classifier.py`, copied into a
temporary root): a sound run on the CPU comes out correct, the fp8 control
and the altered answer do not, features that do not reach the program do
not, and `mfu.serve` is a hand count of the configuration's FLOPs over
the window's time per request. Beside them, the check's arithmetic on a
per-cloud answer [C]."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import tiny
from harness import cell, check, controls, drivers, spec, traffic

SEED = 3
# limits of the tiny added cells, from their readings at seeds 1-5 on the
# CPU (logit_rel_err / logit_max_gap): tiny_feat's program at most 0.0228
# / 0.0228 and its control at least 0.0699 / 0.0702; tiny_cls's program at
# most 0.0119 / 0.0072 and its control at least 0.1002 / 0.0784
LIMITS = {tiny.FEAT: {"logit_rel_err": 0.045, "logit_max_gap": 0.045},
          tiny.CLS: {"logit_rel_err": 0.04, "logit_max_gap": 0.03}}
ADDED = [tiny.FEAT, tiny.CLS]


def _hand_flops_feat(B):
    """tiny_feat: 2048 points, xyz + 3 channels; layer 0: 64 centers × 16
    neighbours, edge 6 + 4 → 32 → 64, context 16, attention 4 + 2 + 16
    → 16 → 1; layer 1: 16 × 8, edge 64 + 4 → 64 → 128, context 32,
    attention 4 + 2 + 32 → 16 → 1; decoder to the 64 centers 128 + 64 → 64
    → 64, to the 2048 points 64 + 6 → 64 → 64; head 64 → 64, logits → 4."""
    l0, l1 = B * 64 * 16, B * 16 * 8
    return (2 * l0 * (10 * 32 + 32 * 64) + 2 * B * 64 * 10 * 16
            + 2 * l0 * (22 * 16 + 16 * 1)
            + 2 * l1 * (68 * 64 + 64 * 128) + 2 * B * 16 * 68 * 32
            + 2 * l1 * (38 * 16 + 16 * 1)
            + 2 * B * 64 * (192 * 64 + 64 * 64)
            + 2 * B * 2048 * (70 * 64 + 64 * 64)
            + 2 * B * 2048 * (64 * 64 + 64 * 4))


def _hand_flops_cls(B):
    """tiny_cls: xyz only; layer 0: 64 centers × 16 neighbours, edge 3 + 4
    → 32 → 64, context 16, attention 22 → 16 → 1; layer 1: 16 × 16, edge
    64 + 4 → 64 → 128, context 32, attention 38 → 16 → 1; no decoder; the
    head on one pooled row a cloud, 128 → 64, logits → 4."""
    l0, l1 = B * 64 * 16, B * 16 * 16
    return (2 * l0 * (7 * 32 + 32 * 64) + 2 * B * 64 * 7 * 16
            + 2 * l0 * (22 * 16 + 16 * 1)
            + 2 * l1 * (68 * 64 + 64 * 128) + 2 * B * 16 * 68 * 32
            + 2 * l1 * (38 * 16 + 16 * 1)
            + 2 * B * (128 * 64 + 64 * 4))


HAND = {tiny.FEAT: _hand_flops_feat, tiny.CLS: _hand_flops_cls}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"), LIMITS)


def _run(root, name, seed=SEED):
    return cell.run_cell(name, seed, 0.3, False, device="cpu", root=root,
                         log=lambda m: None)


def test_added_cells_are_found(root):
    feat = spec.load_cell(tiny.FEAT, root)
    pool = traffic.make_pool(feat.workload, 1, feat.bench_dir)
    assert pool.feat.shape == (4, 2048, 3)
    cls = spec.load_cell(tiny.CLS, root)
    net = spec.reference_network(cls.config_file, cls.bench_dir)
    assert net.__name__ == "GridGCNClassifier"
    assert traffic.make_pool(cls.workload, 1, cls.bench_dir).feat is None
    assert spec.reference_network(
        feat.config_file, feat.bench_dir).__name__ == "GridGCNSegmentation"
    # nothing of the benchmark's own folder holds them
    assert not (spec.BENCH_DIR / "generators/shapes.py").exists()
    assert not (spec.BENCH_DIR / "reference/classifier.py").exists()


@pytest.mark.parametrize("name", ADDED)
def test_sound_run_is_correct(root, name):
    out = _run(root, name)
    res = out["result"]
    assert res["correct"], out["checked"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(out["checked"]) == list(LIMITS[name])
    # mfu.serve, read as in a traced run, is the hand count over the
    # window's seconds per request at the card's bf16 peak
    run = dataclasses.replace(out["run"], trace=SimpleNamespace(iters=2))
    mfu = spec.load_reader(root / "portbench/metrics/mfu.serve.py")
    c = spec.load_cell(name, root)
    per_call = run.window_s / run.calls
    assert mfu.read(run) == pytest.approx(
        100 * HAND[name](int(c.workload["batch"])) / per_call / 989e12,
        rel=1e-12)


@pytest.mark.parametrize("name", ADDED)
@pytest.mark.parametrize("fault", [controls.ControlServe,
                                   controls.AlteredServe])
def test_control_and_fault_are_not_correct(root, monkeypatch, name, fault):
    monkeypatch.setattr(cell, "ServeDriver", fault)
    out = _run(root, name)
    assert not out["result"]["correct"], out["checked"]
    if fault is controls.AlteredServe:
        # the swapped logits reach the check's widest gap: by the swapped
        # row's range over its cloud's, which depends on the cloud sampled
        gap = out["checked"]["logit_max_gap"]
        assert gap["value"] > gap["limit"]


class _NoFeatures(drivers.ServeDriver):
    """The port served with every feature zeroed: features that never
    reach the program (the check still hands the reference the traffic's
    own)."""

    def request(self, i):
        xyz, feat = super().request(i)
        return traffic.Request(xyz, np.zeros_like(feat))


def test_features_that_do_not_reach_the_program_are_not_correct(
        root, monkeypatch):
    monkeypatch.setattr(cell, "ServeDriver", _NoFeatures)
    assert not _run(root, tiny.FEAT)["result"]["correct"]


def test_per_cloud_readings_by_hand():
    ref = np.array([1.0, -1.0, 3.0, 1.0])           # mean 1, range 4
    out = ref + np.array([0.0, 0.5, 0.0, 0.0])
    r = check.logit_readings(out, ref)
    assert r["logit_rel_err"] == pytest.approx(0.5 / np.sqrt(8.0))
    assert r["logit_max_gap"] == pytest.approx(0.5 / 4.0)
    got = check.serve_readings(
        [(traffic.Request(None, None), np.stack([out, ref]))],
        lambda req: np.stack([ref, ref]))
    assert got == pytest.approx(r)


def test_altered_answer_per_cloud():
    out = np.array([[0.5, 2.0, -1.0], [3.0, 1.0, 2.0]], np.float32)
    got = controls.alter_answer(out)
    np.testing.assert_array_equal(got, [[0.5, -1.0, 2.0], [1.0, 3.0, 2.0]])
    assert out[0, 1] == 2.0                         # the input untouched
    # per point [B, N, C]: each cloud's first point alone
    per_point = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    got = controls.alter_answer(per_point)
    np.testing.assert_array_equal(got[:, 0], [[3, 1, 2, 0],
                                              [15, 13, 14, 12]])
    np.testing.assert_array_equal(got[:, 1:], per_point[:, 1:])
