"""The plain reference against the port on the CPU: the served forward and
the training step on the `synthetic_tiny_seg` preset (float32; the port's
plain paths), with and without per-point features, and the served
classifier that a configuration names as a file (`synthetic_tiny`), with
the benchmark's weights."""

import dataclasses

import numpy as np
import pytest
import torch

import tiny
from harness import spec, traffic, weights
from reference.config import from_dict as ref_from_dict
from reference.serve import ServeReference
from reference.train import TrainReference

KEY = np.array([0, 77], np.uint32)
SEG = spec.reference_network({})            # the default network


def _cfgs(channels=0, **model):
    from gridgcn_torch.configs import base, presets

    cfg = presets.synthetic_tiny_seg()
    data = {"augment": True}
    if channels:
        data.update(num_feats=channels, feat_geo_channels=(0, 1, 2))
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, in_channels=channels,
                                       **model),
        data=dataclasses.replace(cfg.data, **data))
    return cfg, ref_from_dict(base.to_dict(cfg))


def _pool(seed, channels=0):
    if channels:        # the tests' generator file, with its features
        return traffic.make_pool(
            {"generator": "shapes", "pool": 4, "labels": True,
             "params": {"num_points": 256, "channels": channels}},
            seed, tiny.ADDED)
    return traffic.make_pool({"generator": "scene_surface", "pool": 4,
                              "labels": True,
                              "params": {"num_points": 256}}, seed)


@pytest.mark.parametrize("seed,channels", [(1, 0), (2**32 + 5, 0), (2, 3)])
def test_served_logits(seed, channels):
    from gridgcn_torch.api import Predictor

    port_cfg, ref_cfg = _cfgs(channels)
    sd = weights.make_state_dict(ref_cfg.model, seed, "cpu", SEG)
    pool = _pool(seed, channels)
    got = Predictor(port_cfg, sd, device="cpu")(pool.xyz, pool.feat,
                                                rng=KEY)
    want = ServeReference(ref_cfg, sd, "cpu", net=SEG)(
        pool.xyz, KEY, pool.feat).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.ptp(want))


@pytest.mark.parametrize("seed", [4, 2**31 + 3])
def test_served_classifier(seed, tmp_path):
    """The classifier file the tests add, loaded from another checkout's
    `reference/` by its configuration's name, against the port's
    `GridGCNClassifier` (float32): logits [B, C]."""
    import shutil

    from gridgcn_torch.api import Predictor
    from gridgcn_torch.configs import base, presets

    shutil.copytree(tiny.ADDED / "reference", tmp_path / "reference")
    net = spec.reference_network(
        {"reference_model": "classifier:GridGCNClassifier"}, tmp_path)
    assert net.__name__ == "GridGCNClassifier"
    port_cfg = presets.synthetic_tiny()
    ref_cfg = ref_from_dict(base.to_dict(port_cfg))
    sd = weights.make_state_dict(ref_cfg.model, seed, "cpu", net)
    pool = _pool(seed)
    got = Predictor(port_cfg, sd, device="cpu")(pool.xyz, rng=KEY)
    want = ServeReference(ref_cfg, sd, "cpu", net=net)(pool.xyz, KEY).numpy()
    assert got.shape == want.shape == (4, port_cfg.model.num_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.ptp(want))


def test_served_logits_kernel_path():
    """The port's "pallas" decoder (the kernel's plain bf16-split version
    on the CPU) against the reference's exact 3-NN: near ties aside, the
    same neighbours."""
    from gridgcn_torch.api import Predictor

    port_cfg, _ = _cfgs()
    ups = tuple(dataclasses.replace(u, method="pallas")
                for u in port_cfg.model.up_layers)
    port_cfg, ref_cfg = _cfgs(up_layers=ups)
    sd = weights.make_state_dict(ref_cfg.model, 3, "cpu", SEG)
    xyz = _pool(3).xyz
    got = Predictor(port_cfg, sd, device="cpu")(xyz, rng=KEY)
    want = ServeReference(ref_cfg, sd, "cpu", net=SEG)(xyz, KEY).numpy()
    d = np.abs(got - want)
    assert np.linalg.norm(d) / np.linalg.norm(want - want.mean()) < 1e-3


@pytest.mark.parametrize("dropout,channels", [(0.0, 0), (0.5, 0), (0.0, 3)])
def test_train_steps(dropout, channels):
    """The first step's loss and gradient as the port's; later steps
    within Adam's amplification of rounding noise: an element whose
    gradient is near nought moves by up to lr either way, so the losses
    drift by up to ~1e-3 and each state element stays within 2·lr a
    step. With features, the batches carry them and the augmentation
    rotates their three geometric columns on both sides."""
    from harness.drivers import TrainDriver

    port_cfg, ref_cfg = _cfgs(channels, dropout=dropout, ignore_label=0)
    sd = weights.make_state_dict(ref_cfg.model, 4, "cpu", SEG)
    batches = traffic.Batches(_pool(4, channels), 2, 4)
    assert ("feat" in batches.get(0)) == bool(channels)
    prog = TrainDriver(port_cfg, sd, batches, KEY, "cpu")
    ref = TrainReference(ref_cfg, sd, batches.per_epoch, "cpu", net=SEG)
    for j in range(3):
        loss = prog.call(j)
        loss_ref, grads = ref.step(batches.get(j), KEY)
        assert loss == pytest.approx(loss_ref, rel=1e-6 if j == 0 else 1e-2)
        if j == 0:
            g = prog.first_gradient_norms()
            for n, gr in zip(ref.names, grads):
                assert g[n] == pytest.approx(
                    torch.linalg.vector_norm(gr.double()).item(), rel=1e-3,
                    abs=1e-6)
    mine, theirs = prog.state_copy(), ref.state()
    for k in theirs:
        torch.testing.assert_close(mine[k], theirs[k], rtol=0,
                                   atol=2 * 3 * port_cfg.train.lr)
