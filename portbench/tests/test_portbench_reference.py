"""The plain reference against the port on the CPU: the served forward and
the training step on the `synthetic_tiny_seg` preset (float32; the port's
plain paths), with the benchmark's weights."""

import dataclasses

import numpy as np
import pytest
import torch

from harness import traffic, weights
from reference.config import from_dict as ref_from_dict
from reference.serve import ServeReference
from reference.train import TrainReference

KEY = np.array([0, 77], np.uint32)


def _cfgs(**model):
    from gridgcn_torch.configs import base, presets

    cfg = presets.synthetic_tiny_seg()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        data=dataclasses.replace(cfg.data, augment=True))
    return cfg, ref_from_dict(base.to_dict(cfg))


def _pool(seed):
    return traffic.make_pool({"generator": "scene_surface", "pool": 4,
                              "labels": True,
                              "params": {"num_points": 256}}, seed)


@pytest.mark.parametrize("seed", [1, 2**32 + 5])
def test_served_logits(seed):
    from gridgcn_torch.api import Predictor

    port_cfg, ref_cfg = _cfgs()
    sd = weights.make_state_dict(ref_cfg.model, seed, "cpu")
    xyz, _ = _pool(seed)
    got = Predictor(port_cfg, sd, device="cpu")(xyz, rng=KEY)
    want = ServeReference(ref_cfg, sd, "cpu")(xyz, KEY).numpy()
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
    sd = weights.make_state_dict(ref_cfg.model, 3, "cpu")
    xyz, _ = _pool(3)
    got = Predictor(port_cfg, sd, device="cpu")(xyz, rng=KEY)
    want = ServeReference(ref_cfg, sd, "cpu")(xyz, KEY).numpy()
    d = np.abs(got - want)
    assert np.linalg.norm(d) / np.linalg.norm(want - want.mean()) < 1e-3


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_train_steps(dropout):
    """The first step's loss and gradient as the port's; later steps
    within Adam's amplification of rounding noise: an element whose
    gradient is near nought moves by up to lr either way, so the losses
    drift by up to ~1e-3 and each state element stays within 2·lr a
    step."""
    from harness.drivers import TrainDriver

    port_cfg, ref_cfg = _cfgs(dropout=dropout, ignore_label=0)
    sd = weights.make_state_dict(ref_cfg.model, 4, "cpu")
    xyz, labels = _pool(4)
    batches = traffic.Batches(xyz, labels, 2, 4)
    prog = TrainDriver(port_cfg, sd, batches, KEY, "cpu")
    ref = TrainReference(ref_cfg, sd, batches.per_epoch, "cpu")
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
