"""The port's segmentation training step against the JAX package on the
CPU: synthetic_tiny_seg over three steps, with dropout (its keys pinned by
capture), and with adamw, clipping, label smoothing, class weights and an
ignore label. Helpers and tolerances: `tests/test_torch_train.py`."""

import numpy as np
import jax
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.train import steps as jsteps
from gridgcn_torch.utils import jaxrng
from tests.test_torch_train import (  # noqa: F401  (pairwise_bn: fixture)
    Pair, check, make_batch, pairwise_bn, run_steps, with_model, with_train)
from tests.test_torch_train_opt import capture_dropout_keys

torch.set_num_threads(1)


def test_seg_train_steps_match_jax(pairwise_bn):
    """synthetic_tiny_seg, f32 (dense decoder): steps 1, 2 and 3."""
    cfg = jpresets.get("synthetic_tiny_seg")
    run_steps(Pair(cfg, make_batch(cfg)), 3, jax.random.PRNGKey(7))


def test_seg_dropout_keys_follow_flax(monkeypatch):
    """The segmentation head's one setup Dropout (`_dropout`) is called once
    per head layer: the h-th call's key is flax_make_rng(dropout_key,
    ("_dropout",), h + 1). Captured from the JAX model."""
    keys = capture_dropout_keys(monkeypatch, with_model(
        jpresets.get("synthetic_tiny_seg"), dropout=0.3, head=(32, 16, 8)))
    root = np.asarray(jax.random.PRNGKey(21))
    assert len(keys) == 3
    for h, k in enumerate(keys):
        np.testing.assert_array_equal(
            k, jaxrng.flax_make_rng(root, ("_dropout",), h + 1))


def test_seg_dropout_step_matches_jax(pairwise_bn):
    cfg = with_model(jpresets.get("synthetic_tiny_seg"), dropout=0.5,
                     head=(32, 16))
    run_steps(Pair(cfg, make_batch(cfg, seed=2)), 1, jax.random.PRNGKey(4))


def test_seg_loss_options_match_jax(pairwise_bn):
    """adamw + clip_by_global_norm + label smoothing + class weights (from
    both packages' class_weights_from_dataset) + ignore_label 0, 2 steps."""
    cfg = with_train(jpresets.get("synthetic_tiny_seg"), weight_decay=0.01,
                     grad_clip=0.5, label_smoothing=0.1)
    cfg = with_model(cfg, ignore_label=0)
    batch = make_batch(cfg, seed=3)
    cw = np.asarray(jsteps.class_weights_from_dataset(batch["label"], 4, 0))
    assert cw[0] == 0
    pair = Pair(cfg, batch, class_weights=cw)
    out = pair.step(jax.random.PRNGKey(8))
    assert float(out["jm"]["grad_norm"]) > 0.5
    check(pair, out)
    pair.sync()
    check(pair, pair.step(jax.random.PRNGKey(8)))
