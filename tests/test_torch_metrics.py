"""The port's metrics (gridgcn_torch.train.metrics) and eval steps against
the JAX package on the CPU: confusion_matrix bit for bit (masks,
example_mask, argmax ties), summarize_confusion, voxel_confusion and
merge_block_logits, and the eval and rotation-voting steps' confusion
matrices on synthetic_tiny with the same converted weights and keys."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.models.build import build_model as jbuild
from gridgcn_tpu.train import metrics as jmetrics
from gridgcn_tpu.train import steps as jsteps
from gridgcn_torch.models.build import build_model
from gridgcn_torch.train import metrics as tmetrics
from gridgcn_torch.train import steps as tsteps
from gridgcn_torch.utils.convert import convert_flax_variables
from tests.test_torch_models import _random_variables, to_port
from tests.test_torch_train import make_batch

torch.set_num_threads(1)


def _logits(rng, shape):
    """Random logits on a coarse grid, so that argmax ties are common."""
    return (rng.integers(0, 4, shape) / 4).astype(np.float32)


@pytest.mark.parametrize("task", ["cls", "seg"])
def test_confusion_matrix_matches_jax(task):
    rng = np.random.default_rng(0)
    C = 7
    shape = (16,) if task == "cls" else (4, 300)
    logits = _logits(rng, shape + (C,))
    labels = rng.integers(0, C, shape).astype(np.int32)
    masks = [None, rng.uniform(size=shape) < 0.7]
    em = np.array([True] * 3 + [False])
    if task == "seg":
        masks.append(masks[1] & em[:, None])
    for mask in masks:
        want = np.asarray(jmetrics.confusion_matrix(
            jnp.asarray(logits), jnp.asarray(labels), C,
            None if mask is None else jnp.asarray(mask)))
        got = tmetrics.confusion_matrix(
            torch.from_numpy(logits), torch.from_numpy(labels), C,
            None if mask is None else torch.from_numpy(mask))
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(want, got.numpy())
        n = labels.size if mask is None else mask.sum()
        assert got.sum() == n


def test_summarize_confusion_matches_jax():
    rng = np.random.default_rng(1)
    for cm in (rng.integers(0, 50, (6, 6)), np.diag([5, 0, 3, 0]),
               np.zeros((3, 3), int)):
        cm = cm.astype(np.int32)
        want = jmetrics.summarize_confusion(jnp.asarray(cm))
        got = tmetrics.summarize_confusion(torch.from_numpy(cm))
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=0, err_msg=k)


def test_voxel_confusion_and_block_merging_match_jax():
    rng = np.random.default_rng(2)
    xyz = rng.uniform(0, 3, (2, 500, 3)).astype(np.float32)
    logits = rng.standard_normal((2, 500, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 500))
    mask = rng.uniform(size=(2, 500)) < 0.8
    for vs in (0.2, 0.5):
        np.testing.assert_array_equal(
            jmetrics.voxel_confusion(xyz, logits, labels, mask, vs, 5),
            tmetrics.voxel_confusion(xyz, logits, labels, mask, vs, 5))
    empty = np.zeros_like(mask)
    assert tmetrics.voxel_confusion(xyz, logits, labels, empty, 0.2,
                                    5).sum() == 0
    pos = np.round(rng.uniform(0, 1, (3, 200, 3)), 2).astype(np.float32)
    for want, got in zip(jmetrics.merge_block_logits(pos, logits[:1].repeat(
            3, 0)[:, :200], mask[:1].repeat(3, 0)[:, :200], 1e-2),
            tmetrics.merge_block_logits(pos, logits[:1].repeat(3, 0)[
                :, :200], mask[:1].repeat(3, 0)[:, :200], 1e-2)):
        np.testing.assert_array_equal(want, got)


@pytest.fixture(scope="module")
def tiny():
    """synthetic_tiny in both packages from the same variables, and a batch
    whose last cloud pads a partial batch."""
    cfg = jpresets.get("synthetic_tiny")
    batch = make_batch(cfg, seed=4)
    batch["example_mask"] = np.arange(cfg.data.batch_size) < 6
    model = jbuild(cfg.model)
    v = _random_variables(model, jnp.asarray(batch["xyz"][:1]), None,
                          jnp.asarray(batch["mask"][:1]))
    jstate = jsteps.create_train_state(cfg, model, v, 1)
    pcfg = to_port(cfg)
    pstate = tsteps.create_train_state(pcfg, build_model(pcfg.model),
                                       convert_flax_variables(v), 1,
                                       device="cpu")
    return cfg, model, batch, jstate, pstate


def test_eval_step_matches_jax(tiny):
    cfg, model, batch, jstate, pstate = tiny
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jsteps.make_eval_step(cfg, model)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng))
    got = tsteps.make_eval_step(to_port(cfg))(pstate, batch, np.asarray(rng))
    np.testing.assert_array_equal(want, got.numpy())
    assert got.sum() == 6


@pytest.mark.parametrize("votes", [1, 3])
def test_voting_eval_step_matches_jax(tiny, votes):
    """The rotations' cos/sin may round an ulp apart from XLA:CPU's; on
    this batch no vote-averaged argmax moves, so the matrices are equal."""
    cfg, model, batch, jstate, pstate = tiny
    rng = jax.random.PRNGKey(6)
    want = np.asarray(jsteps.make_voting_eval_step(cfg, model, votes)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng))
    got = tsteps.make_voting_eval_step(to_port(cfg), votes)(
        pstate, batch, np.asarray(rng))
    np.testing.assert_array_equal(want, got.numpy())


def test_confusion_mask_matches_jax():
    rng = np.random.default_rng(5)
    batch = {"mask": rng.uniform(size=(4, 30)) < 0.8,
             "label": rng.integers(0, 4, (4, 30)),
             "example_mask": np.array([True, True, False, True])}
    for name, ignore in (("synthetic_tiny_seg", None),
                         ("synthetic_tiny_seg", 0), ("synthetic_tiny", None)):
        cfg = jpresets.get(name)
        cfg = cfg.__class__(**{**cfg.__dict__, "model": cfg.model.__class__(
            **{**cfg.model.__dict__, "ignore_label": ignore})})
        want = jsteps._confusion_mask(cfg, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        got = tsteps._confusion_mask(to_port(cfg), {
            k: torch.as_tensor(v) for k, v in batch.items()})
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
