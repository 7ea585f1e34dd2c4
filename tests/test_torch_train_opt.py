"""The port's optimizer, schedules and dropout against the JAX package on
the CPU: the classifier's dropout step and keys, adamw with global-norm
clipping and label smoothing, the optimizer alone against optax, and the
three LR schedules. Helpers and tolerances: `tests/test_torch_train.py`."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.models.build import build_model as jbuild
from gridgcn_tpu.train import steps as jsteps
from gridgcn_torch.train import steps as tsteps
from tests.test_torch_models import _random_variables, to_port
from tests.test_torch_train import (  # noqa: F401  (pairwise_bn: fixture)
    Pair, check, make_batch, pairwise_bn, run_steps, with_model, with_train)

torch.set_num_threads(1)


def test_cls_dropout_step_matches_jax(pairwise_bn):
    """dropout 0.5 in a two-layer head: every mask from flax's key for
    Dropout_{h}, so the step matches as without dropout."""
    cfg = with_model(jpresets.get("synthetic_tiny"), dropout=0.5,
                     head=(32, 16))
    run_steps(Pair(cfg, make_batch(cfg, seed=2)), 1, jax.random.PRNGKey(4))


def test_classifier_dropout_keys_follow_flax(monkeypatch):
    """The key flax hands jax.random.bernoulli in the classifier's h-th
    compact Dropout is flax_make_rng(dropout_key, ("Dropout_{h}",), 1);
    captured from the JAX model."""
    from gridgcn_torch.utils import jaxrng
    keys = capture_dropout_keys(monkeypatch, with_model(
        jpresets.get("synthetic_tiny"), dropout=0.3, head=(32, 16, 8)))
    root = np.asarray(jax.random.PRNGKey(21))
    assert len(keys) == 3
    for h, k in enumerate(keys):
        np.testing.assert_array_equal(
            k, jaxrng.flax_make_rng(root, (f"Dropout_{h}",), 1))


def capture_dropout_keys(monkeypatch, cfg):
    """The keys flax's Dropout passes to bernoulli in one training forward
    of cfg's JAX model under dropout key PRNGKey(21), in call order."""
    import flax.linen.stochastic as stochastic

    seen = []

    class Recording:
        def __getattr__(self, name):
            return getattr(jax.random, name)

        @staticmethod
        def bernoulli(key, p, shape):
            jax.debug.callback(lambda k: seen.append(np.asarray(k)), key)
            return jax.random.bernoulli(key, p, shape)

    monkeypatch.setattr(stochastic, "random", Recording())
    batch = make_batch(cfg)
    model = jbuild(cfg.model)
    v = _random_variables(model, jnp.asarray(batch["xyz"][:1]), None,
                          jnp.asarray(batch["mask"][:1]))
    out = jax.jit(lambda v_, x, m: model.apply(
        v_, x, None, m, train=True, mutable=["batch_stats"],
        rngs={"cagq": jax.random.PRNGKey(1),
              "dropout": jax.random.PRNGKey(21)}))(
        v, jnp.asarray(batch["xyz"]), jnp.asarray(batch["mask"]))
    jax.block_until_ready(out)
    jax.effects_barrier()
    return seen


def test_adamw_clip_and_smoothing_match_jax(pairwise_bn):
    """adamw + clip_by_global_norm (the clip engaged) + label smoothing on
    the classifier, 2 steps."""
    cfg = with_train(jpresets.get("synthetic_tiny"), weight_decay=0.05,
                     grad_clip=1.0, label_smoothing=0.1)
    pair = Pair(cfg, make_batch(cfg, seed=3))
    out = pair.step(jax.random.PRNGKey(8))
    assert float(out["jm"]["grad_norm"]) > 1.0
    check(pair, out)
    pair.sync()
    check(pair, pair.step(jax.random.PRNGKey(8)))


@pytest.mark.parametrize("wd,clip,schedule", [
    (0.0, 0.0, "cosine"), (1e-2, 0.5, "cosine"), (0.0, 2.0, "step"),
    (1e-3, 0.0, "const")])
def test_optimizer_matches_optax(wd, clip, schedule):
    """The same gradients through optax and the port's Adam, 6 steps:
    parameters within 2e-7 of their scale (the schedule's cos and the
    bias corrections' powers may round an ulp apart)."""
    cfg = with_train(jpresets.get("synthetic_tiny"), weight_decay=wd,
                     grad_clip=clip, lr_schedule=schedule, epochs=2,
                     lr_decay_steps=2, lr_decay_rate=0.5)
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (300,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt, _ = jsteps.make_optimizer(cfg, 3)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tx = tsteps.make_optimizer(to_port(cfg), tp, 3)
    for i in range(6):
        grads = [(rng.standard_normal(s) * 10 ** rng.uniform(-6, 0.5))
                 .astype(np.float32) for s in shapes]
        upd, state = opt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(g) for g in grads]
        tx.update(tg, tsteps.global_norm(tg))
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=2e-7 * np.abs(a).max())
    assert tx.count == 6


@pytest.mark.parametrize("schedule", ["cosine", "step", "const"])
def test_lr_schedules_match_optax(schedule):
    cfg = with_train(jpresets.get("synthetic_tiny"), lr_schedule=schedule,
                     epochs=3, lr_decay_steps=4, lr_decay_rate=0.7)
    _, jsched = jsteps.make_optimizer(cfg, 5)
    tsched = tsteps.make_lr_schedule(to_port(cfg), 5)
    for count in (0, 1, 3, 4, 5, 8, 14, 15, 40):
        want = float(jsched(jnp.asarray(count, jnp.int32)))
        assert tsched(count).dtype == np.float32
        np.testing.assert_allclose(float(tsched(count)), want, rtol=1e-6,
                                   err_msg=str(count))
    with pytest.raises(ValueError):
        tsteps.make_lr_schedule(to_port(with_train(cfg, lr_schedule="x")), 5)
