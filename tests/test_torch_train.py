"""The port's training slice (gridgcn_torch.train.steps) against the JAX
package's train step on the CPU, with the same converted weights, batch
and key: loss, accuracy, gradient norm, every gradient, the updated
parameters (through the reverse converter) and BatchNorm statistics of
the classifier; remat; the reverse converter; class weights. The helpers
here serve `test_torch_train_opt.py` (optimizer, schedules, dropout) and
`test_torch_train_seg.py` (segmentation) too.

Two effects of the reference's float32 arithmetic set how the comparison
is made, each measured on these configs:

- XLA:CPU sums a float32 mean over several axes one element after
  another; torch sums pairwise. flax's batch statistics then carry ~1e-6
  relative error in the mean, which the fast variance E[x²] − E[x]²
  amplifies: JAX's gradients differ from a float64 forward by up to 9e-4
  relative on synthetic_tiny_seg, the port's by 2e-6
  (scripts/study_train_numerics.py). The parity tests
  therefore give flax's `_compute_stats` the same formula summed pairwise
  (`pairwise_bn`), and then hold gradients to 1e-4 relative; one test
  holds the unpatched reference at its own error.
- Adam divides each gradient element by its own magnitude. An element
  whose gradient is rounding noise moves by up to a few lr in a direction
  neither package determines: every bias of a Dense layer that feeds a
  batch-statistics BatchNorm (the BatchNorm subtracts it again), the
  attention logit's bias (softmax is shift-invariant), and single
  elements whose gradient nearly cancels. Those are held to Adam's bound;
  every other element to 1e-5 of its tensor's scale. Each of the three
  steps starts from the JAX state, so that such noise does not compound.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.data.augment import augment_batch as jaugment_batch
from gridgcn_tpu.models.build import build_model as jbuild
from gridgcn_tpu.train import steps as jsteps
from gridgcn_torch.models.build import build_model, init_model
from gridgcn_torch.train import steps as tsteps
from gridgcn_torch.utils.convert import (
    convert_flax_variables, state_dict_to_flax)
from tests.test_torch_models import _random_variables, to_port

torch.set_num_threads(1)


def _pairwise_mean(x):
    """Mean over every axis but the last, summed pairwise (as torch sums)."""
    x = x.reshape(-1, x.shape[-1])
    n = x.shape[0]
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = jnp.concatenate([x, jnp.zeros_like(x[:1])], 0)
        x = x[0::2] + x[1::2]
    return x[0] / n


def _compute_stats_pairwise(x, axes, dtype, axis_name=None,
                            axis_index_groups=None, use_mean=True,
                            use_fast_variance=True, mask=None,
                            force_float32_reductions=True):
    """flax's `_compute_stats` as the models call it (f32 fast variance,
    no mask, over every axis but the last), its two means summed
    pairwise."""
    assert mask is None and axis_name is None and use_mean
    assert use_fast_variance and force_float32_reductions
    assert tuple(axes) == tuple(range(x.ndim - 1))
    x = x.astype(jnp.promote_types(dtype or x.dtype, jnp.float32))
    mu, mu2 = _pairwise_mean(x), _pairwise_mean(x * x)
    return mu, jnp.maximum(0.0, mu2 - mu * mu)


@pytest.fixture
def pairwise_bn(monkeypatch):
    import flax.linen.normalization as normalization
    monkeypatch.setattr(normalization, "_compute_stats",
                        _compute_stats_pairwise)


def with_model(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **kw))


def with_train(cfg, **kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **kw))


def make_batch(cfg, seed=0, n_masked=20):
    C = cfg.model.num_classes
    B, N = cfg.data.batch_size, cfg.data.num_points
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[:, N - n_masked:] = False
    shape = (B,) if cfg.model.task == "cls" else (B, N)
    return {"xyz": xyz, "mask": mask,
            "label": rng.integers(0, C, shape).astype(np.int32)}


class Pair:
    """The same training run in both packages: JAX state and jitted step,
    port state and step, from the same random flax variables."""

    def __init__(self, cfg, batch, spe=4, class_weights=None):
        self.cfg, self.batch = cfg, batch
        self.jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        self.model = jbuild(cfg.model)
        self.variables = _random_variables(
            self.model, jnp.asarray(batch["xyz"][:1]), None,
            jnp.asarray(batch["mask"][:1]))
        self.cw = class_weights
        self.jstate = jsteps.create_train_state(cfg, self.model,
                                                self.variables, spe)
        _, sched = jsteps.make_optimizer(cfg, spe)
        self.jstep = jsteps.make_train_step(
            cfg, self.model, sched, donate=False,
            class_weights=None if class_weights is None
            else jnp.asarray(class_weights))
        pcfg = to_port(cfg)
        self.pstate = tsteps.create_train_state(
            pcfg, build_model(pcfg.model),
            convert_flax_variables(self.variables), spe, device="cpu")
        self.pstep = tsteps.make_train_step(
            pcfg, class_weights=None if class_weights is None
            else torch.tensor(np.asarray(class_weights)))
        self.names = [n for n, _ in self.pstate.model.named_parameters()]
        self.grads = []
        update = self.pstate.tx.update
        self.pstate.tx.update = lambda g, norm: (
            self.grads.append([x.clone() for x in g]), update(g, norm))[1]

    def jax_grads(self, rng):
        """The JAX step's gradients, computed as `build_train_step` does."""
        cfg, b = self.cfg, self.jbatch
        cw = None if self.cw is None else jnp.asarray(self.cw)

        def grads(params, stats, step, rng):
            rng = jax.random.fold_in(rng, step)
            k_aug, k_cagq, k_drop = jax.random.split(rng, 3)
            xyz, mask, feat = jaugment_batch(b["xyz"], b["mask"], k_aug,
                                             cfg.data)

            def loss_fn(p):
                logits, _ = self.model.apply(
                    {"params": p, "batch_stats": stats}, xyz, feat, mask,
                    train=True, rngs={"cagq": k_cagq, "dropout": k_drop},
                    mutable=["batch_stats"])
                return jsteps._loss_and_logits(
                    cfg, logits, {**b, "mask": mask}, cw)[0]
            return jax.grad(loss_fn)(params)

        if not hasattr(self, "_grads"):
            self._grads = jax.jit(grads)
        s = self.jstate
        return self.flat(self._grads(s.params, s.batch_stats, s.step, rng))

    def flat(self, params):
        """A params-shaped JAX tree as {port name: numpy array}."""
        sd = convert_flax_variables({
            "params": jax.tree.map(np.asarray, params),
            "batch_stats": jax.tree.map(np.asarray, self.jstate.batch_stats)})
        return {n: sd[n].numpy() for n in self.names}

    def sync(self):
        """Set the port's parameters, statistics and Adam state to JAX's."""
        js = self.jstate
        sd = convert_flax_variables({
            "params": jax.tree.map(np.asarray, js.params),
            "batch_stats": jax.tree.map(np.asarray, js.batch_stats)})
        self.pstate.model.load_state_dict(sd)
        adam = next(s for s in jax.tree_util.tree_leaves(
            js.opt_state, is_leaf=lambda s: hasattr(s, "nu"))
            if hasattr(s, "nu"))
        tx = self.pstate.tx
        for mine, theirs in ((tx.mu, adam.mu), (tx.nu, adam.nu)):
            flat = self.flat(theirs)
            for t, n in zip(mine, self.names):
                t.copy_(torch.from_numpy(flat[n]))
        tx.count = int(js.step)

    def step(self, rng):
        """One step in each package; returns what `check` compares."""
        jg = self.jax_grads(rng)
        before = {n: t.detach().clone() for n, t in
                  self.pstate.model.state_dict().items()}
        self.jstate, jm = self.jstep(self.jstate, self.jbatch, rng)
        self.pstate, pm = self.pstep(self.pstate, self.batch, np.asarray(rng))
        return dict(jm=jm, pm=pm, jg=jg,
                    pg={n: g.numpy() for n, g in zip(self.names,
                                                     self.grads[-1])},
                    before=before)


def check(pair, out, rtol=1e-5, grad_rtol=1e-4):
    """Metrics, gradients, parameters and BatchNorm statistics of one step
    (see the module docstring for the two effects this allows for)."""
    jm, pm = out["jm"], out["pm"]
    for k in ("loss", "acc", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=rtol,
                                   err_msg=k)
    noise = tsteps.noise_gradient_params(pair.cfg, pair.names)
    gmax = max(np.abs(g).max() for g in out["jg"].values())
    for n in pair.names:
        a, b = out["jg"][n], out["pg"][n]
        if n in noise:
            assert max(np.abs(a).max(), np.abs(b).max()) <= 2e-4 * gmax, n
        elif np.abs(a).max() > 0:
            rel = np.linalg.norm(a - b) / np.linalg.norm(a)
            assert rel <= grad_rtol, (n, rel)
    bound = 2 * 3.2 * pair.cfg.train.lr       # twice Adam's largest step
    jv = convert_flax_variables({
        "params": jax.tree.map(np.asarray, pair.jstate.params),
        "batch_stats": jax.tree.map(np.asarray, pair.jstate.batch_stats)})
    pv = pair.pstate.model.state_dict()
    for n, want in jv.items():
        a, b = want.numpy(), pv[n].numpy()
        scale = np.abs(a).max()
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b, a, rtol=0, atol=rtol * scale,
                                       err_msg=n)
            assert not np.array_equal(b, out["before"][n].numpy()), n
            continue
        if n in noise:
            assert np.abs(a - b).max() <= bound, n
            continue
        ga, gb = out["jg"][n], out["pg"][n]
        # an element whose gradient the two packages agree on to 1e-3 has
        # a determined update; the rest are held to Adam's bound below
        det = np.abs(ga - gb) <= 1e-3 * np.abs(ga)
        np.testing.assert_allclose(b[det], a[det], rtol=0, atol=rtol * scale,
                                   err_msg=n)
        assert np.abs(a - b).max() <= bound, n


def run_steps(pair, n, rng):
    for i in range(n):
        if i:
            pair.sync()
        check(pair, pair.step(rng))


def test_cls_train_steps_match_jax(pairwise_bn):
    """synthetic_tiny, f32: steps 1, 2 and 3 (bias corrections t = 1..3,
    the schedule at counts 0..2, the step folded into the key)."""
    cfg = jpresets.get("synthetic_tiny")
    run_steps(Pair(cfg, make_batch(cfg)), 3, jax.random.PRNGKey(7))


def test_cls_unpatched_reference_within_its_own_error():
    """Against flax's own statistics (summed by XLA:CPU): loss and
    gradient norm to 1e-5, gradients to 1e-2 relative (JAX's own error
    against a float64 forward: up to 9e-4 on synthetic_tiny_seg)."""
    cfg = jpresets.get("synthetic_tiny")
    pair = Pair(cfg, make_batch(cfg, seed=1))
    check(pair, pair.step(jax.random.PRNGKey(2)), grad_rtol=1e-2)


@pytest.mark.parametrize("task", ["synthetic_tiny", "synthetic_tiny_seg"])
def test_remat_gives_the_same_gradients(task):
    """cfg.remat recomputes each GridConv stage in the backward pass: the
    same gradients, BatchNorm statistics and parameters, bit for bit."""
    base = jpresets.get(task)
    batch = make_batch(base, seed=5)
    out = []
    for remat in (False, True):
        cfg = to_port(with_model(base, remat=remat, dropout=0.2))
        model, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
        state = tsteps.create_train_state(cfg, model, sd, 4, device="cpu")
        got = []
        update = state.tx.update
        state.tx.update = lambda g, n: (got.append(g), update(g, n))[1]
        tsteps.make_train_step(cfg)(state, batch, np.asarray(
            jax.random.PRNGKey(3)))
        out.append((got[0], state.model.state_dict()))
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a, b)
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_port_loss_falls_on_a_fixed_batch():
    """synthetic_tiny trained by the port alone, 12 steps on one batch:
    the mean loss of the last 3 steps is below that of the first 3."""
    cfg = to_port(jpresets.get("synthetic_tiny"))
    model, sd = init_model(cfg.model, torch.Generator().manual_seed(1))
    state = tsteps.create_train_state(cfg, model, sd, 4, device="cpu")
    step = tsteps.make_train_step(cfg)
    batch = make_batch(cfg, seed=6, n_masked=0)
    losses = []
    for _ in range(12):
        state, m = step(state, batch, np.asarray(jax.random.PRNGKey(0)))
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"]))
    assert state.step == 12
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_reverse_converter_roundtrips():
    cfg = jpresets.get("synthetic_tiny_seg")
    batch = make_batch(cfg)
    v = _random_variables(jbuild(cfg.model), jnp.asarray(batch["xyz"][:1]),
                          None, jnp.asarray(batch["mask"][:1]))
    sd = convert_flax_variables(v)
    back = state_dict_to_flax(sd)
    flat = jax.tree_util.tree_flatten_with_path
    want, got = flat(jax.tree.map(np.asarray, v))[0], flat(back)[0]
    assert [p for p, _ in want] == [p for p, _ in got]
    for (p, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    sd2 = convert_flax_variables(back)
    assert sorted(sd2) == sorted(sd)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_class_weights_match_jax():
    labels = np.random.default_rng(0).integers(0, 6, (4, 500))
    labels[0, :300] = 2
    for ignore in (None, 0):
        want = np.asarray(jsteps.class_weights_from_dataset(labels, 6,
                                                            ignore))
        got = tsteps.class_weights_from_dataset(labels, 6, ignore)
        np.testing.assert_array_equal(want, got.numpy())


def test_create_train_state_defaults_to_cuda(monkeypatch):
    cfg = to_port(jpresets.get("synthetic_tiny"))
    model, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsteps.create_train_state(cfg, model, sd, 4)
    state = tsteps.create_train_state(cfg, model, sd, 4, device="cpu")
    assert state.step == 0 and state.device.type == "cpu"
