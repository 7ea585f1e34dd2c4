"""The float32 effects that set the training slice's parity tolerances,
measured on the CPU: where torch's own functions and XLA:CPU's round
differently, and how exact the two packages' batch-statistics gradients
are against a float64 forward. Each test prints what it measured:

    JAX_PLATFORMS=cpu python -m pytest -s tests/test_torch_train_numerics.py
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.models.build import build_model as jbuild
from gridgcn_torch.models.build import build_model
from gridgcn_torch.train import steps as tsteps
from gridgcn_torch.utils import jaxrng, xla_math
from gridgcn_torch.utils.convert import convert_flax_variables
from tests.test_torch_models import _random_variables, to_port
from tests.test_torch_train import _compute_stats_pairwise, make_batch

torch.set_num_threads(1)


def test_torch_builtins_round_otherwise_than_xla_cpu():
    """torch's float32 sqrt on the CPU is not correctly rounded, and
    sqrt(2)·torch.special.erfinv is not jax.random.normal: the port's
    xla_math.sqrt and jaxrng.normal differ in no value."""
    rng = np.random.default_rng(0)
    w = rng.uniform(5, 40, 1_000_000).astype(np.float32)
    exact = np.sqrt(w.astype(np.float64)).astype(np.float32)
    torch_sqrt = int((torch.sqrt(torch.from_numpy(w)).numpy() != exact).sum())
    port_sqrt = int((xla_math.sqrt(torch.from_numpy(w)).numpy()
                     != exact).sum())

    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.normal(key, (1_000_000,)))
    u = jaxrng.uniform(np.asarray(key), (1_000_000,), minval=float(
        np.nextafter(np.float32(-1), np.float32(0))))
    naive = (float(np.float32(np.sqrt(2))) * torch.special.erfinv(u)).numpy()
    port = jaxrng.normal(np.asarray(key), (1_000_000,)).numpy()
    print(f"\nfloat32 roots in [5, 40) not correctly rounded, of 10^6: "
          f"torch.sqrt {torch_sqrt}, xla_math.sqrt {port_sqrt}; draws that "
          f"differ from jax.random.normal: sqrt(2)·torch.special.erfinv "
          f"{float((naive != want).mean()):.4f} (up to "
          f"{float(np.abs(naive - want).max()):.3g}), jaxrng.normal "
          f"{int((port != want).sum())}")
    assert port_sqrt == 0 and int((port != want).sum()) == 0


def test_xla_cpu_mean_is_less_exact_than_a_pairwise_sum():
    """XLA:CPU sums a float32 mean over several axes one element after
    another, torch pairwise: flax's batch statistics carry the larger
    error, which the fast variance E[x²] − E[x]² amplifies."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 64, 16, 32)) * 0.5 + 3).astype(np.float32)
    ref = x.astype(np.float64).mean((0, 1, 2))
    xla = np.asarray(jax.jit(lambda a: a.mean((0, 1, 2)))(x))
    pair = torch.from_numpy(x).mean((0, 1, 2)).numpy()
    err = {k: float(np.abs(v - ref).max() / ref.max())
           for k, v in (("XLA:CPU", xla), ("torch", pair))}
    print(f"\nfloat32 mean over 3 of 4 axes, relative error against "
          f"float64: {err}")
    assert err["torch"] < err["XLA:CPU"]


def _gradients_against_float64(monkeypatch):
    """One training forward/backward of synthetic_tiny_seg (random
    weights, batch-statistics BatchNorm, a fixed random cotangent): the
    largest per-tensor gradient error, relative L2 against the port in
    float64 (two-pass BatchNorm variance), of JAX in float32, of JAX with
    flax's statistics summed pairwise, and of the port in float32."""
    import flax.linen.normalization as normalization

    import gridgcn_torch.models.layers as layers

    cfg = jpresets.get("synthetic_tiny_seg")
    b = make_batch(cfg)
    xyz, mask = b["xyz"], b["mask"]
    jm = jbuild(cfg.model)
    v = _random_variables(jm, jnp.asarray(xyz[:1]), None,
                          jnp.asarray(mask[:1]))
    key = jax.random.PRNGKey(3)
    g = np.random.default_rng(1).standard_normal(
        xyz.shape[:2] + (cfg.model.num_classes,)).astype(np.float32)

    def jax_grads():
        def f(p):
            out = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                           jnp.asarray(xyz), None, jnp.asarray(mask),
                           train=True, rngs={"cagq": key},
                           mutable=["batch_stats"])[0]
            return jnp.sum(out * g)
        grads = jax.jit(jax.grad(f))(v["params"])
        return {k: t.numpy() for k, t in convert_flax_variables({
            "params": jax.tree.map(np.asarray, grads),
            "batch_stats": v["batch_stats"]}).items()}

    def port_grads(double):
        model = build_model(to_port(cfg).model)
        model.load_state_dict(convert_flax_variables(v))
        if double:
            model.double()
            for m in model.modules():
                for a in ("dtype", "att_dtype", "interp_dtype"):
                    if isinstance(getattr(m, a, None), torch.dtype):
                        setattr(m, a, torch.float64)
        model.train()
        out = model(torch.from_numpy(xyz), None, torch.from_numpy(mask),
                    np.asarray(key))
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(
            (out * torch.from_numpy(g).to(out.dtype)).sum(),
            list(model.parameters()), allow_unused=True)
        return {n: t.double().numpy() for n, t in zip(names, grads)
                if t is not None}

    def bn64(self, x):      # two-pass variance in float64
        axes = tuple(range(x.dim() - 1))
        xf = x.double()
        mean = xf.mean(axes)
        var = ((xf - mean) ** 2).mean(axes)
        return (xf - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias

    with monkeypatch.context() as m:
        m.setattr(layers.BatchNorm, "forward", bn64)
        ref = port_grads(True)
    runs = {"JAX float32": jax_grads()}
    with monkeypatch.context() as m:
        m.setattr(normalization, "_compute_stats", _compute_stats_pairwise)
        runs["JAX float32, statistics summed pairwise"] = jax_grads()
    runs["port float32"] = port_grads(False)
    noise = tsteps.noise_gradient_params(cfg, ref)
    return {tag: max((np.linalg.norm(grads[n] - r) / np.linalg.norm(r), n)
                     for n, r in ref.items() if n not in noise)
            for tag, grads in runs.items()}


def test_batch_statistics_gradients_against_float64(monkeypatch):
    """The port's float32 gradients, and JAX's with flax's statistics
    summed pairwise (the `pairwise_bn` fixture of the parity tests), lie
    within 1e-5 of a float64 forward: the parity tests' 1e-4 gradient
    gate holds both to what float32 can give."""
    worst = _gradients_against_float64(monkeypatch)
    print("\nlargest per-tensor gradient error against the port in float64: "
          + "; ".join(f"{k} {e:.3g} ({n})" for k, (e, n) in worst.items()))
    assert worst["port float32"][0] <= 1e-5
    assert worst["JAX float32, statistics summed pairwise"][0] <= 1e-5


@pytest.mark.parametrize("att", ["softmax", "sigmoid"])
def test_noise_gradient_params(att):
    """The rounding-noise rule names each Dense bias that feeds a
    batch-statistics BatchNorm, and the attention logit's bias only under
    softmax attention."""
    import dataclasses

    cfg = to_port(jpresets.get("synthetic_tiny_seg"))
    layers = tuple(dataclasses.replace(s, att_activation=att)
                   for s in cfg.model.layers)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, layers=layers))
    names = [n for n, _ in build_model(cfg.model).named_parameters()]
    want = {f"gridconv{i}.gca.edge_dense{j}.bias" for i in (0, 1)
            for j in (0, 1)} | {f"up{i}_dense{j}.bias" for i in (0, 1)
                                for j in (0, 1)} | {"head_dense0.bias"}
    if att == "softmax":
        want |= {f"gridconv{i}.gca.att_dense1.bias" for i in (0, 1)}
    assert tsteps.noise_gradient_params(cfg, names) == want
