"""The port's classifier and decoder dispatch (gridgcn_torch.models) against
the JAX package with the same converted weights: GridGCNClassifier on
synthetic_tiny and narrow modelnet40_full / modelnet40_cas, 'candidates'
context pooling, padding invariance, example_inputs, and
synthetic_tiny_seg under every decoder method.

Tolerances: the CAGQ indices are equal in both packages, so the logits
differ only by float32 summation order: 1e-5 of the logit range. Served
in bf16 (after fold_inference) both packages round the same products to
8 bits in different orders: 5% of the f32 logit range."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.models.build import build_model as jbuild
from gridgcn_tpu.models.build import example_inputs as jexample_inputs
from gridgcn_tpu.models.fold import fold_inference as jfold_inference
from gridgcn_torch.api import Predictor
from gridgcn_torch.configs import presets as tpresets
from gridgcn_torch.models.build import build_model, example_inputs
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.convert import convert_flax_variables
from tests.test_torch_models import _random_variables, to_port

torch.set_num_threads(1)


def narrow(cfg, N=1024):
    """A preset at its own grids, center counts and K, with narrow widths."""
    layers = tuple(dataclasses.replace(
        l, mlp=(16, 16 * (i + 1)), context_channels=8, att_hidden=8)
        for i, l in enumerate(cfg.model.layers))
    ups = tuple(dataclasses.replace(u, mlp=(16, 16))
                for u in cfg.model.up_layers)
    model = dataclasses.replace(cfg.model, layers=layers, up_layers=ups,
                                head=(32, 16)[:len(cfg.model.head)])
    return dataclasses.replace(cfg, model=model, data=dataclasses.replace(
        cfg.data, num_points=N))


def with_layers(cfg, **kw):
    layers = tuple(dataclasses.replace(l, **kw) for l in cfg.model.layers)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, layers=layers))


def with_method(cfg, method):
    ups = tuple(dataclasses.replace(u, method=method)
                for u in cfg.model.up_layers)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, up_layers=ups))


def _clouds(cfg, B=2, seed=0, n_masked=0):
    rng = np.random.default_rng(seed)
    N = cfg.data.num_points
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    if n_masked:
        mask[:, N - n_masked:] = False
    return xyz, mask


def _jax_served(cfg, variables, xyz, mask, key, dtype="float32"):
    """The JAX serving forward: fold_inference, then apply."""
    m = dataclasses.replace(cfg.model, dtype=dtype, eval_dtype="")
    fcfg, fvars = jfold_inference(dataclasses.replace(cfg, model=m),
                                  variables)
    model = jbuild(fcfg.model)
    return np.asarray(jax.jit(lambda x, k_: model.apply(
        fvars, x, None, jnp.asarray(mask), rngs={"cagq": k_}))(
        jnp.asarray(xyz), key))


def _port_served(cfg, variables, xyz, mask, key, dtype="float32"):
    m = dataclasses.replace(cfg.model, dtype=dtype, eval_dtype="")
    pred = Predictor(to_port(dataclasses.replace(cfg, model=m)),
                     convert_flax_variables(variables), device="cpu")
    return pred(xyz, mask=mask, rng=np.asarray(key))


def _variables(cfg, xyz, mask, seed=0):
    return _random_variables(jbuild(cfg.model), jnp.asarray(xyz[:1]), None,
                             jnp.asarray(mask[:1]), seed=seed)


def _close(got, want, frac):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale)


CLS = {
    "synthetic_tiny": lambda: jpresets.get("synthetic_tiny"),
    "modelnet40_full": lambda: narrow(jpresets.get("modelnet40_full")),
    "modelnet40_cas": lambda: narrow(jpresets.get("modelnet40_cas")),
}


@pytest.mark.parametrize("name", sorted(CLS))
def test_classifier_logits_match_jax(name):
    """f32 served logits, [B, C]; and the bf16 serving gate."""
    cfg = CLS[name]()
    xyz, mask = _clouds(cfg, n_masked=100)
    v = _variables(cfg, xyz, mask)
    key = jax.random.PRNGKey(3)
    want = _jax_served(cfg, v, xyz, mask, key)
    got = _port_served(cfg, v, xyz, mask, key)
    assert got.shape == (2, cfg.model.num_classes)
    _close(got, want, 1e-5)
    if name != "synthetic_tiny":
        got16 = _port_served(cfg, v, xyz, mask, key, "bfloat16")
        _close(got16, want, 0.05)
        _close(got16, _jax_served(cfg, v, xyz, mask, key, "bfloat16"), 0.05)


def test_classifier_padding_invariance():
    """Garbage in masked-out points does not change the logits (the
    mask-leak property of tests/test_models.py)."""
    cfg = jpresets.get("synthetic_tiny")
    xyz, mask = _clouds(cfg, seed=1, n_masked=40)
    v = _variables(cfg, xyz, mask)
    key = np.asarray(jax.random.PRNGKey(1))
    pred = Predictor(to_port(cfg), convert_flax_variables(v), device="cpu")
    l1 = pred(xyz, mask=mask, rng=key)
    poisoned = xyz.copy()
    poisoned[:, -40:] = 77.7
    l2 = pred(poisoned, mask=mask, rng=key)
    np.testing.assert_allclose(l1, l2, rtol=0, atol=1e-5)
    # one cloud [N, 3] → [C]; predict_classes → a class per cloud
    one = pred(xyz[0], mask=mask[0], rng=key)
    assert one.shape == (cfg.model.num_classes,)
    np.testing.assert_array_equal(pred.predict_classes(xyz, mask=mask),
                                  np.argmax(pred(xyz, mask=mask), -1))


def test_candidates_context_pooling_matches_jax():
    """'candidates' pooling (slot-table build and gather, masked mean over
    every stored context point) against JAX, and its mask discipline."""
    cfg = with_layers(jpresets.get("synthetic_tiny"),
                      context_pool_source="candidates")
    xyz, mask = _clouds(cfg, seed=2, n_masked=30)
    v = _variables(cfg, xyz, mask)
    key = jax.random.PRNGKey(1)
    want = _jax_served(cfg, v, xyz, mask, key)
    got = _port_served(cfg, v, xyz, mask, key)
    _close(got, want, 1e-5)
    poisoned = xyz.copy()
    poisoned[:, -30:] = 55.5
    _close(_port_served(cfg, v, poisoned, mask, key), got, 1e-6)


def test_example_inputs_match_jax():
    for name in ("synthetic_tiny", "s3dis_seg"):
        cfg = jpresets.get(name)
        want = jexample_inputs(cfg, batch_size=2)
        got = example_inputs(to_port(cfg), batch_size=2, device="cpu")
        for w, g in zip(want, got):
            assert (w is None) == (g is None)
            if w is not None:
                np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("method", ["auto", "dense", "grid"])
def test_tiny_seg_logits_match_jax(method):
    """synthetic_tiny_seg (as configured: method auto, which is dense at
    these sizes) and its dense and grid overrides."""
    cfg = with_method(jpresets.get("synthetic_tiny_seg"), method)
    xyz, mask = _clouds(cfg, seed=4, n_masked=20)
    v = _variables(cfg, xyz, mask)
    key = jax.random.PRNGKey(5)
    want = _jax_served(cfg, v, xyz, mask, key)
    got = _port_served(cfg, v, xyz, mask, key)
    assert got.shape == (2, cfg.data.num_points, cfg.model.num_classes)
    _close(got, want, 1e-5)


def test_grid_stage_keys_follow_flax_root_scope(monkeypatch):
    """A grid decoder stage draws its voxel-build key with make_rng in the
    root module's scope: flax_make_rng(key, (), n) for the n-th grid stage.
    Captured from the JAX model through a recording grid_three_nn."""
    import gridgcn_tpu.models.segmentation as jseg

    seen = []
    real = jseg.grid_three_nn

    def recording(*args, **kw):
        jax.debug.callback(lambda k: seen.append(np.asarray(k)), args[6])
        return real(*args, **kw)

    monkeypatch.setattr(jseg, "grid_three_nn", recording)
    cfg = with_method(jpresets.get("synthetic_tiny_seg"), "grid")
    xyz, mask = _clouds(cfg, B=1)
    shapes = jax.eval_shape(lambda: jbuild(cfg.model).init(
        {"params": jax.random.PRNGKey(0), "cagq": jax.random.PRNGKey(1)},
        jnp.asarray(xyz), None, jnp.asarray(mask)))
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    root = jax.random.PRNGKey(9)
    jax.block_until_ready(jax.jit(lambda v_, k: jbuild(cfg.model).apply(
        v_, jnp.asarray(xyz), None, jnp.asarray(mask), rngs={"cagq": k}))(
        v, root))
    jax.effects_barrier()
    assert len(seen) == len(cfg.model.up_layers)
    for n, k in enumerate(seen, start=1):
        np.testing.assert_array_equal(
            k, jaxrng.flax_make_rng(np.asarray(root), (), n))


def test_every_preset_builds_and_serves():
    """Every preset of the port builds, and serves on the CPU at a small N
    with narrow widths (mirroring tests/test_models.py's preset sweep);
    classification returns [B, num_classes] float32 logits, segmentation
    [B, N, num_classes]."""
    from gridgcn_torch.models.build import init_model

    for name in tpresets.PRESETS:
        cfg = tpresets.get(name)
        assert build_model(cfg.model) is not None
        small = narrow(cfg, N=2048)
        _, sd = init_model(small.model, torch.Generator().manual_seed(0))
        xyz, mask = _clouds(small, B=2, seed=6)
        feat = None
        if small.model.in_channels:
            feat = np.random.default_rng(0).uniform(
                0, 1, (2, 2048, small.model.in_channels)).astype(np.float32)
        out = Predictor(small, sd, device="cpu")(xyz, feat, mask)
        want = (2, small.model.num_classes) if small.model.task == "cls" \
            else (2, 2048, small.model.num_classes)
        assert out.shape == want and out.dtype == np.float32, name
        assert np.isfinite(out).all(), name
