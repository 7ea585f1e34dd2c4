"""The port's models (gridgcn_torch.models, gridgcn_torch.api) against the
JAX package with the same converted weights: GCA, GridConv, decode_stage,
BN folding, the whole reduced whole-scene slice, and the Predictor."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.configs import base as jbase
from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.data.synthetic import synthetic_scene_surface
from gridgcn_tpu.models.build import build_model as jbuild
from gridgcn_tpu.models.fold import fold_batchnorm as jfold_batchnorm
from gridgcn_tpu.models.fold import fold_inference as jfold_inference
from gridgcn_tpu.models.gca import GCA as JGCA
from gridgcn_tpu.models.gridconv import GridConv as JGridConv
from gridgcn_torch.api import Predictor
from gridgcn_torch.configs import base as tbase
from gridgcn_torch.models.build import build_model, init_model
from gridgcn_torch.models.fold import fold_batchnorm
from gridgcn_torch.models.gca import GCA
from gridgcn_torch.models.gridconv import GridConv
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.convert import convert_flax_variables

torch.set_num_threads(1)

N = 1024


def reduced_whole_scene(dtype="float32"):
    """scannet_whole_scene cut to N=1024: the same 4 encoder layers
    (resolutions 64/32/16/8, threshold RVS, packed keys) and 4
    method="pallas" decoder stages, M = 128/64/32/16 and narrow widths.
    Every decoder support holds ≤ 128 points, so the TPU kernel's lane
    fold cannot collide and both packages pick the same neighbors."""
    cfg = jpresets.scannet_whole_scene()
    mlps = [(16, 16), (16, 16), (32, 32), (32, 32)]
    layers = tuple(
        dataclasses.replace(l, n_centers=m, mlp=w, context_channels=8,
                            att_hidden=8)
        for l, m, w in zip(cfg.model.layers, (128, 64, 32, 16), mlps))
    ups = tuple(dataclasses.replace(u, mlp=w) for u, w in zip(
        cfg.model.up_layers, [(32, 32), (32, 32), (32, 16), (16, 16, 16)]))
    model = dataclasses.replace(cfg.model, layers=layers, up_layers=ups,
                                head=(16,), dtype=dtype)
    return dataclasses.replace(cfg, model=model, data=dataclasses.replace(
        cfg.data, num_points=N))


def to_port(cfg):
    return tbase.from_dict(jbase.to_dict(cfg))


def _random_variables(model, *args, seed=0):
    """Flax variables of the model's shapes, drawn with numpy: weights at
    1/√fan_in, non-trivial BatchNorm scale/bias/mean/var so that folding is
    exercised."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "cagq": jax.random.PRNGKey(1)},
        *args))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(leaf.shape[0])).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if "'scale'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def whole():
    cfg = reduced_whole_scene()
    # scenes moved to the origin: the JAX mxu kernel splits the raw
    # coordinates, whose split-bf16 error grows with |x|², the port splits
    # them centered on the supports; near the origin the two agree to f32
    # rounding
    room_center = np.array([3.0, 1.3, 2.5], np.float32)
    xyz = np.stack([synthetic_scene_surface(N, seed=7),
                    synthetic_scene_surface(N, seed=8)]) - room_center
    mask = np.ones((2, N), bool)
    variables = _random_variables(jbuild(cfg.model), jnp.asarray(xyz[:1]),
                                  None, jnp.asarray(mask[:1]))
    fwds = {}

    def jax_logits(dtype, x, key):
        """The JAX serving forward: fold_inference, then apply."""
        if dtype not in fwds:
            fcfg, fvars = jfold_inference(reduced_whole_scene(dtype),
                                          variables)
            model = jbuild(fcfg.model)
            fwd = jax.jit(lambda x, m, k: model.apply(
                fvars, x, None, m, rngs={"cagq": k}))
            fwds[dtype] = fwd
        x = jnp.asarray(x)
        return np.asarray(fwds[dtype](x, jnp.ones(x.shape[:2], bool), key))

    return dict(cfg=cfg, xyz=xyz, mask=mask, variables=variables,
                sd=convert_flax_variables(variables), jax_logits=jax_logits)


def _sub_state(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_gca_matches_jax(whole):
    """GCA of layer 1 (unfolded BN, f32) on random groups."""
    spec = whole["cfg"].model.layers[1]
    rng = np.random.default_rng(2)
    B, M, K, C = 2, 16, spec.k_neighbors, whole["cfg"].model.layers[0].mlp[-1]
    node_feat = rng.standard_normal((B, M, K, C)).astype(np.float32)
    delta_p = (0.1 * rng.standard_normal((B, M, K, 3))).astype(np.float32)
    mask = rng.uniform(size=(B, M, K)) < 0.8
    mask[0, 0] = False                       # an empty group
    cov = rng.integers(1, 300, (B, M, K)).astype(np.int32)
    v = whole["variables"]
    jv = {"params": v["params"]["gridconv1"]["gca"],
          "batch_stats": v["batch_stats"]["gridconv1"]["gca"]}
    want = np.asarray(JGCA(spec).apply(
        jv, jnp.asarray(node_feat), jnp.asarray(delta_p), jnp.asarray(mask),
        jnp.asarray(cov)))
    gca = GCA(to_port(whole["cfg"]).model.layers[1], C)
    gca.load_state_dict(_sub_state(whole["sd"], "gridconv1.gca."))
    got = gca.eval()(torch.from_numpy(node_feat), torch.from_numpy(delta_p),
                     torch.from_numpy(mask), torch.from_numpy(cov).long())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_gridconv_matches_jax(whole):
    """GridConv of layer 0 as a root module (its key is
    flax_make_rng(key, (), 1)) on the xyz-prefix input, unfolded f32."""
    spec = whole["cfg"].model.layers[0]
    xyz = whole["xyz"][:1]
    mask = np.ones((1, N), bool)
    mask[0, -50:] = False
    v = whole["variables"]
    jv = {"params": v["params"]["gridconv0"],
          "batch_stats": v["batch_stats"]["gridconv0"]}
    key = jax.random.PRNGKey(11)
    jmod = JGridConv(spec, feat_has_xyz_prefix=True)
    cj, fj, vj = [np.asarray(o) for o in jax.jit(
        lambda x, m, k: jmod.apply(jv, x, x, m, rngs={"cagq": k}))(
        jnp.asarray(xyz), jnp.asarray(mask), key)]
    conv = GridConv(to_port(whole["cfg"]).model.layers[0], 3,
                    feat_has_xyz_prefix=True)
    conv.load_state_dict(_sub_state(whole["sd"], "gridconv0."))
    x = torch.from_numpy(xyz)
    ct, ft, vt = conv.eval()(x, x, torch.from_numpy(mask),
                             jaxrng.flax_make_rng(np.asarray(key), (), 1))
    np.testing.assert_array_equal(vj, vt.numpy())
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ft.detach().numpy(), fj, rtol=1e-5, atol=1e-5)


def test_decode_stage_matches_jax(whole):
    """Decoder stage 2 (32-point support → 128 queries, masked) with the
    flash-kNN query, unfolded f32. Coordinates on a 2⁻⁴ grid in [0, 4):
    their split-bf16 halves and every product and sum are exact in both
    packages (the JAX kernel splits raw coordinates, the port centered
    ones), so the distances agree and the tolerance is f32 rounding of
    the MLPs."""
    cfg = whole["cfg"]
    rng = np.random.default_rng(4)
    B, Mc, Md = 2, 32, 128
    Cc, Cd = cfg.model.up_layers[1].mlp[-1], cfg.model.layers[0].mlp[-1]
    c_xyz = (rng.integers(0, 64, (B, Mc, 3)) / 16).astype(np.float32)
    d_xyz = (rng.integers(0, 64, (B, Md, 3)) / 16).astype(np.float32)
    c_feat = rng.standard_normal((B, Mc, Cc)).astype(np.float32)
    d_feat = rng.standard_normal((B, Md, Cd)).astype(np.float32)
    c_mask = np.ones((B, Mc), bool)
    c_mask[:, -3:] = False
    d_mask = np.ones((B, Md), bool)
    d_mask[1, -10:] = False
    args = (c_xyz, c_feat, c_mask, d_xyz, d_feat, d_mask)
    jmodel = jbuild(cfg.model)
    want = np.asarray(jmodel.apply(
        whole["variables"], 2, *map(jnp.asarray, args),
        method=jmodel.decode_stage))
    model = build_model(to_port(cfg).model)
    model.load_state_dict(whole["sd"])
    got = model.eval().decode_stage(2, *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_fold_matches_jax(whole):
    """Port fold of the converted weights == conversion of the JAX fold."""
    folded, n = fold_batchnorm(whole["sd"])
    jfolded, jn = jfold_batchnorm(whole["variables"])
    want = convert_flax_variables(jfolded)
    assert n == jn > 0
    assert sorted(folded) == sorted(want)
    for k in want:
        np.testing.assert_allclose(folded[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_whole_slice_f32_matches_jax(whole):
    """The reduced whole-scene forward, served (folded) in f32: logits
    within 1e-4 — f32 sum-order differences through 4 encoder and 4
    decoder stages; the CAGQ indices are identical."""
    key = jax.random.PRNGKey(3)
    want = whole["jax_logits"]("float32", whole["xyz"][:1], key)[0]
    pred = Predictor(to_port(whole["cfg"]), whole["sd"], device="cpu")
    got = pred(whole["xyz"][0], rng=np.asarray(key))
    assert got.shape == (N, 21) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_whole_slice_bf16_meets_fidelity_gate(whole):
    """Served in bf16 (the preset's dtype): test_models.py's bf16 gate —
    argmax agreement ≥ 0.98 and |Δlogit| ≤ 10% of the f32 logit range —
    against the JAX f32 forward and against the JAX bf16 forward."""
    key = jax.random.PRNGKey(3)
    x = whole["xyz"][:1]
    l32 = whole["jax_logits"]("float32", x, key)[0]
    l16j = whole["jax_logits"]("bfloat16", x, key)[0]
    pred = Predictor(to_port(reduced_whole_scene("bfloat16")), whole["sd"],
                     device="cpu")
    l16 = pred(x[0], rng=np.asarray(key))
    assert l16.dtype == np.float32
    scale = float(np.abs(l32).max())
    for ref in (l32, l16j):
        assert (l16.argmax(-1) == ref.argmax(-1)).mean() >= 0.98
        np.testing.assert_allclose(l16, ref, atol=0.1 * scale)


def test_predictor_batch_and_votes_match_jax(whole):
    """Predictor.__call__ on [B,N,3] and predict_scene(votes=2) against the
    JAX forward with the same keys (per-cloud keys split inside CAGQ;
    votes on fold_in(rng, v))."""
    pred = Predictor(to_port(whole["cfg"]), whole["sd"], device="cpu")
    key = jax.random.PRNGKey(5)
    want = whole["jax_logits"]("float32", whole["xyz"], key)
    got = pred(whole["xyz"], rng=np.asarray(key))
    assert got.shape == (2, N, 21)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    votes = [whole["jax_logits"]("float32", whole["xyz"][:1],
                                 jax.random.fold_in(key, v))[0]
             for v in range(2)]
    got = pred.predict_scene(whole["xyz"][0], votes=2, rng=np.asarray(key))
    np.testing.assert_allclose(got, (votes[0] + votes[1]) / 2, rtol=0,
                               atol=1e-4)


def test_init_model_is_seeded():
    """init_model draws every weight from the generator it is given."""
    cfg = to_port(reduced_whole_scene()).model
    _, a = init_model(cfg, torch.Generator().manual_seed(0))
    _, b = init_model(cfg, torch.Generator().manual_seed(0))
    _, c = init_model(cfg, torch.Generator().manual_seed(1))
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["logits.weight"], c["logits.weight"])
