"""The port's export artifact (gridgcn_torch.export) and what it rests
on, on the CPU: jaxrng's tensor-key path (the key a traced input), the
kNN kernels as `torch.library` custom ops, the artifact against the live
Predictor and JAX's served forward, its signature guards and CLI, and
the TF32 scope.

One artifact for the module (`synthetic_tiny_seg` with the pallas
decoder, so the custom op `gridgcn::knn3_mxu` sits in the program),
written by the CLI from a checkpoint of JAX's random variables
(converted); tracing takes ~20 s on one core. Tolerances: the artifact
equals the live port Predictor exactly (the same ops on the CPU), and
JAX's served forward (its Pallas kernel in interpret mode) at the f32 gate
of a pallas-decoder forward, 1e-4 absolute
(`test_torch_models.test_whole_slice_f32_matches_jax`).
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.models.build import build_model as jbuild
from gridgcn_tpu.models.fold import fold_inference as jfold_inference
from gridgcn_torch import api, export
from gridgcn_torch.kernels import knn
from gridgcn_torch.models.build import build_model
from gridgcn_torch.train import steps
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.checkpoint import CheckpointManager
from gridgcn_torch.utils.convert import convert_flax_variables
from gridgcn_torch.utils.precision import full_fp32
from tests.test_torch_models import _random_variables, to_port

torch.set_num_threads(1)

KEYS = [jax.random.PRNGKey(s) for s in (0, 1, 42, 2 ** 31 + 5)] + [
    jax.random.split(jax.random.PRNGKey(9))[1]]


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
def test_tensor_keys_derive_as_numpy_and_jax(key):
    """split / fold_in / flax_make_rng on an int64 tensor key give the
    numpy path's words and JAX's, and draws under a tensor key the numpy
    key's; [B, 2] tensor keys split row by row."""
    k = np.asarray(key)
    t = jaxrng.key_tensor(k)
    assert t.dtype == torch.int64 and t.shape == (2,)
    for num, start in ((2, 0), (5, 0), (3, 4)):
        want = np.asarray(jax.random.split(key, start + num))[start:]
        np.testing.assert_array_equal(jaxrng.split(k, num, start), want)
        np.testing.assert_array_equal(
            jaxrng.split(t, num, start).numpy(), want)
    for d in (0, 7, 2 ** 32 - 1):
        want = np.asarray(jax.random.fold_in(key, d))
        np.testing.assert_array_equal(jaxrng.fold_in(t, d).numpy(), want)
        np.testing.assert_array_equal(jaxrng.fold_in(k, d), want)
    for path, c in ((("gridconv0",), 1), ((), 3), (("_dropout",), 2)):
        np.testing.assert_array_equal(
            jaxrng.flax_make_rng(t, path, c).numpy(),
            jaxrng.flax_make_rng(k, path, c))
    keys = np.asarray(jax.random.split(key, 3))
    np.testing.assert_array_equal(
        jaxrng.split(jaxrng.key_tensor(keys), 4).numpy(),
        jaxrng.split(keys, 4))
    for draw in (jaxrng.bits, jaxrng.uniform, jaxrng.normal):
        assert torch.equal(draw(t, (3, 50)), draw(k, (3, 50)))
    assert torch.equal(jaxrng.permutation(t, 40), jaxrng.permutation(k, 40))


def test_row_offsets_draw_rows_of_the_global_draw():
    """bits/uniform/normal/bernoulli(row0=) are rows [row0, row0 + b) of
    the draw at the global batch; split(start=) the matching keys."""
    k = np.asarray(jax.random.PRNGKey(5))
    whole = jaxrng.bits(k, (6, 7, 3))
    for r0, b in ((0, 2), (2, 2), (4, 2), (3, 3)):
        assert torch.equal(jaxrng.bits(k, (b, 7, 3), row0=r0),
                           whole[r0:r0 + b])
        assert torch.equal(jaxrng.normal(k, (b, 7), row0=r0),
                           jaxrng.normal(k, (6, 7))[r0:r0 + b])
        assert torch.equal(jaxrng.bernoulli(k, 0.3, (b, 5), row0=r0),
                           jaxrng.bernoulli(k, 0.3, (6, 5))[r0:r0 + b])
        np.testing.assert_array_equal(jaxrng.split(k, b, start=r0),
                                      jaxrng.split(k, 6)[r0:r0 + b])
    with pytest.raises(ValueError, match="single key"):
        jaxrng.bits(jaxrng.split(k, 2), (3,), row0=1)


OPS = [("knn3_mxu", knn.knn3_mxu_ref, 4), ("knn3_exact", knn.knn3_exact_ref, 4),
       ("mxu_pack_support", knn.mxu_pack_support_ref, 2)]


@pytest.mark.parametrize("name,ref,nargs", OPS, ids=[o[0] for o in OPS])
def test_custom_ops_are_the_plain_versions_and_pass_opcheck(name, ref,
                                                            nargs):
    """Each op's CPU implementation is its plain version; opcheck passes
    on the schema, the fake (meta) implementation and its dynamic shapes;
    the CPU path counts no launch."""
    g = torch.Generator().manual_seed(3)
    q, s = torch.rand(70, 3, generator=g), torch.rand(300, 3, generator=g)
    qm = torch.ones(70, dtype=torch.bool)
    qm[-5:] = False
    sm = torch.rand(300, generator=g) > 0.2
    args = (q, qm, s, sm)[-nargs:] if nargs == 2 else (q, qm, s, sm)
    op = getattr(torch.ops.gridgcn, name).default
    n0 = knn.knn3_mxu.launches, knn.knn3_exact.launches, \
        knn.mxu_pack_support.launches
    got, want = op(*args), ref(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    assert n0 == (knn.knn3_mxu.launches, knn.knn3_exact.launches,
                  knn.mxu_pack_support.launches)


def _jax_served_fn(cfg, variables, x):
    """JAX's served forward of x (fold_inference, then apply; its Pallas
    kernel in interpret mode), jitted once, as a function of the key."""
    fcfg, fvars = jfold_inference(cfg, variables)
    model = jbuild(fcfg.model)
    fwd = jax.jit(lambda k: model.apply(
        fvars, jnp.asarray(x), None, jnp.ones(x.shape[:2], bool),
        rngs={"cagq": k}))
    return lambda k: np.asarray(fwd(k))


def _cfg():
    cfg = jpresets.get("synthetic_tiny_seg")
    ups = tuple(dataclasses.replace(u, method="pallas")
                for u in cfg.model.up_layers)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, up_layers=ups))


def _scene(B=2, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, 256, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A checkpoint of JAX's random variables (converted) and the artifact
    the export CLI writes from it at [2, 256]; the CLI's summary line."""
    tmp = tmp_path_factory.mktemp("export")
    cfg = _cfg()
    x = _scene()
    v = _random_variables(jbuild(cfg.model), jnp.asarray(x[:1]), None,
                          jnp.ones((1, 256), bool))
    pcfg = to_port(cfg)
    state = steps.create_train_state(pcfg, build_model(pcfg.model),
                                     convert_flax_variables(v), 4,
                                     device="cpu")
    CheckpointManager(str(tmp / "ck"), pcfg).save(0, state,
                                                  jaxrng.PRNGKey(0))
    out = str(tmp / "seg.pt2")
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = export.main(["--ckpt-dir", str(tmp / "ck"), "--out", out,
                          "--batch-size", "2", "--num-points", "256",
                          "--device", "cpu"])
    assert rc == 0
    return dict(ckpt=str(tmp / "ck"), path=out, cfg=cfg, variables=v,
                summary=json.loads(buf.getvalue().strip().splitlines()[-1]),
                frozen=export.load_exported(out))


def test_export_cli_and_meta(artifact):
    s = artifact["summary"]
    assert s["task"] == "seg" and s["batch_size"] == 2
    assert s["num_points"] == 256 and s["step"] == 0
    assert s["platforms"] == ["cpu"] and s["bytes"] > 0
    with open(artifact["path"] + ".json") as f:
        meta = json.load(f)
    assert meta["format"] == "gridgcn-torch-export-v1"
    assert meta["in_channels"] == 0 and meta["num_classes"] == 4
    program = torch.export.load(artifact["path"])
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert "gridgcn.knn3_mxu.default" in targets
    # the key is an input of the program, not a constant
    names = [s.arg.name for s in program.graph_signature.input_specs
             if s.kind.name == "USER_INPUT"]
    assert len(names) == 3


def test_export_roundtrip_under_two_keys(artifact):
    """The artifact equals the live port Predictor under two keys, and
    JAX's served forward at the f32 gate; the two keys give different
    logits (other CAGQ draws), so the key is an input."""
    frozen = artifact["frozen"]
    live = api.load_predictor(artifact["ckpt"], device="cpu")
    x = _scene()
    jax_served = _jax_served_fn(artifact["cfg"], artifact["variables"], x)
    outs = []
    for k in (jax.random.PRNGKey(7), jax.random.PRNGKey(8)):
        got = frozen(x, rng=np.asarray(k))
        np.testing.assert_array_equal(got, live(x, rng=np.asarray(k)))
        np.testing.assert_allclose(got, jax_served(k), rtol=0, atol=1e-4)
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 1e-3
    # a smaller batch and cloud ride the padded signature and trim back;
    # a cloud's draws do not depend on the padding rows
    small = frozen(x[:1, :200], rng=np.asarray(jax.random.PRNGKey(7)))
    assert small.shape == (1, 200, 4) and np.isfinite(small).all()
    one = frozen(x[0], rng=np.asarray(jax.random.PRNGKey(7)))
    np.testing.assert_array_equal(one, outs[0][0])
    v3 = frozen(x, votes=3)
    assert v3.shape == outs[0].shape and not np.allclose(v3, outs[0])


def test_export_signature_guards(artifact):
    frozen = artifact["frozen"]
    x = _scene(3, 1)
    with pytest.raises(ValueError, match="exceeds the exported"):
        frozen(x)
    with pytest.raises(ValueError, match="in_channels"):
        frozen(x[:2], feat=x[:2])
    with pytest.raises(ValueError, match="votes"):
        frozen(x[:2], votes=0)


def test_tf32_scope_restores_the_callers_setting(monkeypatch):
    """The port turns TF32 off around its own work and gives the caller's
    flags back, also when the work raises; a Predictor call and a train
    step leave a caller's True as it was."""
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    monkeypatch.setattr(mm, "allow_tf32", True)
    monkeypatch.setattr(cd, "allow_tf32", True)
    seen = []
    with full_fp32():
        seen.append((mm.allow_tf32, cd.allow_tf32))
    with pytest.raises(KeyError):
        with full_fp32():
            raise KeyError
    assert (mm.allow_tf32, cd.allow_tf32) == (True, True)
    assert seen == [(False, False)]
    cfg = to_port(jpresets.get("synthetic_tiny"))
    from gridgcn_torch.models.build import init_model
    model, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    pred = api.Predictor(cfg, sd, device="cpu")
    net = pred._model.forward
    monkeypatch.setattr(pred._model, "forward", lambda *a, **k: (
        seen.append((mm.allow_tf32, cd.allow_tf32)), net(*a, **k))[1])
    pred(_scene(1)[0])
    assert seen[-1] == (False, False)
    assert (mm.allow_tf32, cd.allow_tf32) == (True, True)
