"""The port's data-parallel paths on a world-2 gloo mesh on the CPU,
against the JAX package's on a 2-device mesh (the 8 fake CPU devices of
`tests/conftest.py`): the DP train step, the DP eval step, mesh serving
and tier-1 spatial sharding.

One spawn of two workers for the module (`tests/torch_dp_worker.py`, the
port only, under `parallel.launch` with a timeout) runs every port path
on inputs written here from the JAX package's random variables
(converted); each test then holds one result against JAX.

Tolerances: the train step (segmentation) at `test_torch_train.check`'s (loss, accuracy,
gradient norm 1e-5 relative; gradients 1e-4 relative L2; parameters and
BatchNorm statistics 1e-5 of their scale where determined, the rest
within Adam's bound), with flax's statistics summed pairwise
(`pairwise_bn`, which that file explains); the confusion matrix exactly;
served and tier-1 logits at the f32 serving gate (1e-5 of the range,
`test_torch_classifier`).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.data.augment import augment_batch as jaugment_batch
from gridgcn_tpu.data.synthetic import synthetic_scene_surface
from gridgcn_tpu.models.build import build_model as jbuild
from gridgcn_tpu.parallel import spatial as jspatial
from gridgcn_tpu.parallel.dp import make_parallel_train_step as jdp_step
from gridgcn_tpu.parallel.mesh import make_mesh as jmake_mesh
from gridgcn_tpu.parallel.mesh import replicate_tree
from gridgcn_tpu.parallel.mesh import shard_batch as jshard_batch
from gridgcn_tpu.train import steps as jsteps
from gridgcn_torch.models.build import build_model
from gridgcn_torch.parallel import mesh as pmesh
from gridgcn_torch.parallel import spatial as tspatial
from gridgcn_torch.parallel.launch import launch
from gridgcn_torch.train import steps
from gridgcn_torch.utils.convert import convert_flax_variables
from tests import torch_dp_worker
from tests.test_torch_classifier import _close, _jax_served
from tests.test_torch_models import _random_variables, to_port
from tests.test_torch_train import (
    Pair, _compute_stats_pairwise, check, make_batch, with_model)

torch.set_num_threads(1)

TRAIN = {
    # augmentation (every draw at the global batch's counters), dropout
    # in the head, the seg loss's global denominators
    "seg": lambda: dataclasses.replace(with_model(
        jpresets.get("synthetic_tiny_seg"), dropout=0.5),
        data=dataclasses.replace(jpresets.get("synthetic_tiny_seg").data,
                                 augment=True)),
    # the cls loss's global mean, the classifier's [B, C] dropout
    "cls": lambda: with_model(jpresets.get("synthetic_tiny"), dropout=0.3),
}
TRAIN_KEY = jax.random.PRNGKey(7)
# held against JAX's DP step (its compile is most of this file's time);
# "cls" against the port's single-device step on the global batch
JAX_DP = ("seg",)


def _variables(cfg, batch, seed=0):
    return _random_variables(jbuild(cfg.model),
                             jnp.asarray(batch["xyz"][:1]), None,
                             jnp.asarray(batch["mask"][:1]), seed=seed)


def _scene():
    xyz = synthetic_scene_surface(1024, seed=3)
    return xyz, np.ones(len(xyz), bool)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    inp = {"train": {}}
    for name, make in TRAIN.items():
        cfg = make()
        batch = make_batch(cfg)
        inp["train"][name] = dict(
            cfg=to_port(cfg), batch=batch, key=np.asarray(TRAIN_KEY), spe=4,
            sd=convert_flax_variables(_variables(cfg, batch)))
    cfg = jpresets.get("synthetic_tiny")
    batch = make_batch(cfg, seed=4)
    inp["eval"] = dict(cfg=to_port(cfg), batch=batch,
                       key=np.asarray(jax.random.PRNGKey(9)),
                       sd=convert_flax_variables(_variables(cfg, batch, 1)))
    cfg = jpresets.get("synthetic_tiny_seg")
    batch = make_batch(cfg, seed=5)
    inp["serve"] = dict(cfg=to_port(cfg), xyz=batch["xyz"],
                        key=np.asarray(jax.random.PRNGKey(11)),
                        sd=convert_flax_variables(_variables(cfg, batch, 2)))
    xyz, mask = _scene()
    halo = tspatial.required_halo(cfg, float(np.ptp(xyz, axis=0).max()))
    inp["tier1"] = dict(cfg=to_port(cfg), sd=inp["serve"]["sd"], xyz=xyz,
                        key=np.asarray(jax.random.PRNGKey(13)), halo=halo,
                        capacity=tspatial.suggest_capacity(xyz, mask, 2,
                                                           halo))
    torch.save(inp, tmp / "inputs.pt")
    launch(torch_dp_worker.run, pmesh.mesh_devices("cpu", 2),
           str(tmp / "inputs.pt"), str(tmp), timeout_s=300)
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    assert [o["rank"] for o in out] == [0, 1]
    return inp, out


def _jax_dp_grads(pair, mesh, rng):
    """The gradients of JAX's DP step: its loss function jitted with the
    batch sharded over the mesh (as `build_train_step` computes them)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    cfg = pair.cfg

    def grads(params, stats, step, batch, rng):
        rng = jax.random.fold_in(rng, step)
        k_aug, k_cagq, k_drop = jax.random.split(rng, 3)
        xyz, mask, feat = jaugment_batch(batch["xyz"], batch["mask"], k_aug,
                                         cfg.data)

        def loss_fn(p):
            logits, _ = pair.model.apply(
                {"params": p, "batch_stats": stats}, xyz, feat, mask,
                train=True, rngs={"cagq": k_cagq, "dropout": k_drop},
                mutable=["batch_stats"])
            return jsteps._loss_and_logits(cfg, logits,
                                           {**batch, "mask": mask})[0]
        return jax.grad(loss_fn)(params)

    rep, sh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    s = pair.jstate
    g = jax.jit(grads, in_shardings=(rep, rep, rep, sh, rep))(
        s.params, s.batch_stats, s.step, pair.jbatch, rng)
    return pair.flat(g)


@pytest.fixture(scope="module")
def jax_dp(runs):
    """Each train case through JAX's DP step on a 2-device mesh (its
    gradients, metrics and updated state), with flax's statistics summed
    pairwise: {name: (pair, metrics, gradients, the state before)}."""
    inp, _ = runs
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        import flax.linen.normalization as normalization
        mp.setattr(normalization, "_compute_stats", _compute_stats_pairwise)
        for name in JAX_DP:
            case = inp["train"][name]
            cfg = TRAIN[name]()
            pair = Pair(cfg, case["batch"])
            mesh = jmake_mesh(2)
            jg = _jax_dp_grads(pair, mesh, TRAIN_KEY)
            _, sched = jsteps.make_optimizer(cfg, case["spe"])
            step = jdp_step(cfg, pair.model, mesh, sched, donate=False)
            pair.jstate, jm = step(replicate_tree(pair.jstate, mesh),
                                   jshard_batch(pair.jbatch, mesh),
                                   replicate_tree(TRAIN_KEY, mesh))
            out[name] = (pair, jm, jg,
                         {k: v.clone() for k, v in case["sd"].items()})
    return out


def _check_dp_step(runs, jax_dp, name, variant):
    """The gate of JAX's DP step against the port's rank 0 (`check`),
    after asserting that both ranks' parameters, statistics and metrics
    are equal bit for bit (the global variant)."""
    _, out = runs
    pair, jm, jg, before = jax_dp[name]
    r0, r1 = (o["train"][name][variant] for o in out)
    if variant == "global":
        for k in r0["sd"]:
            assert torch.equal(r0["sd"][k], r1["sd"][k]), k
        assert r0["metrics"] == r1["metrics"]
    pair.pstate.model.load_state_dict(r0["sd"])
    return lambda: check(pair, dict(jm=jm, pm=r0["metrics"], jg=jg,
                                    pg=r0["grads"], before=before))


@pytest.mark.parametrize("name", JAX_DP)
def test_dp_train_step_matches_jax_dp_step(runs, jax_dp, name):
    _check_dp_step(runs, jax_dp, name, "global")()


@pytest.mark.parametrize("name", JAX_DP)
def test_shard_local_batch_norm_fails_the_same_gate(runs, jax_dp, name):
    """With each rank's BatchNorm statistics its own rows' (what the JAX
    package's `parallel/dp.py` docstring says its step does), the port
    no longer matches JAX's DP step: the statistics are the global
    batch's."""
    gate = _check_dp_step(runs, jax_dp, name, "local")
    with pytest.raises(AssertionError):
        gate()


def _single_device_step(case):
    """The port's single-device step on the whole global batch: metrics,
    gradients and state."""
    cfg = case["cfg"]
    state = steps.create_train_state(cfg, build_model(cfg.model), case["sd"],
                                     case["spe"], device="cpu")
    grads = []
    update = state.tx.update
    state.tx.update = lambda g, norm: (
        grads.append([x.clone() for x in g]), update(g, norm))[1]
    state, m = steps.make_train_step(cfg)(state, case["batch"], case["key"])
    names = [n for n, _ in state.model.named_parameters()]
    return ({k: float(v) for k, v in m.items()},
            dict(zip(names, grads[0])), state.model.state_dict())


@pytest.mark.parametrize("variant", ["global", "local"])
def test_cls_dp_step_is_the_single_device_step(runs, variant):
    """synthetic_tiny with dropout: the world-2 step against the port's
    single-device step on the global batch at `check`'s gates (metrics
    1e-5, gradients 1e-4 relative L2 but the rounding-noise ones within
    2e-4 of the largest, BatchNorm statistics 1e-5 of scale, parameters
    within Adam's bound); shard-local statistics fail them."""
    inp, out = runs
    case = inp["train"]["cls"]
    m, g, sd = _single_device_step(case)
    r0, r1 = (o["train"]["cls"][variant] for o in out)

    noise = steps.noise_gradient_params(case["cfg"], g)
    gmax = max(float(t.abs().max()) for t in g.values())

    def gate():
        for k in ("loss", "acc", "grad_norm", "lr"):
            np.testing.assert_allclose(r0["metrics"][k], m[k], rtol=1e-5)
        for n, want in g.items():
            a = want.numpy()
            if n in noise:        # rounding noise (see `check`)
                assert max(np.abs(a).max(),
                           np.abs(r0["grads"][n]).max()) <= 2e-4 * gmax, n
            elif np.abs(a).max() > 0:
                rel = np.linalg.norm(r0["grads"][n] - a) / np.linalg.norm(a)
                assert rel <= 1e-4, (n, rel)
        bound = 2 * 3.2 * case["cfg"].train.lr
        for n, want in sd.items():
            d = (r0["sd"][n] - want).abs().max()
            if n.endswith(("running_mean", "running_var")):
                assert d <= 1e-5 * want.abs().max(), n
            assert d <= bound, n
    if variant == "global":
        assert all(torch.equal(r0["sd"][k], r1["sd"][k]) for k in r0["sd"])
        gate()
    else:
        with pytest.raises(AssertionError):
            gate()


def test_dp_eval_confusion_is_exact(runs):
    inp, out = runs
    ev = inp["eval"]
    cfg = jpresets.get("synthetic_tiny")
    model = jbuild(cfg.model)
    v = _variables(cfg, ev["batch"], 1)
    jstate = jsteps.create_train_state(cfg, model, v, 1)
    want = np.asarray(jsteps.make_eval_step(cfg, model)(
        jstate, {k: jnp.asarray(x) for k, x in ev["batch"].items()},
        jnp.asarray(ev["key"])))
    assert want.sum() == 8
    for o in out:
        np.testing.assert_array_equal(o["eval_cm"], want)


def test_mesh_serving_pads_as_jax_does(runs):
    """A mesh Predictor pads a batch of 3 to 4 as JAX's `Predictor(mesh=2)`
    does and serves every row under the padded batch's keys: JAX's served
    forward of the padded batch, its first 3 rows. A batch of 4 needs no
    padding. Every rank returns the whole batch."""
    inp, out = runs
    sv = inp["serve"]
    cfg = jpresets.get("synthetic_tiny_seg")
    v = _variables(cfg, make_batch(cfg, seed=5), 2)
    key = jnp.asarray(sv["key"])
    x4 = sv["xyz"]
    want4 = _jax_served(cfg, v, x4, np.ones(x4.shape[:2], bool), key)
    padded = np.concatenate([x4[:3], np.zeros_like(x4[:1])])
    pmask = np.ones(x4.shape[:2], bool)
    pmask[3] = False
    want3 = _jax_served(cfg, v, padded, pmask, key)[:3]
    for o in out:
        _close(o["serve"][4], want4, 1e-5)
        _close(o["serve"][3], want3, 1e-5)


def test_tier1_partition_matches_jax():
    cfg = jpresets.get("synthetic_tiny_seg")
    xyz, mask = _scene()
    mask[::7] = False
    ext = float(np.ptp(xyz, axis=0).max())
    assert tspatial.required_halo(to_port(cfg), ext) == \
        jspatial.required_halo(cfg, ext)
    for D, halo in ((2, 0.3), (3, 0.1), (4, 1.0)):
        cap = tspatial.suggest_capacity(xyz, mask, D, halo, round_to=128)
        assert cap == jspatial.suggest_capacity(xyz, mask, D, halo,
                                                round_to=128)
        for a, b in zip(tspatial.partition_scene(xyz, mask, D, halo, cap),
                        jspatial.partition_scene(xyz, mask, D, halo, cap)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="capacity"):
        tspatial.partition_scene(xyz, mask, 2, 0.3, 8)


def test_tier1_sharded_scene_apply_matches_jax(runs):
    """Tier 1 on a 1024-point scene, one slab per rank: the stitched
    logits equal JAX's `sharded_scene_apply` on its 2-device mesh (the
    unfolded eval forward, f32)."""
    inp, out = runs
    t1 = inp["tier1"]
    cfg = jpresets.get("synthetic_tiny_seg")
    model = jbuild(cfg.model)
    v = _variables(cfg, make_batch(cfg, seed=5), 2)
    key = jnp.asarray(t1["key"])
    fwd = jax.jit(lambda x, m: model.apply(v, x, None, m, train=False,
                                           rngs={"cagq": key}))
    xyz, mask = _scene()
    want = jspatial.sharded_scene_apply(
        fwd, xyz, mask, jmake_mesh(2), halo=t1["halo"],
        capacity=t1["capacity"], num_outputs=cfg.model.num_classes)
    for o in out:
        assert o["tier1"].shape == (len(xyz), cfg.model.num_classes)
        _close(o["tier1"], np.asarray(want), 1e-5)


def test_mesh_needs_a_process_group_and_a_divisible_batch():
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(2)
    m = pmesh.Mesh(group=None, size=2, rank=1, device=torch.device("cpu"))
    assert m.rows(6) == (3, 6)
    with pytest.raises(ValueError, match="does not shard"):
        m.rows(3)
    assert pmesh.backend_for(["cpu", "cpu"]) == "gloo"
    assert pmesh.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert pmesh.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    with pytest.raises(ValueError, match="CUDA devices"):
        pmesh.mesh_devices("cuda", torch.cuda.device_count() + 1)
