"""The port's resident spatial tiers (tier 2 `parallel.resident`, tier 3
`parallel.resident_ml`, `parallel.spatial_train`, the 2-D mesh and the
differentiable collectives) on a world-2 gloo mesh on the CPU, against
the JAX package's on a 2-device mesh (`make_mesh(2)`, `make_mesh2d(2, 1)`
and `make_mesh2d(1, 2)` from conftest's fake CPU devices).

One spawn of two workers for the module (`tests/torch_resident_worker.py`,
the port only) runs every port path on inputs written here from the JAX
package's random variables (converted), on synthetic_tiny_seg at 512
points cut into 2 slabs: every level has an interior face and non-empty
boundary bands. Each test then holds one result against JAX.

Gates: every shard's CAGQ center vids per layer, tier 3's ghost send
selections and overflow counters bit for bit; logits within 1e-5 of
their range (the f32 serving gate); the train steps at
`test_torch_train.check`'s gates with flax's statistics summed pairwise
(`pairwise_bn`).
"""

import concurrent.futures
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import gridgcn_tpu.models.gridconv as jgridconv
from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.models.build import build_model as jbuild
from gridgcn_tpu.ops.voxelize import grid_bounds as jgrid_bounds
from gridgcn_tpu.parallel import resident as jres
from gridgcn_tpu.parallel import resident_ml as jml
from gridgcn_tpu.parallel import spatial_train as jst
from gridgcn_tpu.parallel.mesh import DATA_AXIS, SPACE_AXIS
from gridgcn_tpu.parallel.mesh import make_mesh as jmake_mesh
from gridgcn_tpu.parallel.mesh import make_mesh2d as jmake_mesh2d
from gridgcn_tpu.train import steps as jsteps
from gridgcn_torch.models.build import build_model
from gridgcn_torch.parallel import mesh as pmesh
from gridgcn_torch.parallel import resident as tres
from gridgcn_torch.parallel import resident_ml as tml
from gridgcn_torch.parallel.launch import launch
from gridgcn_torch.train import steps as tsteps
from gridgcn_torch.utils.convert import convert_flax_variables
from tests import torch_resident_worker
from tests.test_torch_models import _random_variables, to_port
from tests.test_torch_train import check, with_model

torch.set_num_threads(1)

N = 512
KEY = jax.random.PRNGKey(7)


def _scene(seed, n=N):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 8, (n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[n - 32:] = False
    return xyz, mask


def _cfg(in_channels=0, dropout=0.0):
    return with_model(jpresets.get("synthetic_tiny_seg"),
                      in_channels=in_channels, dropout=dropout)


def _variables(cfg, xyz, seed=0):
    feat = (jnp.zeros((1, xyz.shape[0], cfg.model.in_channels))
            if cfg.model.in_channels else None)
    return _random_variables(jbuild(cfg.model), jnp.asarray(xyz[None]), feat,
                             jnp.ones((1, xyz.shape[0]), bool), seed=seed)


FORWARD = {      # name: (tier, in_channels, corrupt)
    "tier2": ("resident", 0, False),
    "tier2_feat": ("resident", 2, False),
    "tier2_corrupt": ("resident", 0, True),
    "tier3": ("resident_ml", 0, False),
    "tier3_feat": ("resident_ml", 2, False),
}
TRAIN = {        # name: (tier, mesh, scenes, dropout)
    "tier2": ("resident", "1d", 1, 0.5),
    "tier3": ("resident_ml", "1d", 1, 0.5),
    "tier3_2x1": ("resident_ml", "2x1", 2, 0.0),
    "tier3_1x2": ("resident_ml", "1x2", 2, 0.0),
}


def _forward_case(name):
    tier, c_in, corrupt = FORWARD[name]
    cfg = _cfg(c_in)
    xyz, mask = _scene(3)
    feat = (np.random.default_rng(4).normal(size=(N, c_in))
            .astype(np.float32) if c_in else None)
    return cfg, xyz, mask, feat, _variables(cfg, xyz)


def _train_case(name):
    tier, mesh, B, dropout = TRAIN[name]
    cfg = _cfg(dropout=dropout)
    scenes = [_scene(20 + b) for b in range(B)]
    xyz = np.stack([s[0] for s in scenes])
    mask = np.stack([s[1] for s in scenes])
    label = ((xyz[..., 0] > 4) * 2 + (xyz[..., 1] > 4)).astype(np.int32)
    return cfg, xyz, mask, label, _variables(cfg, xyz[0], seed=1)


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """The module's one spawn of the 2 port workers, started in a thread so
    that the JAX references are computed while they run; `.result()`
    joins it."""
    tmp = tmp_path_factory.mktemp("resident")
    inp = {"forward": {}, "train": {}}
    for name in FORWARD:
        cfg, xyz, mask, feat, v = _forward_case(name)
        inp["forward"][name] = dict(
            cfg=to_port(cfg), sd=convert_flax_variables(v), xyz=xyz,
            mask=mask, feat=feat, key=np.asarray(KEY), tier=FORWARD[name][0],
            corrupt=FORWARD[name][2])
    for name in TRAIN:
        cfg, xyz, mask, label, v = _train_case(name)
        inp["train"][name] = dict(
            cfg=to_port(cfg), sd=convert_flax_variables(v), xyz=xyz,
            mask=mask, label=label, key=np.asarray(KEY), spe=4, capacity=N,
            tier=TRAIN[name][0], mesh=TRAIN[name][1])
    cfg, xyz, mask, feat, v = _forward_case("tier3")
    scenes = np.stack([_scene(40 + b)[0] for b in range(2)])
    key = jax.random.PRNGKey(5)
    inp["scenes"] = dict(cfg=to_port(cfg), sd=convert_flax_variables(v),
                         xyz=scenes, key=np.asarray(key),
                         keys=np.asarray(jax.random.split(key, 2)),
                         key1=np.asarray(jax.random.split(key, 1)[0]))
    torch.save(inp, tmp / "inputs.pt")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    job = pool.submit(launch, torch_resident_worker.run,
                      pmesh.mesh_devices("cpu", 2), str(tmp / "inputs.pt"),
                      str(tmp), timeout_s=400)
    yield job, tmp, inp
    pool.shutdown()


@pytest.fixture(scope="module")
def runs(spawn, jax_forwards, jax_train):
    """The port workers' outputs, per rank (after the JAX references)."""
    job, tmp, inp = spawn
    job.result()
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    assert [o["rank"] for o in out] == [0, 1]
    return inp, out


def _close(got, want, frac=1e-5):
    scale = float(np.ptp(want))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale)


def _tree_mean(x):
    """Mean over every axis but the last, summed pairwise after one zero
    pad to a power of two (the sums of `test_torch_train._pairwise_mean`
    to rounding, in fewer operations: each level one reshape and one sum
    of pairs, which keeps the JAX reference's compile short)."""
    x = x.reshape(-1, x.shape[-1])
    n = x.shape[0]
    x = jnp.pad(x, ((0, (1 << max(0, (n - 1).bit_length())) - n), (0, 0)))
    while x.shape[0] > 1:
        x = x.reshape(-1, 2, x.shape[-1]).sum(1)
    return x[0] / n


def _compute_stats_tree(x, axes, dtype, axis_name=None,
                        axis_index_groups=None, use_mean=True,
                        use_fast_variance=True, mask=None,
                        force_float32_reductions=True):
    """flax's `_compute_stats` as the models call it, its means summed
    pairwise (`_tree_mean`; see `test_torch_train.pairwise_bn`)."""
    assert mask is None and axis_name is None and use_mean
    assert tuple(axes) == tuple(range(x.ndim - 1))
    x = x.astype(jnp.promote_types(dtype or x.dtype, jnp.float32))
    mu, mu2 = _tree_mean(x), _tree_mean(x * x)
    return mu, jnp.maximum(0.0, mu2 - mu * mu)


class _Recorder:
    """The JAX package's CAGQ center vids and tier-3 send selections,
    per shard in call order, recorded from inside its shard_map with
    `jax.debug.callback`."""

    def __init__(self, monkeypatch):
        self.vids = {0: [], 1: []}
        self.sends = {0: [], 1: []}
        cagq, exch = jgridconv.cagq, jml.exchange_boundary

        def cagq_rec(xyz, mask, spec, *a, **k):
            out = cagq(xyz, mask, spec, *a, **k)
            jax.debug.callback(
                lambda d, v, ok: self.vids[int(d)].append(
                    (spec.resolution, np.asarray(v)[0], np.asarray(ok)[0])),
                jax.lax.axis_index(DATA_AXIS), out.groups.center_vids,
                out.groups.center_valid)
            return out

        def exch_rec(*a, **k):
            out = exch(*a, **k)
            (ir, okr), (il, okl) = out[3]
            jax.debug.callback(
                lambda d, *t: self.sends[int(d)].append(
                    tuple(np.asarray(x) for x in t[:4]) + (int(t[4]),)),
                jax.lax.axis_index(a[-1]), ir, okr, il, okl, out[4])
            return out

        monkeypatch.setattr(jgridconv, "cagq", cagq_rec)
        monkeypatch.setattr(jml, "exchange_boundary", exch_rec)


@pytest.fixture(scope="module")
def jax_forwards(spawn):
    """Each forward case through the JAX package's predict function on
    its 2-device mesh: {name: (logits, recorder)}."""
    out = {}
    mesh = jmake_mesh(2)
    for name, (tier, _, corrupt) in FORWARD.items():
        cfg, xyz, mask, feat, v = _forward_case(name)
        with pytest.MonkeyPatch.context() as mp:
            rec = _Recorder(mp)
            if tier == "resident":
                fwd = jres.make_resident_forward(cfg, mesh,
                                                 _corrupt_gather=corrupt)
                lg = jres.resident_seg_predict(cfg, v, xyz, mask, mesh,
                                               rng=KEY, fwd=fwd, feat=feat)
            else:
                lg = jml.resident_ml_seg_predict(cfg, v, xyz, mask, mesh,
                                                 rng=KEY, feat=feat)
            jax.effects_barrier()
        out[name] = (np.asarray(lg), rec)
    return out


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_forward_matches_jax(runs, jax_forwards, name):
    """Eval forwards (f32, unfolded): each shard's center vids per layer
    bit for bit, tier 3's send selections and dropped counts bit for bit,
    and the stitched logits within 1e-5 of the range on every rank."""
    _, out = runs
    want, rec = jax_forwards[name]
    for o in out:
        _close(o["forward"][name]["logits"], want)
    for d, o in enumerate(out):
        got = o["forward"][name]
        assert len(got["vids"]) == len(rec.vids[d]) == 2
        for (r1, v1, ok1), (r2, v2, ok2) in zip(got["vids"], rec.vids[d]):
            assert r1 == r2
            np.testing.assert_array_equal(ok1, ok2)
            np.testing.assert_array_equal(v1[ok1], v2[ok2])
        assert len(got["sends"]) == len(rec.sends[d])
        for a, b in zip(got["sends"], rec.sends[d]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert not got["warnings"]
    if name.startswith("tier3"):
        assert any(s[1].any() or s[3].any() for s in rec.sends[0])


def test_corrupt_gather_moves_the_logits(jax_forwards):
    """The mis-assembled level (`_corrupt_gather`) changes the answer, in
    both packages alike (held above)."""
    a, b = jax_forwards["tier2"][0], jax_forwards["tier2_corrupt"][0]
    assert np.abs(a - b).max() > 1e-2 * np.ptp(a)


def test_tier3_refreshed_ghosts_are_the_owners_rows(runs):
    """Inside the tier-3 forward (debug_capture), after every decoder
    ghost refresh each valid ghost row's features are the owning rank's
    row for the same position, bit for bit (`tests/test_spatial.py`'s
    protocol gate)."""
    _, out = runs
    caps = [o["capture"]["captures"] for o in out]
    assert all(o["capture"]["overflow"] == 0 for o in out)
    assert caps[0]
    n = 0
    for stage in range(len(caps[0])):
        owners = {}
        for d in range(2):
            xyz, feat, valid, owned = caps[d][stage]
            for r in np.nonzero(valid & owned)[0]:
                owners[xyz[r].tobytes()] = (d, feat[r])
        for d in range(2):
            xyz, feat, valid, owned = caps[d][stage]
            for r in np.nonzero(valid & ~owned)[0]:
                od, row = owners[xyz[r].tobytes()]
                assert od != d
                np.testing.assert_array_equal(feat[r], row)
                n += 1
    assert n > 0


def _jax_spatial_grads(cfg, mesh, state, batch, key, tier, batch_axis):
    """The gradients, loss, accuracy, statistics and overflow of JAX's
    spatial train step (`spatial_train.make_spatial_train_step`'s
    loss function, jitted)."""
    if tier == "resident":
        fwd = jres.make_resident_forward(cfg, mesh, train=True)
    elif batch_axis is None:
        fwd = jml.make_resident_ml_forward(cfg, mesh, train=True)
    else:
        fwd = jml.make_resident_ml_forward(cfg, mesh, train=True,
                                           axis_name=SPACE_AXIS,
                                           batch_axis=batch_axis)
    nc = cfg.model.num_classes

    def loss_fn(params, key):
        v = {"params": params, "batch_stats": state.batch_stats}
        if tier == "resident":
            logits, stats = fwd(v, batch["sx"], batch["sm"], batch["edges"],
                                batch["origin"], batch["vsize"], key)
            overflow = jnp.zeros((), jnp.int32)
        else:
            logits, overflow, stats = fwd(
                v, batch["sx"], batch["sm"], batch["edges"], batch["origin"],
                batch["extent"], key)
            overflow = jnp.sum(overflow)
        logits = logits.astype(jnp.float32)
        onehot = jax.nn.one_hot(batch["label"], nc, dtype=logits.dtype)
        ce = optax.softmax_cross_entropy(logits, onehot)
        owned = batch["owned"]
        w = owned.astype(ce.dtype)
        loss = jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1e-6)
        acc = jnp.sum(jnp.where(owned, jnp.argmax(logits, -1)
                                == batch["label"], False)) \
            / jnp.maximum(jnp.sum(owned), 1)
        return loss, (acc, stats, overflow)

    key = jax.random.fold_in(key, state.step)
    if batch_axis is not None:
        key = jax.random.split(key, batch["sx"].shape[0])
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params, key)


@pytest.fixture(scope="module")
def jax_train(spawn):
    """Each train case's JAX step: {name: (pair, metrics, grads, before)}
    with `pair` what `check` reads."""
    out = {}
    meshes = {"1d": lambda: jmake_mesh(2),
              "2x1": lambda: jmake_mesh2d(2, 1),
              "1x2": lambda: jmake_mesh2d(1, 2)}
    with pytest.MonkeyPatch.context() as mp:
        import flax.linen.normalization as normalization
        mp.setattr(normalization, "_compute_stats", _compute_stats_tree)
        for name, (tier, m, B, _) in TRAIN.items():
            cfg, xyz, mask, label, v = _train_case(name)
            before = {k: t.clone() for k, t in
                      convert_flax_variables(v).items()}
            mesh = meshes[m]()
            state = jsteps.create_train_state(cfg, jbuild(cfg.model), v, 4)
            _, sched = jsteps.make_optimizer(cfg, 4)
            if m == "1d":
                batch = jst.shard_scene_batch(cfg, xyz[0], label[0], mask[0],
                                              mesh, N)
                axis = None
            else:
                batch = jst.shard_scene_batches(cfg, xyz, label, mask, mesh,
                                                N)
                axis = DATA_AXIS
            (loss, (acc, stats, overflow)), g = jax.device_get(
                _jax_spatial_grads(cfg, mesh, state, batch, KEY, tier, axis))
            # one compiled update (eager optax on the mesh's arrays would
            # compile each small operation); _merge_stats merges in place,
            # so it gets a copy of the containers
            new = jax.jit(lambda s, g_: s.apply_gradients(grads=g_))(
                state, g)
            new = new.replace(batch_stats=jres._merge_stats(
                jax.tree.map(lambda x: x, new.batch_stats), stats))
            pcfg = to_port(cfg)
            pair = types.SimpleNamespace(cfg=pcfg, jstate=new)
            pair.pstate = tsteps.create_train_state(
                pcfg, build_model(pcfg.model), convert_flax_variables(v), 4,
                device="cpu")
            pair.names = [n for n, _ in
                          pair.pstate.model.named_parameters()]
            pair.flat = lambda tree, p=pair, s=state: {
                n: t.numpy() for n, t in convert_flax_variables({
                    "params": jax.tree.map(np.asarray, tree),
                    "batch_stats": jax.tree.map(np.asarray,
                                                s.batch_stats)}).items()
                if n in p.names}
            gn = np.sqrt(sum(np.sum(np.square(x, dtype=np.float64))
                             for x in jax.tree.leaves(g)))
            jm = {"loss": loss, "acc": acc, "grad_norm": gn,
                  "lr": sched(new.step), "ghost_overflow": overflow}
            out[name] = (pair, jm, pair.flat(g), before)
    return out


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_spatial_train_step_matches_jax(runs, jax_train, name):
    """One spatial train step per tier and mesh shape: loss, accuracy,
    gradient norm and lr 1e-5 relative, gradients 1e-4 relative L2,
    parameters and BatchNorm running statistics 1e-5 of their scale where
    determined (`check`); both ranks end bit for bit alike; tier 3
    overflows nothing."""
    _, out = runs
    pair, jm, jg, before = jax_train[name]
    r0, r1 = (o["train"][name] for o in out)
    for k in r0["sd"]:
        assert torch.equal(r0["sd"][k], r1["sd"][k]), k
    assert r0["metrics"] == r1["metrics"]
    if TRAIN[name][0] == "resident_ml":
        assert r0["metrics"]["ghost_overflow"] == int(jm["ghost_overflow"]) \
            == 0
    pair.pstate.model.load_state_dict(r0["sd"])
    check(pair, dict(jm=jm, pm=r0["metrics"], jg=jg, pg=r0["grads"],
                     before=before))


def test_global_batch_statistics_fail_the_gate(runs, jax_train):
    """The tiers normalise each shard with its own statistics, as a flax
    BatchNorm without an axis name does inside shard_map: the port's
    tier-2 step with every BatchNorm's sums all-reduced over the ring (the
    DP step's global statistics, `batch_stats_over`) misses JAX's
    gradients by far more than the gate."""
    _, out = runs
    pair, _, jg, _ = jax_train["tier2"]
    got = out[0]["train"]["tier2_global_bn"]["grads"]
    noise = tsteps.noise_gradient_params(pair.cfg, pair.names)
    rel = max(np.linalg.norm(got[n] - jg[n]) / np.linalg.norm(jg[n])
              for n in pair.names if n not in noise and np.abs(jg[n]).max())
    assert rel > 1e-2, rel


def test_primitives(runs):
    """exchange_halo_planes as `tests/test_spatial.py:48` holds it (each
    rank's ghost planes its neighbours' boundary planes, zeros at the grid
    ends); exchange_boundary's ghosts and refresh_ghosts' rows the
    sender's rows bit for bit; the gradients of all_gather (the summed
    cotangent's chunk) and of shift (the reverse shift)."""
    _, out = runs
    p = [o["primitives"] for o in out]
    (l0, r0, a0), (l1, r1, a1) = p[0]["halo"], p[1]["halo"]
    np.testing.assert_array_equal(l0, 0)
    np.testing.assert_array_equal(r0, a1[:1])
    np.testing.assert_array_equal(l1, a0[-1:])
    np.testing.assert_array_equal(r1, 0)
    n = 0
    for d in range(2):
        b, other = p[d]["boundary"], p[1 - d]["boundary"]
        assert b["dropped"] == 0
        rows = {other["xyz"][r].tobytes(): r
                for r in np.nonzero(other["valid"])[0]}
        for r in np.nonzero(b["g_ok"])[0]:
            src = rows[b["g_xyz"][r].tobytes()]
            np.testing.assert_array_equal(b["g_new"][r], other["upd"][src])
            n += 1
        # rank 0's left and rank 1's right ghosts are the grid's ends
        H = b["H"]
        assert not b["g_ok"][:H].any() if d == 0 else \
            not b["g_ok"][H:].any()
    assert n > 0
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(p[0]["grad_gather"], 3 * w[:2])
    np.testing.assert_array_equal(p[1]["grad_gather"], 3 * w[2:])
    np.testing.assert_array_equal(p[0]["grad_shift"], np.full(3, 3.0))
    np.testing.assert_array_equal(p[1]["grad_shift"], np.zeros(3))
    # the summed cotangent in its own dtype: (1 + eps) + (1 + 2 eps)
    for d in range(2):
        t = p[d]["grad_gather_typed"]
        assert t["torch.float64"][0] and t["torch.bfloat16"][0]
        np.testing.assert_array_equal(t["torch.float64"][1],
                                      [2.0 + 3 * 2.0 ** -40])
        want = torch.tensor(2.0 + 3 * 2.0 ** -7).bfloat16().double()
        np.testing.assert_array_equal(t["torch.bfloat16"][1], [float(want)])


def test_predict_scenes_is_per_scene_tier3(runs):
    """Scene batching on the 2×1 mesh (each scene on a ring of one rank)
    equals each scene's 1-D tier-3 forward on that ring under key row b of
    split(key, 2), at one capacity, within 1e-5 of the range; a mesh
    Predictor's predict_scenes is that function (2 scenes: 2×1), and with
    one scene (1×2) the 1-D predict_scene(spatial="resident_ml") under
    split(key, 1)[0]; "auto" takes tier 3 (every layer's n_centers
    divides 2)."""
    _, out = runs
    for r, o in enumerate(out):
        sc = o["scenes"]
        assert sc["2x1"].shape == (2, N, 4)
        _close(sc["2x1"][r], sc["2x1_single"])
        np.testing.assert_array_equal(sc["api_2"], sc["api_2_direct"])
        _close(sc["api_1"][0], sc["api_1_single"])
        np.testing.assert_array_equal(sc["auto"], sc["ml"])


def test_error_paths(runs):
    """As `tests/test_spatial.py:527`: a 2-D mesh larger than the group, a
    1-D mesh where a 2-D one is needed, a scene count that the data axis
    does not divide, missing features, ghost_cap="auto" with a prebuilt
    forward, debug_capture on the batched forward, scene-batched tier 2."""
    _, out = runs
    want = {"mesh2d_too_large": "devices are available",
            "scenes_on_1d": "mesh", "scenes_not_divisible": "not divisible",
            "scenes_need_feats": "feats", "predict_needs_feat": "feat",
            "auto_with_fwd": "prebuilt fwd",
            "batched_debug_capture": "debug_capture",
            "train_2d_tier2": "tier-3", "batches_on_1d": "mesh",
            "batches_not_divisible": "not divisible"}
    for o in out:
        for name, frag in want.items():
            msg = o["errors"][name]
            assert msg is not None and frag in msg, (name, msg)


def test_host_functions_match_jax():
    """resident_halo, ghost_band_widths, calibrate_ghost_cap,
    _band_index and the scene grid, value for value, without a mesh."""
    cfg = _cfg()
    pcfg = to_port(cfg)
    for seed in (3, 5):
        xyz, mask = _scene(seed, 1024)
        o, v = jgrid_bounds(jnp.asarray(xyz)[None], jnp.asarray(mask)[None],
                            cfg.model.layers[0].resolution)
        to, tv = tres.scene_bounds(xyz, mask, cfg.model.layers[0].resolution)
        np.testing.assert_array_equal(np.asarray(o)[0], to)
        np.testing.assert_array_equal(np.asarray(v)[0], tv)
        assert tres.resident_halo(pcfg, tv) == jres.resident_halo(cfg, tv)
        extent = tv * 8 / (1.0 + 1e-5)
        assert tml.ghost_band_widths(pcfg, extent) == \
            jml.ghost_band_widths(cfg, extent)
        for D in (2, 4):
            for safety in (0.5, 2.0):
                assert tml.calibrate_ghost_cap(pcfg, xyz, mask, D, safety) \
                    == jml.calibrate_ghost_cap(cfg, xyz, mask, D, safety)
    rng = np.random.default_rng(0)
    for M, H, p in ((40, 8, 0.3), (40, 8, 0.05), (16, 4, 0.9)):
        x = rng.uniform(size=M).astype(np.float32)
        sel = rng.uniform(size=M) < p
        a = jml._band_index(jnp.asarray(x), jnp.asarray(sel), H)
        b = tml._band_index(torch.as_tensor(x), torch.as_tensor(sel), H)
        for y, z in zip(a, b):
            np.testing.assert_array_equal(np.asarray(y), z.numpy())
