"""One rank of the gloo mesh that `tests/test_torch_resident.py` starts on
the CPU (`parallel.launch`): it runs the port's resident tiers on the
inputs the test wrote (forwards, train steps, primitives, scene batching,
error paths) and saves what each returned for the test to hold against
the JAX package. Imports the port only."""

import contextlib
import warnings

import numpy as np
import torch

import gridgcn_torch.models.gridconv as gridconv
from gridgcn_torch.api import Predictor
from gridgcn_torch.models.build import build_model
from gridgcn_torch.models.layers import batch_stats_over
from gridgcn_torch.parallel import resident_ml
from gridgcn_torch.parallel.mesh import (
    DATA_AXIS, SPACE_AXIS, all_gather, make_mesh, make_mesh2d, mesh_devices,
    shift)
from gridgcn_torch.parallel.resident import (
    make_resident_forward, resident_seg_predict)
from gridgcn_torch.parallel.resident_ml import (
    exchange_boundary, make_resident_ml_forward, refresh_ghosts,
    resident_ml_seg_predict, resident_ml_seg_predict_scenes)
from gridgcn_torch.parallel.spatial import exchange_halo_planes
from gridgcn_torch.parallel.spatial_train import (
    make_spatial_train_step, shard_scene_batch, shard_scene_batches)
from gridgcn_torch.train import steps


@contextlib.contextmanager
def _recording():
    """Records every CAGQ call's (resolution, center_vids, center_valid)
    and every exchange_boundary's send selections and dropped count, in
    call order."""
    rec = {"vids": [], "sends": []}
    cagq, exch = gridconv.cagq, resident_ml.exchange_boundary

    def cagq_rec(xyz, mask, spec, *a, **k):
        out = cagq(xyz, mask, spec, *a, **k)
        rec["vids"].append((spec.resolution,
                            out.groups.center_vids[0].numpy().copy(),
                            out.groups.center_valid[0].numpy().copy()))
        return out

    def exch_rec(*a, **k):
        out = exch(*a, **k)
        (ir, okr), (il, okl) = out[3]
        rec["sends"].append(tuple(t.numpy().copy() for t in
                                  (ir, okr, il, okl)) + (int(out[4]),))
        return out

    gridconv.cagq, resident_ml.exchange_boundary = cagq_rec, exch_rec
    try:
        yield rec
    finally:
        gridconv.cagq, resident_ml.exchange_boundary = cagq, exch


def _model(case):
    model = build_model(case["cfg"].model)
    model.load_state_dict(case["sd"])
    return model.eval()


def _forwards(inp, mesh):
    out = {}
    for name, case in inp["forward"].items():
        cfg, model = case["cfg"], _model(case)
        predict = (resident_seg_predict if case["tier"] == "resident"
                   else resident_ml_seg_predict)
        kw = {}
        if case.get("corrupt"):
            kw["fwd"] = make_resident_forward(cfg, mesh, _corrupt_gather=True)
        with _recording() as rec, warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            logits = predict(cfg, model, case["xyz"], case["mask"], mesh,
                             rng=case["key"], feat=case.get("feat"), **kw)
        out[name] = {"logits": logits, "vids": rec["vids"],
                     "sends": rec["sends"],
                     "warnings": [str(x.message) for x in w]}
    return out


def _debug_capture(inp, mesh):
    """Tier 3's post-refresh levels (debug_capture) on this rank, and the
    overflow."""
    case = inp["forward"]["tier3"]
    cfg, model = case["cfg"], _model(case)
    from gridgcn_torch.parallel.resident import scene_bounds, resident_halo
    from gridgcn_torch.parallel.spatial import partition_scene, \
        suggest_capacity
    xyz, mask = case["xyz"], case["mask"]
    res0 = cfg.model.layers[0].resolution
    origin, vsize = scene_bounds(xyz, mask, res0)
    halo = resident_halo(cfg, vsize)
    sx, sm, _, _, edges = partition_scene(
        xyz, mask, mesh.size, halo, suggest_capacity(xyz, mask, mesh.size,
                                                     halo))
    fwd = make_resident_ml_forward(cfg, mesh, debug_capture=True)
    d = mesh.rank
    with torch.no_grad():
        _, overflow, caps = fwd(model, torch.as_tensor(sx[d:d + 1]),
                                torch.as_tensor(sm[d:d + 1]), edges, origin,
                                vsize * res0 / (1.0 + 1e-5), case["key"])
    return {"overflow": int(overflow.sum()),
            "captures": [tuple(t[0].float().numpy() if t.is_floating_point()
                               else t[0].numpy() for t in c) for c in caps]}


def _train(inp, mesh2d):
    out = {}
    for name, case in inp["train"].items():
        out[name] = _train_step(case, mesh2d)
    # tier 2 with the DP step's global statistics: every BatchNorm's sums
    # all-reduced over the ring
    out["tier2_global_bn"] = _train_step(inp["train"]["tier2"], mesh2d,
                                         global_bn=True)
    return out


def _train_step(case, mesh2d, global_bn=False):
    cfg = case["cfg"]
    state = steps.create_train_state(cfg, build_model(cfg.model),
                                     case["sd"], case["spe"],
                                     device="cpu")
    grads = []
    update = state.tx.update
    state.tx.update = lambda g, norm: (
        grads.append([x.clone() for x in g]), update(g, norm))[1]
    m = mesh2d[case["mesh"]]
    if case["mesh"] == "1d":
        batch = shard_scene_batch(cfg, case["xyz"][0], case["label"][0],
                                  case["mask"][0], m, case["capacity"])
        step = make_spatial_train_step(cfg, m, tier=case["tier"])
    else:
        batch = shard_scene_batches(cfg, case["xyz"], case["label"],
                                    case["mask"], m, case["capacity"])
        step = make_spatial_train_step(cfg, m, tier="resident_ml",
                                       batch_axis=DATA_AXIS)
    with batch_stats_over(state.model, m.group if global_bn else None):
        state, metrics = step(state, batch, case["key"])
    names = [n for n, _ in state.model.named_parameters()]
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: g.numpy() for n, g in zip(names, grads[0])},
        "sd": {k: v.clone() for k, v in state.model.state_dict().items()}}


def _primitives(mesh):
    """exchange_halo_planes on a [4, 3] slab per rank; exchange_boundary
    and refresh_ghosts on inputs seeded by rank; the gradients of
    all_gather and shift."""
    d = mesh.rank
    local = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 100 * d
    lg, rg = exchange_halo_planes(local, mesh)
    rng = np.random.default_rng(11 + d)
    M, H, C = 32, 16, 5
    x = np.zeros((M, 3), np.float32)
    x[:, 0] = rng.uniform(d, d + 1, M)
    feat = torch.as_tensor(rng.normal(size=(M, C)).astype(np.float32))
    valid = torch.as_tensor(rng.uniform(size=M) > 0.1)
    xyz = torch.as_tensor(x)
    g_xyz, g_feat, g_ok, send, dropped = exchange_boundary(
        xyz, feat, valid, torch.tensor(float(d)), torch.tensor(d + 1.0),
        torch.tensor(0.3), H, mesh)
    upd = torch.sin(feat * 3.0) + xyz[:, :1]
    g_new = refresh_ghosts(upd, send, mesh)
    # gradients: d/dx of sum(w · all_gather(x)) is this rank's chunk of
    # Σ_ranks w; of sum(w · shift(x, +1)), the right neighbour's w
    a = torch.full((2, 3), float(d + 1), requires_grad=True)
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3) * (d + 1)
    (ga,) = torch.autograd.grad((all_gather(a, mesh) * w).sum(), a)
    b = torch.ones(3, requires_grad=True)
    (gb,) = torch.autograd.grad((shift(b, mesh, 1) * (d + 2.0)).sum(), b)
    # all_gather's cotangents are summed in their own dtype: float64 keeps
    # the 2^-40 that float32 would round away, bfloat16 stays bfloat16
    typed = {}
    for dt, eps in ((torch.float64, 2.0 ** -40), (torch.bfloat16, 2.0 ** -7)):
        a = torch.zeros(1, dtype=dt, requires_grad=True)
        w = torch.full((2,), 1.0 + (d + 1) * eps, dtype=dt)
        (g,) = torch.autograd.grad((all_gather(a, mesh) * w).sum(), a)
        typed[str(dt)] = (g.dtype == dt, g.double().numpy())
    return {"halo": (lg.numpy(), rg.numpy(), local.numpy()),
            "boundary": dict(xyz=x, valid=valid.numpy(), upd=upd.numpy(),
                             g_xyz=g_xyz.numpy(), g_new=g_new.numpy(),
                             g_ok=g_ok.numpy(), dropped=int(dropped), H=H),
            "grad_gather": ga.numpy(), "grad_shift": gb.numpy(),
            "grad_gather_typed": typed}


def _errors(inp, mesh, mesh2d):
    """The messages of the misuses that must raise."""
    case = inp["forward"]["tier3"]
    cfg, model = case["cfg"], _model(case)
    xyz = np.zeros((2, 64, 3), np.float32)
    masks = np.ones((2, 64), bool)
    tries = {
        "mesh2d_too_large": lambda: make_mesh2d(2, 2),
        "scenes_on_1d": lambda: resident_ml_seg_predict_scenes(
            cfg, model, xyz, masks, mesh),
        "scenes_not_divisible": lambda: resident_ml_seg_predict_scenes(
            cfg, model, xyz[:1], masks[:1], mesh2d["2x1"]),
        "scenes_need_feats": lambda: resident_ml_seg_predict_scenes(
            inp["forward"]["tier3_feat"]["cfg"], model, xyz, masks,
            mesh2d["2x1"]),
        "predict_needs_feat": lambda: resident_ml_seg_predict(
            inp["forward"]["tier3_feat"]["cfg"], model, case["xyz"],
            case["mask"], mesh),
        "auto_with_fwd": lambda: resident_ml_seg_predict(
            cfg, model, case["xyz"], case["mask"], mesh, ghost_cap="auto",
            fwd=make_resident_ml_forward(cfg, mesh)),
        "batched_debug_capture": lambda: make_resident_ml_forward(
            cfg, mesh2d["2x1"], batch_axis=DATA_AXIS, debug_capture=True),
        "train_2d_tier2": lambda: make_spatial_train_step(
            cfg, mesh2d["2x1"], tier="resident", batch_axis=DATA_AXIS),
        "batches_on_1d": lambda: shard_scene_batches(
            cfg, xyz, np.zeros((2, 64), np.int32), masks, mesh),
        "batches_not_divisible": lambda: shard_scene_batches(
            cfg, xyz[:1], np.zeros((1, 64), np.int32), masks[:1],
            mesh2d["2x1"]),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _scenes(inp, mesh, mesh2d):
    """Scene batching: resident_ml_seg_predict_scenes on the 2×1 mesh (a
    scene per rank, each on a ring of one) and this rank's scene on its
    ring alone, at one capacity; a mesh Predictor's predict_scenes on both
    shapes (2 scenes: 2×1; 1 scene: 1×2) beside the functions they call;
    predict_scene(spatial="auto")."""
    sc = inp["scenes"]
    cfg, xyz, key, keys = sc["cfg"], sc["xyz"], sc["key"], sc["keys"]
    pred = Predictor(cfg, sc["sd"], device="cpu", mesh=mesh)
    model, r, n = pred._model, mesh.rank, xyz.shape[1]
    masks = np.ones(xyz.shape[:2], bool)
    ring = mesh2d["2x1"].axis(SPACE_AXIS)
    return {
        "2x1": resident_ml_seg_predict_scenes(cfg, model, xyz, masks,
                                              mesh2d["2x1"], capacity=n,
                                              rng=key),
        "2x1_single": resident_ml_seg_predict(cfg, model, xyz[r], masks[r],
                                              ring, capacity=n, rng=keys[r]),
        "api_2": pred.predict_scenes(xyz, rng=key),
        "api_2_direct": resident_ml_seg_predict_scenes(
            cfg, model, xyz, masks, mesh2d["2x1"], rng=key),
        "api_1": pred.predict_scenes(xyz[:1], rng=key),
        "api_1_single": pred.predict_scene(xyz[0], spatial="resident_ml",
                                           rng=sc["key1"]),
        "auto": pred.predict_scene(xyz[0], spatial="auto", rng=keys[0]),
        "ml": pred.predict_scene(xyz[0], spatial="resident_ml", rng=keys[0])}


def run(inputs_path: str, out_dir: str):
    torch.set_num_threads(1)
    inp = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh(2, mesh_devices("cpu", 2))
    mesh2d = {"1d": mesh, "2x1": make_mesh2d(2, 1), "1x2": make_mesh2d(1, 2)}
    assert mesh2d["1x2"].axis(SPACE_AXIS).size == 2
    out = {"rank": mesh.rank,
           "forward": _forwards(inp, mesh),
           "capture": _debug_capture(inp, mesh),
           "train": _train(inp, mesh2d),
           "primitives": _primitives(mesh),
           "scenes": _scenes(inp, mesh, mesh2d),
           "errors": _errors(inp, mesh, mesh2d)}
    torch.save(out, f"{out_dir}/rank{mesh.rank}.pt")


def cli(tmp: str, over: list, odd_cfg):
    """The spatial CLIs on both ranks: `train --spatial resident` for two
    epochs from the step-0 checkpoint in tmp/port, then again without its
    last checkpoint (resumed from epoch 0's);
    `train_spatial(tier="resident_ml", scene_batch=2)` (rank 0 returns
    its schedule's values); `evaluate --whole-scene --mesh 2` with
    --resident, --resident-ml, and --scene-batch 2 on a checkpoint of
    `odd_cfg`, whose layer-1 n_centers the mesh does not divide."""
    import os

    import torch.distributed as dist

    from gridgcn_torch.configs import presets
    from gridgcn_torch.configs.base import apply_overrides, \
        parse_cli_overrides
    from gridgcn_torch.train import evaluate, train
    from gridgcn_torch.train.steps import make_lr_schedule
    from gridgcn_torch.utils import jaxrng
    from gridgcn_torch.utils.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    common = ["--preset", "synthetic_tiny_seg", "--device", "cpu", "--mesh",
              "2", "--spatial", "resident"]
    ck = f"train.ckpt_dir={tmp}/port"
    train.main([*common, "--log", f"{tmp}/t2.jsonl", *over, ck])
    # a run that stopped after epoch 0: its last checkpoint gone
    if dist.get_rank() == 0:
        os.remove(f"{tmp}/port/ckpt-8.pt")
    dist.barrier()
    train.main([*common, "--log", f"{tmp}/t2_resume.jsonl", *over, ck])

    cfg = apply_overrides(presets.get("synthetic_tiny_seg"),
                          {**parse_cli_overrides(over),
                           "train.ckpt_dir": f"{tmp}/scene_batch"})
    state = train.train_spatial(cfg, 2, log_path=f"{tmp}/t3_sb.jsonl",
                                tier="resident_ml", scene_batch=2,
                                device="cpu")
    sched = [float(state.tx.sched(k)) for k in range(8)]
    want = make_lr_schedule(cfg, 2)            # 4 scenes // B = 2
    out = {"sched": sched, "want": [float(want(k)) for k in range(8)],
           "jax_sized": [float(make_lr_schedule(cfg, 4)(k))
                         for k in range(8)],
           "steps": state.step}

    ev = ["--ckpt-dir", f"{tmp}/port", "--device", "cpu", "--whole-scene",
          "--mesh", "2", "--votes", "1"]
    evaluate.main([*ev, "--resident", "--log", f"{tmp}/e2.jsonl"])
    evaluate.main([*ev, "--resident-ml", "--log", f"{tmp}/e3.jsonl"])
    if dist.get_rank() == 0:
        model = build_model(odd_cfg.model)
        st = steps.create_train_state(odd_cfg, model, model.state_dict(), 1,
                                      device="cpu")
        CheckpointManager(f"{tmp}/odd", odd_cfg).save(
            0, st, jaxrng.PRNGKey(0))
    dist.barrier()
    ev[1] = f"{tmp}/odd"
    evaluate.main([*ev, "--resident-ml", "--scene-batch", "2", "--log",
                   f"{tmp}/e3_sb.jsonl"])
    return out
