"""The zero-communication point of the scaling audit on the card (the
port's counterpart of `scripts/study_mesh1_overhead.py`).

Tiers 2 and 3 (`gridgcn_torch/parallel/resident.py`, `resident_ml.py`)
on a mesh of ONE rank (a one-rank process group: NCCL on the card, gloo
on the CPU) against the plain unsharded program on the same whole scene.
At one rank every exchange is a copy to itself and tier 3's boundary
bands are empty, so its ghost buffers are pure padding: any gap over the
plain program is protocol overhead, and sweeping the ghost caps prices
the ghost rows. The audit's ghost-compute tax
(`gridgcn_torch.parallel.comm_audit.ghost_compute_tax`) is the affine
least-squares fit of that overhead against the ghost/owned row ratio
`Σ 2·cap / Σ n_centers`.

Eval mode (default preset `scannet_whole_scene`) times, on one
`synthetic_scene_surface` scene of seed 7 under key 0, BatchNorm folded
in the preset's dtype: the plain forward; tier 3 at full-share caps
(ratio 2); with `--ghost-sweep` tier 3 at caps max(8, n_centers // div)
for div 2, 4, 8 and the fit; then tier 2. `--train` (default preset
`scannet_seg`, its batch as one scene of batch × num_points points, as
the reference's study) times the plain single-device train step
(`train/steps.py`: loss, backward, Adam) against the tier-3 spatial train
step (`parallel/spatial_train.py`) on the same model, scene and
optimizer, over the same caps: the train fit.

    python scripts/study_mesh1_overhead_torch.py [--iters 20]
        [--ghost-sweep] [--train] [--preset NAME] [--device cuda|cpu]
        [--trace-dir build/study_mesh1_overhead]

Every number that feeds a ratio is device-busy ms per call
(`utils.profiling.busy_ms_per_iter` on a trace of `--iters` calls); the
CUDA-events time of `--iters` calls after 2 warm-up calls is printed
beside it and never stands in for it. torch's profiler drops device
records in a process that has traced a lot (`utils.profiling.trace`), so
on the card the variants run and trace in fresh processes, three eval
variants or one train variant a process (`PER_PROCESS`); a trace that
lost records is refused, never read, and its process is run again (at
most twice; the count is printed, with each process's seconds). The last line is `MESH1_OVERHEAD {json}`. On the CPU the busy
values, overheads and fit are null; the host-clock times and their fit
(`fit_wall`) are printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SWEEP_DIVS = (2, 4, 8)
RETAKES = 2
# variants (each one trace) per fresh process on the card. torch's
# profiler drops device records in a process that has traced a few tens
# of thousands of device events: on the H100 three eval traces of 5
# whole-scene forwards (~14.5k kernel launches each) kept all, while a
# second trace of 5 whole-scene train steps (~24.8k each) lost 31-52
# records; a process also costs ~25 s of start and first use
PER_PROCESS = {"eval": 3, "train": 1}


def affine_fit(ratios, overheads) -> dict:
    """Least squares overhead ≈ fixed + coeff · ratio: {"fixed", "coeff",
    "rms_residual"}."""
    r = np.asarray(ratios, np.float64)
    y = np.asarray(overheads, np.float64)
    A = np.stack([np.ones_like(r), r], axis=1)
    (fixed, coeff), *_ = np.linalg.lstsq(A, y, rcond=None)
    res = y - (fixed + coeff * r)
    return {"fixed": float(fixed), "coeff": float(coeff),
            "rms_residual": float(np.sqrt(np.mean(res ** 2)))}


def share_caps(cfg, div: int) -> tuple:
    """Tier 3's ghost rows per face and level at one rank: the full share
    (div 0) or max(8, n_centers // div)."""
    return tuple(max(8, layer.n_centers // div if div else layer.n_centers)
                 for layer in cfg.model.layers)


def ghost_ratio(cfg, caps) -> float:
    """Ghost rows over owned rows at one rank: Σ 2·cap / Σ n_centers."""
    return sum(2 * c for c in caps) / sum(
        layer.n_centers for layer in cfg.model.layers)


def scene_config(preset: str, train: bool):
    """The preset as one scene of batch × num_points points, batch 1 and
    no augmentation (the reference's study; in eval mode only a batched
    preset is changed)."""
    from gridgcn_torch.configs import presets
    from gridgcn_torch.configs.base import apply_overrides

    cfg = presets.get(preset)
    if train or cfg.data.batch_size != 1:
        cfg = apply_overrides(cfg, {
            "data.num_points": cfg.data.num_points * cfg.data.batch_size,
            "data.batch_size": 1, "data.augment": False})
    return cfg


def variants(train: bool, sweep: bool) -> list:
    """(name, kind, div) in the order they run."""
    out = [("plain", "plain", 0), ("tier3 full-share", "tier3", 0)]
    if sweep:
        out += [(f"tier3 share/{d}", "tier3", d) for d in SWEEP_DIVS]
    if not train:
        out.append(("tier2", "tier2", 0))
    return out


def _measure(preset: str, train: bool, device: str, iters: int,
             trace_dir: str, todo: list) -> list:
    """One rank of a world-1 group (`parallel.launch`): build the scene
    and the programs, then for each (name, kind, div) of `todo` its
    `utils.profiling.timed_trace` record (CUDA-events ms per call, busy
    ms per call of one trace of `iters` calls, knn3_mxu's launches per
    call under the trace, "refused" where the trace lost device records),
    tier 3's ghost overflow and the seconds it took (the first row also
    the set-up's)."""
    t0 = time.perf_counter()
    from gridgcn_torch.data.synthetic import synthetic_scene_surface
    from gridgcn_torch.kernels import knn
    from gridgcn_torch.models.build import build_model, init_model
    from gridgcn_torch.models.fold import fold_inference
    from gridgcn_torch.parallel.mesh import make_mesh
    from gridgcn_torch.parallel.resident import (
        make_resident_forward, resident_halo, scene_bounds, slab_inputs)
    from gridgcn_torch.parallel.resident_ml import make_resident_ml_forward
    from gridgcn_torch.parallel.spatial import (
        partition_scene, suggest_capacity)
    from gridgcn_torch.parallel.spatial_train import (
        make_spatial_train_step, shard_scene_batch)
    from gridgcn_torch.train import steps
    from gridgcn_torch.utils import jaxrng, profiling
    from gridgcn_torch.utils.precision import full_fp32

    dev = torch.device(device)
    mesh = make_mesh(1, [dev])
    cfg = scene_config(preset, train)
    N = cfg.data.num_points
    xyz = np.asarray(synthetic_scene_surface(N, seed=7), np.float32)
    mask = np.ones(N, bool)
    key = jaxrng.PRNGKey(0)
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    extra = {}

    if train:
        labels = np.random.default_rng(0).integers(
            0, cfg.model.num_classes, N).astype(np.int32)
        plain_batch = {"xyz": torch.as_tensor(xyz, device=dev)[None],
                       "label": torch.as_tensor(labels, device=dev)[None],
                       "mask": torch.as_tensor(mask, device=dev)[None]}
        sbatch = {k: torch.as_tensor(v, device=dev) for k, v in
                  shard_scene_batch(cfg, xyz, labels, mask, mesh, N).items()}
        extra["capacity"] = int(sbatch["sx"].shape[1])

        def program(kind, div):
            state = steps.create_train_state(cfg, build_model(cfg.model), sd,
                                             8, device=dev)
            if kind == "plain":
                step, batch = steps.make_train_step(cfg), plain_batch
            else:
                step, batch = make_spatial_train_step(
                    cfg, mesh, tier="resident_ml",
                    ghost_cap=share_caps(cfg, div) if div else 0), sbatch

            def fn():
                return step(state, batch, key)[1]
            return fn, (lambda m: int(m["ghost_overflow"])
                        if kind == "tier3" else None)
    else:
        cfg, folded = fold_inference(cfg, sd)
        model = build_model(cfg.model)
        model.load_state_dict(folded)
        model = model.to(dev).eval()
        xyz_t = torch.as_tensor(xyz, device=dev)[None]
        mask_t = torch.as_tensor(mask, device=dev)[None]
        origin, vsize = scene_bounds(xyz, mask, cfg.model.layers[0].resolution)
        extent = vsize * cfg.model.layers[0].resolution / (1.0 + 1e-5)
        halo = resident_halo(cfg, vsize)
        cap = suggest_capacity(xyz, mask, 1, halo)
        sx, sm, _, sidx, edges = partition_scene(xyz, mask, 1, halo, cap)
        pos = slab_inputs(cfg, sx, sm, sidx, slice(0, 1), dev)
        extra["capacity"] = int(cap)

        def program(kind, div):
            if kind == "plain":
                def call():
                    return model(xyz_t, None, mask_t, key)
            elif kind == "tier2":
                fwd2 = make_resident_forward(cfg, mesh)

                def call():
                    return fwd2(model, *pos, edges, origin, vsize, key)
            else:
                fwd3 = make_resident_ml_forward(
                    cfg, mesh, ghost_cap=share_caps(cfg, div) if div else 0)

                def call():
                    return fwd3(model, *pos, edges, origin, extent, key)

            def fn():
                with torch.no_grad(), full_fp32():
                    return call()
            return fn, (lambda out: int(out[1].sum())
                        if kind == "tier3" else None)

    rows = []
    setup = time.perf_counter() - t0
    for name, kind, div in todo:
        t1 = time.perf_counter()
        fn, overflow = program(kind, div)
        last = {}

        def call():
            last["out"] = fn()
        row = profiling.timed_trace(
            call, iters, os.path.join(trace_dir, name.replace(" ", "_")
                                      .replace("/", "_")),
            dev, counter=lambda: knn.knn3_mxu.launches)
        rows.append({"name": name, "kind": kind, "div": div,
                     "ghost_overflow": overflow(last["out"]), **extra,
                     **row, "seconds": time.perf_counter() - t1})
    rows[0]["setup_seconds"] = setup
    return rows


def run_variants(args, todo: list) -> tuple[dict, int, list]:
    """The variants on the card in fresh world-1 processes, PER_PROCESS
    a process (all of them in one on the CPU, which has no device
    records to lose); a process whose trace was refused is run again
    (`utils.profiling.retaking`). Returns ({name: row}, the number of
    retakes, each process's seconds: set-up, each variant's, and the
    launch's whole wall time)."""
    from gridgcn_torch.parallel.launch import launch
    from gridgcn_torch.utils.profiling import retaking

    dev = torch.device(args.device)
    per = (PER_PROCESS["train" if args.train else "eval"]
           if dev.type == "cuda" else len(todo))
    rows, retaken, seconds = {}, 0, []
    for i in range(0, len(todo), per):
        group = todo[i:i + per]
        t0 = time.perf_counter()
        got, n = retaking(lambda: launch(
            _measure, [dev], args.preset, args.train, str(dev), args.iters,
            args.trace_dir, group), RETAKES)
        rows.update({row["name"]: row for row in got})
        retaken += n
        seconds.append({"variants": [v[0] for v in group],
                        "setup": round(got[0]["setup_seconds"], 2),
                        "each": [round(r["seconds"], 2) for r in got],
                        "process": round(time.perf_counter() - t0, 2)})
    return rows, retaken, seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20,
                    help="calls per timing and per trace")
    ap.add_argument("--ghost-sweep", action="store_true",
                    help="also sweep tier 3's ghost caps (share/2, /4, /8) "
                         "and fit the affine ghost tax")
    ap.add_argument("--train", action="store_true",
                    help="time train steps: the plain single-device step "
                         "against the tier-3 spatial step")
    ap.add_argument("--preset", default=None,
                    help="config preset (default: scannet_seg with --train, "
                         "scannet_whole_scene otherwise); a batched preset "
                         "runs as ONE scene of batch × num_points points")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default="build/study_mesh1_overhead")
    args = ap.parse_args(argv)
    if args.preset is None:
        args.preset = "scannet_seg" if args.train else "scannet_whole_scene"
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    if dev.type == "cuda" and dev.index is None:
        args.device = "cuda:0"          # the rank's card, for NCCL

    cfg = scene_config(args.preset, args.train)
    mode = "train" if args.train else "eval"
    todo = variants(args.train, args.ghost_sweep)
    rows, retaken, seconds = run_variants(args, todo)
    plain = rows["plain"]

    def over(row, key):
        a, b = row[key], plain[key]
        return None if a is None or b is None else a / b - 1.0

    def r(x, n=4):
        return None if x is None else round(x, n)

    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"config {cfg.name} ({mode}): one {cfg.data.num_points}-point "
          f"scene; plain {plain['wall_ms']:.3f} ms a call ({clock}), "
          f"{r(plain['busy_ms'])} ms busy", flush=True)
    points = []
    for name, kind, div in todo:
        if kind != "tier3":
            continue
        row = rows[name]
        caps = share_caps(cfg, div)
        points.append({
            "setting": name.split(" ", 1)[1], "div": div, "caps": list(caps),
            "ratio": ghost_ratio(cfg, caps), "busy_ms": r(row["busy_ms"]),
            "wall_ms": r(row["wall_ms"]), "overhead": r(over(row, "busy_ms"),
                                                        6),
            "overhead_wall": r(over(row, "wall_ms"), 6),
            "ghost_overflow": row["ghost_overflow"],
            "knn3_mxu_launches_per_call": row["per_call"]})
        p = points[-1]
        print(f"tier-3 {p['setting']:>10} at one rank: {p['wall_ms']} ms "
              f"a call ({clock}), {p['busy_ms']} busy (ratio "
              f"{p['ratio']:.3f}; overhead {p['overhead']} busy, "
              f"{p['overhead_wall']} wall)", flush=True)
    tier2 = None
    if "tier2" in rows:
        row = rows["tier2"]
        tier2 = {"busy_ms": r(row["busy_ms"]), "wall_ms": r(row["wall_ms"]),
                 "overhead": r(over(row, "busy_ms"), 6),
                 "overhead_wall": r(over(row, "wall_ms"), 6),
                 "knn3_mxu_launches_per_call": row["per_call"]}
        print(f"tier-2 at one rank: {tier2['wall_ms']} ms a call "
              f"({clock}), {tier2['busy_ms']} busy (overhead "
              f"{tier2['overhead']} busy, {tier2['overhead_wall']} wall)",
              flush=True)
    fit = fit_wall = None
    if args.ghost_sweep:
        ratios = [p["ratio"] for p in points]
        if all(p["overhead"] is not None for p in points):
            fit = affine_fit(ratios, [p["overhead"] for p in points])
            print(f"{mode} ghost tax fit (busy): fixed {fit['fixed']:.4f}, "
                  f"coeff {fit['coeff']:.4f}, rms residual "
                  f"{fit['rms_residual']:.4f}", flush=True)
        fit_wall = affine_fit(ratios, [p["overhead_wall"] for p in points])
    out = {
        "preset": args.preset, "config": cfg.name, "mode": mode,
        "backend": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "iters": args.iters, "scene_points": cfg.data.num_points,
        "capacity": plain["capacity"],
        "plain": {"busy_ms": r(plain["busy_ms"]),
                  "wall_ms": r(plain["wall_ms"]),
                  "knn3_mxu_launches_per_call": plain["per_call"]},
        "tier3": points, "tier2": tier2, "fit": fit, "fit_wall": fit_wall,
        "retaken": retaken, "seconds": seconds,
    }
    print("MESH1_OVERHEAD " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
