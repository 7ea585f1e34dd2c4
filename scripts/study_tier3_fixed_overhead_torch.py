"""Attribute tier 3's overhead at world 1 on the card (the port's
counterpart of `scripts/study_tier3_fixed_overhead.py`).

Tier 3 (`gridgcn_torch/parallel/resident_ml.py`) at one rank still pays
its protocol: the slab bookkeeping, the boundary bands, the ghost buffers
packed and unpacked, the overflow counters, and the ghost rows riding
through sampling, gathers and GCA. This study names what that costs:
it traces the plain unsharded whole-scene forward and the tier-3 forward
at world 1 (a one-rank process group: NCCL on the card, gloo on the CPU)
at ghost caps of each level's share / 8 (`max(8, n_centers // 8)`), the
smallest the reference's study uses, diffs the two traces' per-kernel
exclusive ms (`utils.traceview.exclusive_ms`), and prints busy ms per
call of both, the difference, and the `--topn` kernels by |Δ|.

    python scripts/study_tier3_fixed_overhead_torch.py [--iters 10]
        [--topn 25] [--preset scannet_whole_scene] [--device cuda|cpu]
        [--trace-dir build/study_tier3_fixed_overhead]

The last line is `TIER3_OVERHEAD {json}`. Both forwards run BatchNorm
folded in the preset's dtype on the 81920-point `synthetic_scene_surface`
scene of seed 7 under key 0. On the CPU (`--device cpu`) the busy values
and the diff are null: only the host-clock wall times are printed.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def diff_rows(plain: dict, t3: dict) -> list:
    """[(Δ ms, tier-3 ms, plain ms, kernel)] over every kernel of either
    attribution, largest |Δ| first (ties by name)."""
    names = set(plain) | set(t3)
    rows = [(t3.get(n, 0.0) - plain.get(n, 0.0), t3.get(n, 0.0),
             plain.get(n, 0.0), n) for n in names]
    return sorted(rows, key=lambda r: (-abs(r[0]), r[3]))


def report(plain: dict, t3: dict, topn: int, label: str) -> list:
    """The reference study's table: busy per call of both runs, their
    difference, then the top `topn` kernels by |Δ|."""
    tot_p, tot_3 = sum(plain.values()), sum(t3.values())
    lines = [f"busy/iter: plain {tot_p:.3f} ms, {label} {tot_3:.3f} ms, "
             f"diff {tot_3 - tot_p:+.3f} ({(tot_3 / tot_p - 1) * 100:+.1f}%)",
             "", f"{'Δ ms':>9}  {'tier3':>8}  {'plain':>8}  op"]
    for d, a, b, n in diff_rows(plain, t3)[:topn]:
        lines.append(f"{d:+9.4f}  {a:8.4f}  {b:8.4f}  {n[:95]}")
    return lines


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10,
                    help="calls per timing and per trace")
    ap.add_argument("--topn", type=int, default=25)
    ap.add_argument("--preset", default="scannet_whole_scene")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default="build/study_tier3_fixed_overhead")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from gridgcn_torch.configs import presets
    from gridgcn_torch.data.synthetic import synthetic_scene_surface
    from gridgcn_torch.models.build import build_model, init_model
    from gridgcn_torch.models.fold import fold_inference
    from gridgcn_torch.parallel.mesh import init_distributed, make_mesh
    from gridgcn_torch.parallel.resident import (
        resident_halo, scene_bounds, slab_inputs)
    from gridgcn_torch.parallel.resident_ml import make_resident_ml_forward
    from gridgcn_torch.parallel.spatial import (
        partition_scene, suggest_capacity)
    from gridgcn_torch.utils import jaxrng, profiling, traceview
    from gridgcn_torch.utils.precision import full_fp32

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)   # the rank's card, for NCCL
    cfg = presets.get(args.preset)
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    cfg, folded = fold_inference(cfg, sd)
    model = build_model(cfg.model)
    model.load_state_dict(folded)
    model = model.to(dev).eval()
    N = cfg.data.num_points
    xyz = np.asarray(synthetic_scene_surface(N, seed=7), np.float32)
    mask = np.ones(N, bool)
    key = jaxrng.PRNGKey(0)
    xyz_t = torch.as_tensor(xyz, device=dev)[None]
    mask_t = torch.as_tensor(mask, device=dev)[None]

    # tier 3's inputs at world 1, as resident_ml_seg_predict builds them
    res0 = cfg.model.layers[0].resolution
    origin, vsize = scene_bounds(xyz, mask, res0)
    extent = vsize * res0 / (1.0 + 1e-5)
    halo = resident_halo(cfg, vsize)
    sx, sm, _, sidx, edges = partition_scene(
        xyz, mask, 1, halo, suggest_capacity(xyz, mask, 1, halo))
    caps = tuple(max(8, layer.n_centers // 8) for layer in cfg.model.layers)

    def capture(name, fn):
        """(wall ms per call, {kernel: exclusive ms per call} or None)."""
        wall = profiling.steady_state_time(fn, warmup=2, iters=args.iters,
                                           device=dev) * 1e3
        logdir = os.path.join(args.trace_dir, name)
        with profiling.trace(logdir):
            for _ in range(args.iters):
                fn()
        if dev.type != "cuda":
            return wall, None
        profiling.busy_ms_per_iter(logdir, args.iters)  # raises if empty
        return wall, traceview.exclusive_ms(logdir, args.iters)

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1")
    os.environ.update(env)
    try:
        init_distributed([dev])
        mesh = make_mesh(1, [dev])
        pos = slab_inputs(cfg, sx, sm, sidx, slice(0, 1), dev)
        fwd3 = make_resident_ml_forward(cfg, mesh, ghost_cap=caps)
        with torch.no_grad(), full_fp32():
            plain_wall, plain = capture(
                "plain", lambda: model(xyz_t, None, mask_t, key))
            t3_wall, t3 = capture(
                "tier3", lambda: fwd3(model, *pos, edges, origin, extent,
                                      key))
            overflow = int(fwd3(model, *pos, edges, origin, extent,
                                key)[1].sum())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k)

    label = "tier-3@1 caps=share/8"
    out = {"preset": args.preset, "backend": dev.type,
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "iters": args.iters, "caps": list(caps),
           "ghost_overflow": overflow,
           "plain_wall_ms": round(plain_wall, 4),
           "tier3_wall_ms": round(t3_wall, 4),
           "plain_busy_ms": None, "tier3_busy_ms": None, "diff_ms": None,
           "top": None}
    if plain is not None:
        for line in report(plain, t3, args.topn, label):
            print(line)
        tot_p, tot_3 = sum(plain.values()), sum(t3.values())
        out.update(plain_busy_ms=round(tot_p, 4),
                   tier3_busy_ms=round(tot_3, 4),
                   diff_ms=round(tot_3 - tot_p, 4),
                   top=[[round(d, 4), round(a, 4), round(b, 4), n[:95]]
                        for d, a, b, n in diff_rows(plain, t3)[:args.topn]])
    else:
        print(f"wall/iter (host clock): plain {plain_wall:.3f} ms, {label} "
              f"{t3_wall:.3f} ms")
    print("TIER3_OVERHEAD " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
