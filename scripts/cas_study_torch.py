"""How much of sequential CAS's coverage gain the batched-Jacobi sampler
recovers, as `cas_iters` varies, at the seg presets' grids (the port's
counterpart of `scripts/cas_study.py`).

Coverage (the paper's Fig. 2 measure) is the number of distinct voxels
that the selected centers' context³ neighbourhoods cover. For each
setting and surface scene (`synthetic_scene_surface`, seeds 0, 1, 2) the
voxel table is built with nv 16 under key `seed`, then the centers are
drawn under key 100 + seed by RVS, by the port's batched-Jacobi CAS
(`ops.sampling.sample_centers_cas`) at 1, 2, 4 and 8 rounds, and by
sequential Gauss-Seidel CAS (one challenge at a time, the counts updated
after every accepted swap) at 1 and 2 rounds, numpy-seeded by the seed.
The port's samplers draw the JAX package's centers bit for bit, so the
counts are the reference study's.

    python scripts/cas_study_torch.py [--device cpu|cuda]

Runs on the CPU by default, as the reference's study; prints a table per
setting and last `CAS_STUDY {json}` (mean covered voxels per sampler).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SAMPLERS = ("rvs", "j1", "j2", "j4", "j8", "gs1", "gs2")
SETTINGS = (("s3dis-ish", 4096, 24, 1024),      # 4096-point blocks
            ("scannet-ish", 8192, 40, 2048))    # 8192-point crops


def vid_coords(vid, resolution: int) -> np.ndarray:
    z = vid % resolution
    y = (vid // resolution) % resolution
    x = vid // (resolution * resolution)
    return np.stack([x, y, z], axis=-1)


def context_voxels(v, resolution: int, context: int) -> list:
    """The voxel ids of v's context³ neighbourhood inside the grid."""
    r = (context - 1) // 2
    x, y, z = vid_coords(np.array(v), resolution)
    out = []
    for dx in range(-r, r + 1):
        nx = x + dx
        if not 0 <= nx < resolution:
            continue
        for dy in range(-r, r + 1):
            ny = y + dy
            if not 0 <= ny < resolution:
                continue
            for dz in range(-r, r + 1):
                nz = z + dz
                if 0 <= nz < resolution:
                    out.append(int(((nx * resolution) + ny) * resolution
                                   + nz))
    return out


def covered_voxels(sel_vids, sel_valid, resolution: int,
                   context: int) -> int:
    """Distinct voxels covered by the valid selected centers' context."""
    covered = set()
    for v, ok in zip(sel_vids, sel_valid):
        if ok:
            covered.update(context_voxels(v, resolution, context))
    return len(covered)


def cas_gauss_seidel(occ_vids, M: int, resolution: int, context: int,
                     rng: np.random.Generator, iters: int = 1) -> np.ndarray:
    """Sequential (Gauss-Seidel) CAS: M of the occupied voxels drawn at
    random, then each round challenges every unselected occupied voxel
    in a random order against a random incumbent; the challenger wins
    when it would cover more voxels that nothing covers than the
    incumbent alone covers, and the counts follow every swap. Returns
    the selected voxel ids [≤ M]."""
    occ = np.asarray(occ_vids)
    if len(occ) <= M:
        return occ.copy()
    sel = rng.choice(occ, M, replace=False)
    sel_set = set(int(v) for v in sel)
    C = np.zeros(resolution ** 3, np.int64)
    for v in sel:
        for u in context_voxels(v, resolution, context):
            C[u] += 1
    sel = list(sel_set)
    for _ in range(iters):
        challengers = rng.permutation([v for v in occ
                                       if int(v) not in sel_set])
        for chal in challengers:
            i = rng.integers(0, len(sel))
            inc = sel[i]
            chal_ctx = context_voxels(chal, resolution, context)
            inc_ctx = context_voxels(inc, resolution, context)
            h_add = sum(1 for u in chal_ctx if C[u] == 0)
            h_rmv = sum(1 for u in inc_ctx if C[u] == 1)
            if h_add > h_rmv:
                for u in inc_ctx:
                    C[u] -= 1
                for u in chal_ctx:
                    C[u] += 1
                sel_set.discard(int(inc))
                sel_set.add(int(chal))
                sel[i] = int(chal)
    return np.asarray(sel)


def coverage(n_points: int, resolution: int, M: int, seed: int,
             context: int = 3, device="cpu") -> dict:
    """{sampler: covered voxels} on the surface scene of `seed`."""
    from gridgcn_torch.data.synthetic import synthetic_scene_surface
    from gridgcn_torch.ops.sampling import (
        sample_centers_cas, sample_centers_rvs)
    from gridgcn_torch.ops.voxelize import build_voxel_table
    from gridgcn_torch.utils import jaxrng

    dev = torch.device(device)
    xyz = torch.as_tensor(synthetic_scene_surface(n_points, seed=seed),
                          device=dev)[None]
    mask = torch.ones((1, n_points), dtype=torch.bool, device=dev)
    table = build_voxel_table(xyz, mask, resolution, 16,
                              jaxrng.PRNGKey(seed))
    occ = np.nonzero(table.coverage[0].cpu().numpy() > 0)[0]
    key = jaxrng.PRNGKey(100 + seed)

    def cov(v, ok):
        return covered_voxels(v[0].cpu().numpy(), ok[0].cpu().numpy(),
                              resolution, context)
    out = {"rvs": cov(*sample_centers_rvs(table, M, key))}
    for it in (1, 2, 4, 8):
        out[f"j{it}"] = cov(*sample_centers_cas(table, M, key,
                                                context=context,
                                                cas_iters=it))
    rng = np.random.default_rng(seed)
    for it in (1, 2):
        sel = cas_gauss_seidel(occ, M, resolution, context, rng, iters=it)
        out[f"gs{it}"] = covered_voxels(sel, np.ones(len(sel), bool),
                                        resolution, context)
    out["occupied"] = len(occ)
    return out


def run_setting(name, n_points, resolution, M, context=3, seeds=(0, 1, 2),
                device="cpu") -> dict:
    """Mean covered voxels per sampler over the seeds' scenes, printed
    with each sampler's gain over RVS and its share of the sequential
    sampler's gain."""
    per = [coverage(n_points, resolution, M, s, context, device)
           for s in seeds]
    m = {k: float(np.mean([p[k] for p in per])) for k in SAMPLERS}
    rvs, gs = m["rvs"], m["gs2"]
    print(f"\n{name}: N={n_points} res={resolution} M={M} "
          f"occ≈{per[-1]['occupied']} (mean over {len(seeds)} surface "
          f"scenes)")
    print(f"{'sampler':>10} {'covered':>9} {'vs RVS':>8} "
          f"{'GS-gap recovered':>17}")
    for k in SAMPLERS:
        rec = (m[k] - rvs) / max(gs - rvs, 1e-9)
        print(f"{k:>10} {m[k]:9.0f} {m[k] / rvs - 1:+8.2%} {rec:17.2%}")
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu",
                    help="cpu (default, as the reference's study) or cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    out = {name: run_setting(name, n, res, M, device=dev)
           for name, n, res, M in SETTINGS}
    print("CAS_STUDY " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
