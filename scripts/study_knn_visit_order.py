#!/usr/bin/env python3
"""How often the flash-kNN kernels' top-3 insert runs, by visit order.

    python scripts/study_knn_visit_order.py [--warps 64]

Builds the main path's largest decoder call (81920 queries x 8192
supports: the served `scannet_whole_scene` encoder's output on
`synthetic_scene_surface(81920, seed=7)`, seeded random weights) on the CPU
with the PyTorch port, and replays the insert decisions of the kernels in
`gridgcn_torch/csrc/knn.cu` on a sample of warps, in exact float64
distances:

* knn3_mxu: a warp holds 32 query rows; SPLIT warps share them and take
  every SPLIT-th n8 tile; lane t of a row's quad keeps its own top-3 of the
  columns 2t, 2t+1 of each tile. Printed per order: inserts per query row
  and the share of (tile, 8-row slot) pairs where some lane inserts, which
  is what the divergent insert branch costs. "quad threshold" tests each
  value against the lowest third-best of the row's quad, refreshed every 4
  tiles, as the kernel does.
* knn3_exact: G = 8 lanes share 4 queries, lane l visits every G-th column
  and keeps its own top-3 of keys; a step takes the insert path when a key
  is below the group's lowest third-best key as the lanes last agreed on
  it (every 32 visits). Printed: the share of a warp's steps that do.

Counts only: no time is measured here.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gridgcn_torch.configs import presets  # noqa: E402
from gridgcn_torch.data.synthetic import synthetic_scene_surface  # noqa: E402
from gridgcn_torch.kernels.knn import visit_step  # noqa: E402
from gridgcn_torch.models.build import build_model, init_model  # noqa: E402
from gridgcn_torch.models.fold import fold_inference  # noqa: E402
from gridgcn_torch.utils import jaxrng  # noqa: E402


def decoder_call() -> tuple[np.ndarray, np.ndarray]:
    """(queries [81920, 3], supports [8192, 3]) of the largest decoder
    call, as `chip_smoke.py` builds them on the card."""
    cfg = presets.scannet_whole_scene()
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    fcfg, folded = fold_inference(cfg, sd)
    model = build_model(fcfg.model)
    model.load_state_dict(folded)
    model.eval()
    x = torch.as_tensor(synthetic_scene_surface(81920, seed=7))[None]
    feat, mask = x, torch.ones(x.shape[:2], dtype=torch.bool)
    key = jaxrng.PRNGKey(0)
    levels = [x]
    with torch.no_grad():
        for i in range(len(fcfg.model.layers)):
            x, feat, mask = model.encode_layer(
                i, x, feat, mask,
                jaxrng.flax_make_rng(key, (f"gridconv{i}",), 1))
            levels.append(x)
    return levels[0][0].numpy(), levels[1][0].numpy()


def mxu_inserts(d: np.ndarray, tiles: np.ndarray, split: int,
                refresh: int | None) -> tuple[float, float]:
    """(inserts per row, share of (tile, slot) with an insert) for rows
    d [R, Ns] (R a multiple of 8) visited tile by tile in `tiles`."""
    rows = d.shape[0]
    inserts, slot_hits, slot_tiles = 0, 0, 0
    for part in range(split):
        order = tiles[part::split]
        top = np.full((rows, 4, 3), np.inf)
        thr = np.full((rows, 1), np.inf)
        hit = np.zeros((rows, 4, len(order)), bool)
        for k, tile in enumerate(order):
            if refresh is not None and k % refresh == 0:
                thr = top[:, :, 2].min(1, keepdims=True)
            for c in range(2):
                v = d[:, tile * 8 + 2 * np.arange(4) + c]      # [R, lane]
                cap = top[:, :, 2] if refresh is None else \
                    np.minimum(top[:, :, 2], thr)
                ins = v < cap
                hit[:, :, k] |= ins
                merged = np.sort(np.concatenate([top, v[..., None]], -1), -1)
                top = np.where(ins[..., None], merged[..., :3], top)
        inserts += hit.sum()
        slots = hit.any(1).reshape(rows // 8, 8, -1).any(1)
        slot_hits += slots.sum()
        slot_tiles += slots.size
    return inserts / rows, slot_hits / slot_tiles


def exact_slow_share(keys: np.ndarray, order: np.ndarray, g: int = 8,
                     kq: int = 4, share: int = 32) -> float:
    """Share of a warp's steps that take knn3_exact's insert path, for
    keys [W * 32 // g * kq, Ns] of W warps, columns visited in `order`."""
    per_warp = 32 // g * kq
    steps = slow = 0
    for w in range(keys.shape[0] // per_warp):
        k = keys[w * per_warp:(w + 1) * per_warp][:, order]
        top = np.full((per_warp, g, 3), np.iinfo(np.int64).max)
        thr = top[:, :, 2].copy()
        for i in range(k.shape[1] // g):
            if i % share == 0:
                thr = np.broadcast_to(top[:, :, 2].min(1, keepdims=True),
                                      thr.shape).copy()
            v = k[:, i * g:(i + 1) * g]                       # [queries, g]
            steps += 1
            if (v < thr).any():
                slow += 1
                ins = v < top[:, :, 2]
                merged = np.sort(np.concatenate([top, v[..., None]], -1), -1)
                top = np.where(ins[..., None], merged[..., :3], top)
    return slow / steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--warps", type=int, default=64,
                    help="warps of 32 query rows sampled (seed 0)")
    args = ap.parse_args()
    q, s = decoder_call()
    ns = s.shape[0]
    rng = np.random.default_rng(0)
    first = rng.choice(q.shape[0] // 32, args.warps, replace=False) * 32
    rows = np.concatenate([np.arange(a, a + 32) for a in first])
    d = ((q[rows, None, :].astype(np.float64) - s[None]) ** 2).sum(-1)
    n = ns // 8
    ascending = np.arange(n)
    visit = ascending * visit_step(n) % n
    print(f"knn3_mxu, {q.shape[0]}x{ns}, {args.warps} warps of 32 rows, "
          f"SPLIT 2 (the per-row lists of 8 lanes):")
    for name, tiles, refresh in (("column order", ascending, None),
                                 ("visit order", visit, None),
                                 ("visit order, quad threshold", visit, 4)):
        per_row, slots = mxu_inserts(d, tiles, 2, refresh)
        print(f"  {name}: {per_row:.1f} inserts per row, insert in "
              f"{slots:.3f} of (tile, 8-row slot) pairs")
    per_row, slots = mxu_inserts(d, visit, 1, 4)
    print(f"  visit order, quad threshold, SPLIT 1 (the kernel at this "
          f"shape): {per_row:.1f} inserts per row, {slots:.3f}")
    # knn3_exact: f32 distances, keys with the column in the low bits
    low = (1 << max(1, (ns - 1).bit_length())) - 1
    d32 = d[:16 * (args.warps // 4)].astype(np.float32)
    keys = ((d32.view(np.int32) & ~low) | np.arange(ns, dtype=np.int32))
    share = exact_slow_share(keys.astype(np.int64),
                             np.arange(ns) * visit_step(ns) % ns)
    print(f"knn3_exact, G 8, 4 queries a thread, visit order, shared "
          f"every 32 visits: {share:.3f} of a warp's steps insert")
    return 0


if __name__ == "__main__":
    sys.exit(main())
