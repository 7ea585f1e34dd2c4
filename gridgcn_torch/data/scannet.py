"""F-12: ScanNet loader (SURVEY.md §2.3).

Training uses fixed-size crops (`num_points` per sample); whole-scene eval
feeds full scenes padded to a static size and batched/sharded across chips
(SURVEY §3.4, BASELINE config 5). Expects `<root>/scannet/` with
`scannet_<split>_points.npy` (object array of [Ni, 3] scenes or a dense
[S, N, 3] array) and matching `_labels.npy`; the reference's pickle scene
dumps can be converted to this layout offline.
"""

from __future__ import annotations

import os

import numpy as np


def load_scannet(root: str, split: str, num_points: int):
    """Returns (points [S, num_points, 3], labels [S, num_points])."""
    base = os.path.join(root, "scannet")
    pts = np.load(os.path.join(base, f"scannet_{split}_points.npy"),
                  allow_pickle=True)
    labels = np.load(os.path.join(base, f"scannet_{split}_labels.npy"),
                     allow_pickle=True)
    if pts.dtype == object:   # ragged scenes → crop/pad to num_points
        out_p = np.zeros((len(pts), num_points, 3), np.float32)
        out_l = np.zeros((len(pts), num_points), np.int32)
        rng = np.random.default_rng(0)
        for i, (p, l) in enumerate(zip(pts, labels)):
            n = p.shape[0]
            idx = (rng.choice(n, num_points, replace=n < num_points)
                   if n != num_points else np.arange(n))
            out_p[i] = p[idx, :3]
            out_l[i] = l[idx]
        return out_p, out_l
    return (pts[:, :num_points, :3].astype(np.float32),
            labels[:, :num_points].astype(np.int32))


def pad_scene(points: np.ndarray, labels: np.ndarray, target: int):
    """Pad one whole scene [N,3]/[N] to a static size with a validity mask."""
    n = points.shape[0]
    if n > target:
        raise ValueError(f"scene has {n} points > static capacity {target}")
    pad = target - n
    pts = np.concatenate([points, np.zeros((pad, 3), points.dtype)], 0)
    labs = np.concatenate([labels, np.zeros((pad,), labels.dtype)], 0)
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return pts, labs, mask
