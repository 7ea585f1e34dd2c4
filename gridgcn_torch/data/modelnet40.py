"""F-11: ModelNet40 loader (SURVEY.md §2.3).

Reads the standard `modelnet40_ply_hdf5_2048` HDF5 distribution (2048 points
per cloud; train/test file lists), subsamples to `num_points`, and
unit-sphere-normalizes — the reference's preprocessing (paper §4.3). The
per-cloud normalization is cheap and deterministic so it runs here once at
load; all randomized transforms run on device (data/augment.py).
"""

from __future__ import annotations

import os

import numpy as np

from gridgcn_torch.data import native


def _unit_sphere(pts: np.ndarray) -> np.ndarray:
    centroid = pts.mean(axis=-2, keepdims=True)
    pts = pts - centroid
    scale = np.max(np.linalg.norm(pts, axis=-1, keepdims=True), axis=-2,
                   keepdims=True)
    return pts / np.maximum(scale, 1e-8)


def load_modelnet40(root: str, split: str, num_points: int, seed: int = 0):
    """Returns (points [S, num_points, 3] float32, labels [S] int32).

    The 2048→num_points subsample is a seeded per-cloud random subset
    without replacement through the threaded native kernel
    (data/native.sample_points — F-11's documented consumer). The
    reference lineage slices the prefix instead; the h5 dumps store points
    in random order, so the two are distributionally equivalent, but the
    explicit sample doesn't depend on that file-order property."""
    import h5py

    base = os.path.join(root, "modelnet40_ply_hdf5_2048")
    list_file = os.path.join(base, f"{'train' if split == 'train' else 'test'}_files.txt")
    with open(list_file) as f:
        files = [os.path.join(base, os.path.basename(line.strip()))
                 for line in f if line.strip()]

    all_pts, all_labels = [], []
    for fn in files:
        with h5py.File(fn, "r") as h5:
            all_pts.append(np.asarray(h5["data"][..., :3], np.float32))
            all_labels.append(np.asarray(h5["label"]).reshape(-1))
    pts = np.concatenate(all_pts, 0)
    if num_points < pts.shape[1]:
        pts = native.sample_points(
            pts, np.arange(pts.shape[0], dtype=np.int32), num_points,
            seed=seed)
    else:
        pts = pts[:, :num_points]
    pts = _unit_sphere(pts)
    labels = np.concatenate(all_labels, 0).astype(np.int32)
    return pts, labels
