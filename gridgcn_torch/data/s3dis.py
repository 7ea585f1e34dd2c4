"""F-13: S3DIS loader (SURVEY.md §2.3).

Room scans pre-blocked into 1m×1m columns of `num_points` points with 9-dim
features (xyz, rgb, normalized room xyz) — the PointNet lineage format the
reference consumes (paper §4.4). Expects `<root>/s3dis/` containing
`s3dis_<split>_points.npy` [S, N, 9] and `s3dis_<split>_labels.npy` [S, N]
(Area-5 split), or the standard `indoor3d_sem_seg_hdf5_data` distribution.
"""

from __future__ import annotations

import os

import numpy as np

_AREA5_PREFIX = "Area_5"


def load_s3dis(root: str, split: str, num_points: int,
               holdout: str = _AREA5_PREFIX):
    """Returns (xyz [S,N,3], feats [S,N,6] (rgb+normalized xyz), labels [S,N]).

    `holdout` names the held-out area for the hdf5 layout (default the
    reference's Area-5 protocol; pass `Area_k` to run the paper's 6-fold
    cross-validation one fold at a time). The pre-split npy layout CANNOT
    re-split — its files already encode one holdout — so a non-default
    `holdout` with npy files present is an error, not a silent Area-5 run."""
    base = os.path.join(root, "s3dis")
    npy_pts = os.path.join(base, f"s3dis_{split}_points.npy")
    if os.path.exists(npy_pts):
        _check_npy_holdout(holdout, npy_pts)
        pts = np.load(npy_pts).astype(np.float32)
        labels = np.load(os.path.join(
            base, f"s3dis_{split}_labels.npy")).astype(np.int32)
    else:
        pts, labels = _load_hdf5_blocks(base, split, holdout=holdout)
    pts = pts[:, :num_points]
    labels = labels[:, :num_points]
    xyz = pts[..., :3]
    feats = pts[..., 3:9] if pts.shape[-1] >= 9 else np.zeros(
        (*xyz.shape[:2], 6), np.float32)
    return xyz, feats, labels


def load_s3dis_rooms(root: str, split: str, num_points: int,
                     holdout: str = _AREA5_PREFIX):
    """Like `load_s3dis` but also returns each block's room id [S] (int32)
    and the room name list, for the reference's room-level block-merging
    evaluation protocol (SURVEY §2.3 F-16). npy layout: optional
    `s3dis_<split>_rooms.npy` [S] of strings/ints; hdf5 layout: from
    `room_filelist.txt`. Blocks without room info fall back to one room."""
    base = os.path.join(root, "s3dis")
    npy_pts = os.path.join(base, f"s3dis_{split}_points.npy")
    if os.path.exists(npy_pts):
        _check_npy_holdout(holdout, npy_pts)
        pts = np.load(npy_pts).astype(np.float32)
        labels = np.load(os.path.join(
            base, f"s3dis_{split}_labels.npy")).astype(np.int32)
        rooms_file = os.path.join(base, f"s3dis_{split}_rooms.npy")
        rooms = (np.load(rooms_file, allow_pickle=True)
                 if os.path.exists(rooms_file)
                 else np.zeros(len(pts), np.int32))
    else:
        pts, labels, rooms = _load_hdf5_blocks(base, split, with_rooms=True,
                                               holdout=holdout)
    pts = pts[:, :num_points]
    labels = labels[:, :num_points]
    names, room_ids = np.unique(np.asarray(rooms), return_inverse=True)
    xyz = pts[..., :3]
    feats = pts[..., 3:9] if pts.shape[-1] >= 9 else np.zeros(
        (*xyz.shape[:2], 6), np.float32)
    return xyz, feats, labels, room_ids.astype(np.int32), [str(n) for n in names]


def _check_npy_holdout(holdout: str, npy_pts: str) -> None:
    """The npy layout bakes ONE holdout at prep time (scripts/
    prepare_data.py records it in `s3dis_holdout.txt`); silently serving a
    mismatched split under a fold_k label would mislabel cross-validation
    results, so refuse instead. Files without the marker (hand-prepped)
    are assumed to be the reference's Area-5 protocol."""
    marker = os.path.join(os.path.dirname(npy_pts), "s3dis_holdout.txt")
    baked = _AREA5_PREFIX
    if os.path.exists(marker):
        with open(marker) as f:
            baked = f.read().strip()
    if holdout != baked:
        raise ValueError(
            f"holdout={holdout!r} requested but the pre-split npy layout "
            f"({npy_pts}) encodes holdout={baked!r}; re-run "
            f"scripts/prepare_data.py s3dis --holdout {holdout} (separate "
            f"root per fold), or remove the npy files to re-split from the "
            f"hdf5 layout")


def _load_hdf5_blocks(base: str, split: str, with_rooms: bool = False,
                      holdout: str = _AREA5_PREFIX):
    """Standard indoor3d_sem_seg_hdf5_data layout with room_filelist
    `holdout`-area holdout (the reference's evaluation protocol, paper
    §4.4: Area-5 by default, any area for 6-fold)."""
    import h5py

    h5dir = os.path.join(base, "indoor3d_sem_seg_hdf5_data")
    with open(os.path.join(h5dir, "all_files.txt")) as f:
        files = [os.path.join(os.path.dirname(h5dir), line.strip())
                 for line in f if line.strip()]
    with open(os.path.join(h5dir, "room_filelist.txt")) as f:
        rooms = [line.strip() for line in f if line.strip()]

    data, labels = [], []
    for fn in files:
        with h5py.File(fn, "r") as h5:
            data.append(np.asarray(h5["data"], np.float32))
            labels.append(np.asarray(h5["label"], np.int32))
    data = np.concatenate(data, 0)
    labels = np.concatenate(labels, 0)
    is_test = np.array([r.startswith(holdout) for r in rooms])
    sel = is_test if split != "train" else ~is_test
    if with_rooms:
        return data[sel], labels[sel], np.asarray(rooms)[sel]
    return data[sel], labels[sel]
