"""Dataset preparation / discovery for the PyTorch port (the counterpart of
`scripts/prepare_data.py`, importing nothing of the JAX package).

The loaders (`gridgcn_torch/data/`) read the standard public distributions
directly where possible:

  * ModelNet40 — `<root>/modelnet40_ply_hdf5_2048/` (HDF5 + file lists),
    consumed as-is by data/modelnet40.py.
  * S3DIS — `<root>/s3dis/indoor3d_sem_seg_hdf5_data/` (HDF5 blocks +
    room_filelist, Area-5 holdout), consumed as-is by data/s3dis.py; or the
    pre-split npy layout written by `s3dis --from-hdf5` below (adds the
    per-block room ids the room-merging eval uses without re-reading HDF5).
  * ScanNet — the reference lineage ships `scannet_<split>.pickle` scene
    dumps; `scannet` below converts them to the loaders' npy layout.

Usage:
  python scripts/prepare_data_torch.py check --root data
  python scripts/prepare_data_torch.py scannet --root data \
      --pickle scannet_train.pickle --split train
  python scripts/prepare_data_torch.py s3dis --root data --from-hdf5
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def check(root: str, dataset: str | None = None) -> int:
    """Report which datasets are discoverable under `root`. With `dataset`,
    the exit code reflects only that dataset (so `parity --dataset s3dis`
    needs only the s3dis files); without it, all three must be present."""
    mn = os.path.join(root, "modelnet40_ply_hdf5_2048", "test_files.txt")
    print(f"modelnet40: {'FOUND' if os.path.exists(mn) else 'missing'} "
          f"({mn})")
    s3_h5 = os.path.join(root, "s3dis", "indoor3d_sem_seg_hdf5_data",
                         "all_files.txt")
    s3_npy = os.path.join(root, "s3dis", "s3dis_test_points.npy")
    found = ("FOUND (hdf5)" if os.path.exists(s3_h5) else
             "FOUND (npy)" if os.path.exists(s3_npy) else "missing")
    print(f"s3dis: {found} ({s3_h5} | {s3_npy})")
    sc = os.path.join(root, "scannet", "scannet_test_points.npy")
    print(f"scannet: {'FOUND' if os.path.exists(sc) else 'missing'} ({sc})")
    present = {
        "modelnet40": os.path.exists(mn),
        "s3dis": os.path.exists(s3_h5) or os.path.exists(s3_npy),
        "scannet": os.path.exists(sc),
    }
    ok = present[dataset] if dataset else all(present.values())
    print("all datasets present" if all(present.values()) else
          "some datasets missing — parity checks limited to what's present")
    return 0 if ok else 1


def scannet_from_pickle(root: str, pickle_path: str, split: str) -> int:
    """Convert a reference-lineage ScanNet pickle (list/tuple of per-scene
    (points [Ni,3+], labels [Ni]) — or a dict with those under
    'data'/'label'-ish keys) to the loader's npy object-array layout."""
    import pickle

    with open(pickle_path, "rb") as f:
        obj = pickle.load(f, encoding="latin1")

    def _is_scene_pair(e):
        # one scene's (points [Ni,>=3], labels [Ni]) tuple
        return (isinstance(e, (list, tuple)) and len(e) == 2
                and np.ndim(e[0]) == 2 and np.ndim(e[1]) == 1)

    if isinstance(obj, dict):
        pts_key = next((k for k in ("data", "points", "scene_points")
                        if k in obj), None)
        lab_key = next((k for k in ("label", "labels", "semantic_labels")
                        if k in obj), None)
        if pts_key is None or lab_key is None:
            raise ValueError(
                f"unrecognized pickle dict keys {sorted(obj)}; expected "
                "points under data/points/scene_points and labels under "
                "label/labels/semantic_labels")
        scenes, labels = obj[pts_key], obj[lab_key]
    elif isinstance(obj, (list, tuple)) and len(obj) \
            and all(_is_scene_pair(e) for e in obj):
        # list of per-scene tuples — test BEFORE the (scenes, labels) pair
        # form so a 2-scene list isn't misread as the pair form
        scenes, labels = zip(*obj)
    elif isinstance(obj, (list, tuple)) and len(obj) == 2 \
            and not np.isscalar(obj[0]):
        scenes, labels = obj
    else:
        raise ValueError(f"unrecognized pickle structure: {type(obj)}")

    pts_out = np.empty(len(scenes), object)
    lab_out = np.empty(len(labels), object)
    for i, (p, l) in enumerate(zip(scenes, labels)):
        p = np.asarray(p, np.float32)
        pts_out[i] = p[:, :3]
        lab_out[i] = np.asarray(l, np.int32).reshape(-1)
        if pts_out[i].shape[0] != lab_out[i].shape[0]:
            raise ValueError(f"scene {i}: {pts_out[i].shape[0]} points vs "
                             f"{lab_out[i].shape[0]} labels")
    out_dir = os.path.join(root, "scannet")
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"scannet_{split}_points.npy"), pts_out,
            allow_pickle=True)
    np.save(os.path.join(out_dir, f"scannet_{split}_labels.npy"), lab_out,
            allow_pickle=True)
    print(f"wrote {len(scenes)} scenes to {out_dir}/scannet_{split}_*.npy")
    return 0


def s3dis_from_hdf5(root: str, holdout: str = "Area_5") -> int:
    """Materialize the hdf5 distribution as the npy layout WITH room ids
    (`s3dis_<split>_rooms.npy`), so room-level eval never re-reads HDF5.
    `holdout` picks the held-out area (Area_5 = reference protocol; run
    once per Area_k for the paper's 6-fold cross-validation)."""
    from gridgcn_torch.data.s3dis import _load_hdf5_blocks

    base = os.path.join(root, "s3dis")
    for split in ("train", "test"):
        pts, labels, rooms = _load_hdf5_blocks(base, split, with_rooms=True,
                                               holdout=holdout)
        np.save(os.path.join(base, f"s3dis_{split}_points.npy"), pts)
        np.save(os.path.join(base, f"s3dis_{split}_labels.npy"), labels)
        np.save(os.path.join(base, f"s3dis_{split}_rooms.npy"),
                np.asarray(rooms))
        print(f"s3dis {split}: {len(pts)} blocks, "
              f"{len(set(rooms))} rooms")
    # record which area these npy files hold out, so data/s3dis.py can
    # refuse a mismatched 6-fold request instead of silently serving the
    # wrong split
    with open(os.path.join(base, "s3dis_holdout.txt"), "w") as f:
        f.write(holdout + "\n")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check");   c.add_argument("--root", default="data")
    c = sub.add_parser("scannet"); c.add_argument("--root", default="data")
    c.add_argument("--pickle", required=True)
    c.add_argument("--split", required=True, choices=["train", "test"])
    c = sub.add_parser("s3dis");   c.add_argument("--root", default="data")
    # accepted for CLI-doc compat; hdf5 is the only s3dis source
    c.add_argument("--from-hdf5", action="store_true")
    c.add_argument("--holdout", default="Area_5",
                   help="held-out area (Area_k for 6-fold CV)")
    args = p.parse_args(argv)
    if args.cmd == "check":
        return check(args.root)
    if args.cmd == "scannet":
        return scannet_from_pickle(args.root, args.pickle, args.split)
    return s3dis_from_hdf5(args.root, holdout=args.holdout)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
