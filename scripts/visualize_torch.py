"""Prediction visualization for the PyTorch port: dump a colored point cloud
to PLY (the counterpart of `scripts/visualize.py`, importing nothing of
the JAX package).

Binary little-endian PLY, one vertex per point, color = class id through
a fixed 21-color palette (MeshLab/CloudCompare/Open3D all read it).

  python scripts/visualize_torch.py --ckpt-dir checkpoints/scannet_seg \
      --out scene.ply [--scene-npy scene.npy] [--votes 3] [--mesh N] \
      [--device cuda|cpu]

The checkpoint is a `gridgcn_torch` trainer's. Without --scene-npy a
synthetic surface scene is generated, so the script runs with no datasets
on disk. It runs on the card unless `--device cpu` is given; `--mesh N`
shards the scene over N ranks of that device (N worker processes, as the
evaluator's `--mesh` starts them).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# 21 visually-distinct colors (ScanNet has 21 classes; cycles beyond that)
_PALETTE = np.array([
    [174, 199, 232], [152, 223, 138], [31, 119, 180], [255, 187, 120],
    [188, 189, 34], [140, 86, 75], [255, 152, 150], [214, 39, 40],
    [197, 176, 213], [148, 103, 189], [196, 156, 148], [23, 190, 207],
    [247, 182, 210], [219, 219, 141], [255, 127, 14], [158, 218, 229],
    [44, 160, 44], [112, 128, 144], [227, 119, 194], [82, 84, 163],
    [100, 85, 144]], np.uint8)


def write_ply(path: str, xyz: np.ndarray, colors: np.ndarray) -> None:
    """xyz [N,3] f32, colors [N,3] u8 → binary_little_endian PLY."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    colors = np.ascontiguousarray(colors, np.uint8)
    if xyz.shape != (len(xyz), 3) or colors.shape != (len(xyz), 3):
        raise ValueError(f"xyz {xyz.shape} and colors {colors.shape} must "
                         f"both be [N, 3]")
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(xyz)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n")
    rec = np.zeros(len(xyz), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rec["xyz"] = xyz
    rec["rgb"] = colors
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def labels_to_colors(labels: np.ndarray) -> np.ndarray:
    return _PALETTE[np.asarray(labels, np.int64) % len(_PALETTE)]


def predict_labels(ckpt_dir: str, xyz: np.ndarray, votes: int, device: str,
                   mesh=None) -> np.ndarray:
    """Per-point labels of a segmentation checkpoint (whole-scene voting),
    or the one class of a classifier repeated for every point."""
    from gridgcn_torch.api import load_predictor

    predict = load_predictor(ckpt_dir, device=device, mesh=mesh)
    if predict.cfg.model.task == "seg":
        return np.argmax(predict.predict_scene(xyz, votes=votes), -1)
    return np.full(len(xyz), int(np.argmax(predict(xyz))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out", required=True, help="output .ply path")
    p.add_argument("--scene-npy", default=None,
                   help="[N,3] (or [N,>=3]) float npy; default: synthetic "
                        "surface scene")
    p.add_argument("--num-points", type=int, default=16384,
                   help="synthetic scene size (no --scene-npy)")
    p.add_argument("--votes", type=int, default=1)
    p.add_argument("--mesh", type=int, default=None,
                   help="spatially shard the scene over N devices")
    p.add_argument("--truth", action="store_true",
                   help="synthetic scene: also write <out>.truth.ply with "
                        "ground-truth colors for side-by-side comparison")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to predict (cuda raises without a card)")
    args = p.parse_args(argv)

    labels_true = None
    if args.scene_npy:
        xyz = np.load(args.scene_npy).astype(np.float32)[:, :3]
    else:
        from gridgcn_torch.data.synthetic import synthetic_scene_surface
        xyz, labels_true = synthetic_scene_surface(
            args.num_points, seed=0, return_labels=True)

    if args.mesh:
        from gridgcn_torch.parallel.launch import launch
        from gridgcn_torch.parallel.mesh import mesh_devices

        labels = launch(predict_labels,
                        mesh_devices(args.device, args.mesh), args.ckpt_dir,
                        xyz, args.votes, args.device, args.mesh)
    else:
        labels = predict_labels(args.ckpt_dir, xyz, args.votes, args.device)
    write_ply(args.out, xyz, labels_to_colors(labels))
    print(f"wrote {len(xyz)} points, "
          f"{len(np.unique(labels))} predicted classes -> {args.out}")
    if args.truth and labels_true is not None:
        tp = args.out + ".truth.ply"
        write_ply(tp, xyz, labels_to_colors(labels_true))
        print(f"wrote ground truth -> {tp}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
