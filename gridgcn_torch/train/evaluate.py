"""The evaluator CLI.

    python -m gridgcn_torch.train.evaluate --ckpt-dir CKPT \
        [--device cuda|cpu] [--mesh N] [--latency] [--votes K] \
        [--whole-scene [--voxel-size S]] [--s3dis-rooms] \
        [--target modelnet40|s3dis|scannet] [--log FILE]

Restores the newest checkpoint (its config travels with it) and scores
the test split with one of the JAX package's protocols: the crop eval
(optionally with rotation voting and a CUDA-event latency of one batch),
the whole-scene eval with CAGQ-key voting and ScanNet's per-voxel accuracy,
or S3DIS room-level block merging. `--target` compares the protocol's
metric with the reference's published number (`accuracy_targets.json`)
and exits non-zero below it. It runs on the card unless `--device cpu` is
given. `--mesh N` runs over N ranks (N worker processes, or the ranks of a
`torchrun` launch): the crop eval through the data-parallel eval step, the
whole-scene eval through tier-1 spatial sharding (one slab per rank, with
the vote-invariant halo and capacity of the JAX package), or with
`--resident` / `--resident-ml` through the resident tiers, or with
`--resident-ml --scene-batch B` B scenes at a time on a B × N/B mesh; the
room eval ignores it, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from gridgcn_torch.configs.base import to_json
from gridgcn_torch.data.pipeline import make_dataset, to_device
from gridgcn_torch.data.s3dis import load_s3dis_rooms
from gridgcn_torch.models.build import init_model
from gridgcn_torch.parallel import mesh as pmesh
from gridgcn_torch.parallel.launch import launch
from gridgcn_torch.parallel.spatial import (
    required_halo, sharded_scene_apply, suggest_capacity)
from gridgcn_torch.train.metrics import (
    confusion_matrix, merge_block_logits, summarize_confusion,
    voxel_confusion)
from gridgcn_torch.train.steps import (
    create_train_state, make_eval_step, make_voting_eval_step)
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.checkpoint import CheckpointManager
from gridgcn_torch.utils.logging import MetricLogger
from gridgcn_torch.utils.precision import full_fp32
from gridgcn_torch.utils.profiling import steady_state_time

def _mesh_for(mesh_devices: int, device):
    """(mesh or None, this rank's device, whether this rank logs)."""
    if not mesh_devices:
        return None, device, True
    mesh = pmesh.make_mesh(mesh_devices,
                           pmesh.mesh_devices(device, mesh_devices))
    return mesh, mesh.device, mesh.rank == 0


def _logger(lead: bool, log_path):
    return (MetricLogger(log_path) if lead
            else MetricLogger(stream=io.StringIO()))


def _host(summary: dict) -> dict:
    """A summary's tensors as numpy (a launched worker's result)."""
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in summary.items()}


def _restore(ckpt_dir: str, cfg, device):
    """The train state of the newest checkpoint in ckpt_dir (written with
    cfg), the model in eval mode."""
    model, state_dict = init_model(
        cfg.model, torch.Generator().manual_seed(cfg.train.seed))
    state = create_train_state(cfg, model, state_dict, steps_per_epoch=1,
                               device=device)
    ckpt = CheckpointManager(ckpt_dir, cfg, keep=cfg.train.keep_ckpts)
    if ckpt.restore(state) is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    state.model.eval()
    return state


def evaluate(ckpt_dir: str, latency: bool = False, votes: int = 1,
             log_path=None, device="cuda", mesh_devices: int = 0):
    """Crop eval of the test split: OA, mean class accuracy and mIoU
    (rotation voting with votes > 1); `latency` also times one batch's
    eval step (CUDA events on the card). mesh_devices=N: the data-parallel
    eval step over N ranks (N launched workers outside a process group;
    rank 0's summary is returned and only rank 0 logs)."""
    if mesh_devices and not dist.is_initialized():
        return launch(_evaluate_worker, pmesh.mesh_devices(device,
                                                           mesh_devices),
                      ckpt_dir, latency, votes, log_path, device,
                      mesh_devices)
    mesh, device, lead = _mesh_for(mesh_devices, device)
    cfg = CheckpointManager.load_config(ckpt_dir)
    log = _logger(lead, log_path)
    log.log("config", name=cfg.name, config=to_json(cfg))
    state = _restore(ckpt_dir, cfg, device)

    val_ds = make_dataset(cfg.data, "test", cfg.model.num_classes,
                          cfg.model.task)
    eval_step = (make_voting_eval_step(cfg, votes, mesh) if votes > 1
                 else make_eval_step(cfg, mesh))
    rng = jaxrng.PRNGKey(0)

    def put(batch):
        return to_device(batch if mesh is None
                         else pmesh.shard_batch(batch, mesh), state.device)

    C = cfg.model.num_classes
    cm = torch.zeros((C, C), dtype=torch.int32, device=state.device)
    t0 = time.time()
    for batch in val_ds.batches(cfg.data.eval_batch_size, seed=0,
                                shuffle=False, drop_last=False):
        cm = cm + eval_step(state, put(batch), rng)
    s = summarize_confusion(cm)
    log.log("eval", step=state.step, votes=votes,
            overall_acc=float(s["overall_acc"]),
            mean_class_acc=float(s["mean_class_acc"]),
            miou=float(s["miou"]),
            iou_per_class=[round(float(x), 4) for x in s["iou_per_class"]],
            wall_s=round(time.time() - t0, 3))

    if latency:
        batch = put(next(val_ds.batches(cfg.data.eval_batch_size, seed=0,
                                        shuffle=False)))
        dt = steady_state_time(eval_step, state, batch, rng, iters=20,
                               device=state.device)
        log.log("latency", batch_ms=round(dt * 1000, 3),
                points_per_sec=cfg.data.eval_batch_size
                * cfg.data.num_points / dt)
    log.close()
    return s


def _evaluate_worker(*args):
    return _host(evaluate(*args))


def evaluate_whole_scenes(ckpt_dir: str, votes: int = 3, log_path=None,
                          voxel_size: float = 0.05, device="cuda",
                          mesh_devices: int = 0, resident: bool = False,
                          resident_ml: bool = False, scene_batch: int = 0):
    """Whole-scene segmentation eval: every test scene at full size,
    `votes` times with CAGQ keys PRNGKey(1000·s + v), its per-point logits
    summed before the confusion matrix; the metrics count the points whose
    label is not the ignore label, and `voxel_acc` is ScanNet's per-voxel
    accuracy on a `voxel_size` grid. mesh_devices=N shards each scene over
    N ranks, tier 1 (`parallel.spatial.sharded_scene_apply`): one slab per
    rank, the halo and capacity fixed per scene for every vote. With
    `resident` (tier 2) or `resident_ml` (tier 3) the scene runs through a
    resident tier instead, its votes keys fold_in(PRNGKey(1000·s), v).
    scene_batch B > 1 (tier 3, B dividing N) evaluates B scenes at a time
    on a B × N/B mesh, the last group padded with its first scene, group
    g0's keys fold_in(PRNGKey(1000·g0 + v)); it builds no 1-D forward
    (the JAX package builds one it does not use, and raises where the
    layers' n_centers do not divide N)."""
    if (resident or resident_ml) and not mesh_devices:
        raise ValueError("--resident/--resident-ml require --mesh N (a "
                         "device mesh to shard over)")
    if scene_batch and scene_batch > 1:
        if not resident_ml:
            raise ValueError("--scene-batch requires --resident-ml")
        if mesh_devices % scene_batch:
            raise ValueError(f"--scene-batch {scene_batch} must divide "
                             f"--mesh {mesh_devices}")
    else:
        scene_batch = 0
    if mesh_devices and not dist.is_initialized():
        return launch(_whole_scene_worker,
                      pmesh.mesh_devices(device, mesh_devices), ckpt_dir,
                      votes, log_path, voxel_size, device, mesh_devices,
                      resident, resident_ml, scene_batch)
    mesh, device, lead = _mesh_for(mesh_devices, device)
    cfg = CheckpointManager.load_config(ckpt_dir)
    if cfg.model.task != "seg":
        raise ValueError("whole-scene eval is a segmentation protocol")
    log = _logger(lead, log_path)
    state = _restore(ckpt_dir, cfg, device)
    val_ds = make_dataset(cfg.data, "test", cfg.model.num_classes,
                          cfg.model.task)
    C = cfg.model.num_classes
    dev = state.device
    cm = torch.zeros((C, C), dtype=torch.int32, device=dev)
    vox_cm = np.zeros((C, C), np.int64)

    def metric_mask_for(labels, mask):
        # metric mask only: the forward sees every point, the ScanNet
        # protocol scores the annotated ones
        return (mask & (labels != cfg.model.ignore_label)
                if cfg.model.ignore_label is not None else mask)

    def score(acc, xyz, labels, mask):
        nonlocal cm, vox_cm
        mm = metric_mask_for(labels, mask)
        cm = cm + confusion_matrix(
            torch.as_tensor(acc[None], device=dev),
            torch.as_tensor(labels[None], device=dev), C,
            torch.as_tensor(mm[None], device=dev))
        vox_cm = vox_cm + voxel_confusion(xyz, acc, labels, mm, voxel_size,
                                          C)

    if scene_batch:
        from gridgcn_torch.parallel.resident_ml import (
            make_resident_ml_forward, resident_ml_seg_predict_scenes)

        mesh2d = pmesh.make_mesh2d(scene_batch, mesh_devices // scene_batch,
                                   pmesh.mesh_devices(device, mesh_devices))
        fwd2 = make_resident_ml_forward(cfg, mesh2d,
                                        axis_name=pmesh.SPACE_AXIS,
                                        batch_axis=pmesh.DATA_AXIS)
        S = val_ds.size
        for g0 in range(0, S, scene_batch):
            grp = list(range(g0, min(g0 + scene_batch, S)))
            grp_p = grp + [grp[0]] * (scene_batch - len(grp))
            xyzs = np.stack([val_ds.points[i] for i in grp_p])
            feats = (np.stack([val_ds.features[i] for i in grp_p])
                     if val_ds.features is not None else None)
            masks = np.ones(xyzs.shape[:2], bool)
            acc = None
            for v in range(votes):
                lg = resident_ml_seg_predict_scenes(
                    cfg, state.model, xyzs, masks, mesh2d,
                    rng=jaxrng.PRNGKey(1000 * g0 + v), feats=feats,
                    fwd=fwd2)
                acc = lg if acc is None else acc + lg
            for j, i in enumerate(grp):
                score(acc[j], xyzs[j], val_ds.labels[i], masks[j])
        s_ = summarize_confusion(cm)
        sv = summarize_confusion(torch.as_tensor(vox_cm,
                                                 dtype=torch.float32))
        s_["voxel_acc"] = sv["overall_acc"]
        log.log("whole_scene_eval", scenes=S, votes=votes,
                scene_batch=scene_batch,
                overall_acc=float(s_["overall_acc"]),
                mean_class_acc=float(s_["mean_class_acc"]),
                miou=float(s_["miou"]),
                voxel_size=voxel_size,
                voxel_acc=float(sv["overall_acc"]))
        log.close()
        return s_

    predict_resident = fwd_resident = None
    if resident_ml:
        from gridgcn_torch.parallel.resident_ml import (
            make_resident_ml_forward, resident_ml_seg_predict)
        fwd_resident = make_resident_ml_forward(cfg, mesh)
        predict_resident = resident_ml_seg_predict
    elif resident:
        from gridgcn_torch.parallel.resident import (
            make_resident_forward, resident_seg_predict)
        fwd_resident = make_resident_forward(cfg, mesh)
        predict_resident = resident_seg_predict

    for s in range(val_ds.size):
        xyz = val_ds.points[s]
        mask = np.ones(xyz.shape[0], bool)
        feat = None if val_ds.features is None else val_ds.features[s]
        if fwd_resident is not None:
            # the votes ride inside the tier, the partition made once
            acc = votes * predict_resident(
                cfg, state.model, xyz, mask, mesh,
                rng=jaxrng.PRNGKey(1000 * s), fwd=fwd_resident, votes=votes,
                feat=feat)
        else:
            acc = _whole_scene_votes(state.model, cfg, xyz, mask, feat,
                                     mesh, votes, s)
        score(acc, xyz, val_ds.labels[s], mask)
    s_ = summarize_confusion(cm)
    sv = summarize_confusion(torch.as_tensor(vox_cm, dtype=torch.float32))
    s_["voxel_acc"] = sv["overall_acc"]
    log.log("whole_scene_eval", scenes=val_ds.size, votes=votes,
            overall_acc=float(s_["overall_acc"]),
            mean_class_acc=float(s_["mean_class_acc"]),
            miou=float(s_["miou"]),
            voxel_size=voxel_size,
            voxel_acc=float(sv["overall_acc"]))
    log.close()
    return s_


@torch.no_grad()
@full_fp32()
def _whole_scene_votes(model, cfg, xyz, mask, feat, mesh, votes: int,
                       s: int) -> np.ndarray:
    """Scene s's logits [N, C] summed over the votes (keys
    PRNGKey(1000·s + v)), on this device or tier-1 sharded over the
    mesh."""
    dev = next(model.parameters()).device
    C = cfg.model.num_classes
    if mesh is not None:      # vote-invariant partition geometry
        halo = required_halo(cfg, float(np.ptp(xyz, axis=0).max()))
        capacity = suggest_capacity(xyz, mask, mesh.size, halo)
    acc = None
    for v in range(votes):
        key = jaxrng.PRNGKey(1000 * s + v)
        if mesh is not None:
            lg = sharded_scene_apply(
                _slab_forward(model, key, feat is not None), xyz, mask,
                mesh, halo=halo, capacity=capacity, num_outputs=C,
                feat=feat)
        else:
            lg = model(torch.as_tensor(xyz[None], device=dev),
                       None if feat is None
                       else torch.as_tensor(feat[None], device=dev),
                       torch.as_tensor(mask[None], device=dev),
                       key)[0].float().cpu().numpy()
        acc = lg if acc is None else acc + lg
    return acc


def _slab_forward(model, key, with_feat: bool):
    """The tier-1 apply function: the eval model on a rank's slabs, rows
    [row0, row0 + d) of the slab batch, under the vote's key."""
    if with_feat:
        return lambda x, f, m, row0: model(x, f, m, key, row0=row0)
    return lambda x, m, row0: model(x, None, m, key, row0=row0)


def _whole_scene_worker(*args):
    return _host(evaluate_whole_scenes(*args))


def evaluate_s3dis_rooms(ckpt_dir: str, votes: int = 1, log_path=None,
                         quant: float = 1e-3, device="cuda"):
    """S3DIS room-level eval: every test block is forwarded (votes with
    keys PRNGKey(1000·r + v)), the block logits are merged back into whole
    rooms by quantized room-frame position (feature columns 3:6), summing
    where blocks overlap, and the metrics count the merged room points."""
    cfg = CheckpointManager.load_config(ckpt_dir)
    if cfg.model.task != "seg":
        raise ValueError("room-level eval is a segmentation protocol")
    log = MetricLogger(log_path)
    state = _restore(ckpt_dir, cfg, device)
    dev = state.device

    xyz, feats, labels, room_ids, names = load_s3dis_rooms(
        cfg.data.root, "test", cfg.data.num_points,
        holdout=cfg.data.s3dis_holdout)
    C = cfg.model.num_classes
    cm = torch.zeros((C, C), dtype=torch.int32)
    B = cfg.data.eval_batch_size
    for r in range(len(names)):
        sel = np.nonzero(room_ids == r)[0]
        blk_logits = np.zeros((len(sel), xyz.shape[1], C), np.float32)
        for i0 in range(0, len(sel), B):
            idx = sel[i0:i0 + B]
            pad = B - len(idx)
            bx = np.concatenate([xyz[idx], np.zeros((pad, *xyz.shape[1:]),
                                                    xyz.dtype)])
            bf = np.concatenate([feats[idx],
                                 np.zeros((pad, *feats.shape[1:]),
                                          feats.dtype)])
            x = torch.as_tensor(bx, device=dev)
            f = torch.as_tensor(bf, device=dev)
            m = torch.ones((B, xyz.shape[1]), dtype=torch.bool, device=dev)
            acc = None
            with torch.no_grad(), full_fp32():
                for v in range(votes):
                    lg = state.model(x, f, m, jaxrng.PRNGKey(1000 * r + v))
                    acc = lg if acc is None else acc + lg
            blk_logits[i0:i0 + len(idx)] = acc[:len(idx)].float().cpu().numpy()
        # merge on normalized room xyz (feature cols 3:6)
        pos = feats[sel][..., 3:6]
        merged, first = merge_block_logits(pos, blk_logits,
                                           np.ones(pos.shape[:2], bool),
                                           quant=quant)
        room_labels = labels[sel].reshape(-1)[first]
        cm = cm + confusion_matrix(
            torch.as_tensor(merged)[None], torch.as_tensor(room_labels)[None],
            C, torch.ones((1, len(merged)), dtype=torch.bool))
    s_ = summarize_confusion(cm)
    log.log("s3dis_room_eval", rooms=len(names), votes=votes,
            overall_acc=float(s_["overall_acc"]),
            mean_class_acc=float(s_["mean_class_acc"]),
            miou=float(s_["miou"]),
            iou_per_class=[round(float(x), 4)
                           for x in s_["iou_per_class"]])
    log.close()
    return s_


def check_target(name: str, summary: dict):
    """Reference-parity gate: compares the protocol's metric with the
    published target in accuracy_targets.json (package data, beside this
    file); prints the verdict and exits 1 below it, 2 when the protocol
    does not produce the metric."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "accuracy_targets.json")
    with open(path) as f:
        spec = json.load(f)[name]
    metric, target = spec["metric"], float(spec["target"])
    if metric not in summary:
        print(f"PARITY {name}: metric '{metric}' not produced by this "
              f"protocol — run the protocol in accuracy_targets.json: "
              f"{spec.get('protocol')}", file=sys.stderr)
        raise SystemExit(2)
    value = float(summary[metric])
    ok = value >= target
    print(f"PARITY {name}: {metric}={value:.4f} "
          f"{'>=' if ok else '<'} target {target:.4f} → "
          f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)


def main(argv=None):
    p = argparse.ArgumentParser(description="gridgcn_torch evaluator")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to evaluate (cuda raises without a card)")
    p.add_argument("--latency", action="store_true")
    p.add_argument("--whole-scene", action="store_true",
                   help="full-scene seg eval with logit voting")
    p.add_argument("--s3dis-rooms", action="store_true",
                   help="S3DIS room-level block-merging eval (mIoU over "
                        "rooms reassembled from blocks)")
    p.add_argument("--voxel-size", type=float, default=0.05,
                   help="whole-scene: grid size for the per-voxel accuracy "
                        "metric (ScanNet protocol)")
    p.add_argument("--votes", type=int, default=None,
                   help="whole-scene: CAGQ-seed voting rounds (default 3); "
                        "standard eval: up-axis rotation-voting rounds "
                        "(default 1)")
    p.add_argument("--mesh", type=int, default=0,
                   help="run over N devices of --device: the data-parallel "
                        "eval step, or (--whole-scene) each scene "
                        "spatially sharded, tier 1")
    p.add_argument("--resident", action="store_true",
                   help="with --mesh --whole-scene: tier 2 (the dense level "
                        "sharded, the coarse pyramid replicated after one "
                        "all-gather) instead of per-slab re-runs")
    p.add_argument("--resident-ml", action="store_true",
                   help="with --mesh --whole-scene: tier 3 (every level "
                        "sharded, boundary halos exchanged between ring "
                        "neighbours)")
    p.add_argument("--scene-batch", type=int, default=0,
                   help="with --mesh N --resident-ml: B scenes at a time on "
                        "a B x N/B mesh (B must divide N)")
    p.add_argument("--log", default=None)
    p.add_argument("--target", default=None,
                   choices=["modelnet40", "s3dis", "scannet"],
                   help="parity gate: compare the protocol's metric against "
                        "the reference's published number "
                        "(accuracy_targets.json) and exit nonzero below it")
    args = p.parse_args(argv)
    if args.votes is not None and args.votes < 1:
        p.error(f"--votes must be >= 1, got {args.votes}")
    if args.s3dis_rooms:
        s = evaluate_s3dis_rooms(args.ckpt_dir,
                                 votes=1 if args.votes is None else args.votes,
                                 log_path=args.log, device=args.device)
    elif args.whole_scene:
        s = evaluate_whole_scenes(args.ckpt_dir,
                                  votes=3 if args.votes is None else args.votes,
                                  log_path=args.log,
                                  voxel_size=args.voxel_size,
                                  device=args.device,
                                  mesh_devices=args.mesh,
                                  resident=args.resident,
                                  resident_ml=args.resident_ml,
                                  scene_batch=args.scene_batch)
    else:
        s = evaluate(args.ckpt_dir, latency=args.latency,
                     votes=1 if args.votes is None else args.votes,
                     log_path=args.log, device=args.device,
                     mesh_devices=args.mesh)
    if args.target:
        check_target(args.target, s)


if __name__ == "__main__":
    sys.exit(main())
