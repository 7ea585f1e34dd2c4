"""The trainer CLI.

    python -m gridgcn_torch.train.train --preset scannet_seg \
        [--device cuda|cpu] [--mesh N] \
        [--spatial resident|resident-ml [--spatial-capacity C]
         [--ghost-cap 0|H|auto] [--scene-batch B]] \
        [--auto-capacity off|propose|apply] \
        [--log FILE] [--tensorboard DIR] [key=value ...]

One CLI for every task; the preset decides classification or
segmentation, and positional `a.b=c` arguments override its fields
(`train.epochs=2 train.ckpt_dir=ck`). The loop is the JAX package's: the
newest checkpoint under `train.ckpt_dir` is restored at start, each
epoch's batches are shuffled with seed `train.seed + epoch`, one jaxrng
key drives every step, eval runs every `eval_every` epochs with key
`PRNGKey(10000 + epoch)`, a checkpoint is written every `ckpt_every`
epochs and after the last, and the metrics go out as JSONL records
(config, capacity, restore, train_step, epoch, eval). It runs on the card
unless `--device cpu` is given. `--mesh N` trains data-parallel over N
ranks (`parallel.dp`; N worker processes on this host, or the processes of
a `torchrun` launch): each rank takes its rows of the same global batch,
the step is the single-device step on the global batch, and only rank 0
logs and checkpoints. `--spatial resident|resident-ml` with `--mesh N`
trains on whole scenes sharded over the N ranks (`train_spatial`, the
resident tiers of `parallel.spatial_train`); `--scene-batch B` trains B
scenes per step on a B × N/B mesh (tier 3).
"""

from __future__ import annotations

import argparse
import io
import dataclasses
import sys
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from gridgcn_torch.configs import presets
from gridgcn_torch.configs.base import (
    Config, apply_overrides, parse_cli_overrides, to_json)
from gridgcn_torch.data.augment import augment_batch
from gridgcn_torch.data.pipeline import Prefetcher, make_dataset, to_device
from gridgcn_torch.models.build import init_model
from gridgcn_torch.parallel.launch import launch
from gridgcn_torch.parallel import mesh as pmesh
from gridgcn_torch.train.metrics import summarize_confusion
from gridgcn_torch.train.steps import (
    class_weights_from_dataset, create_train_state, make_eval_step,
    make_train_step)
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.checkpoint import CheckpointManager
from gridgcn_torch.utils.debug import (
    audit_layer0_capacity, propose_layer0_capacity)
from gridgcn_torch.utils.logging import MetricLogger

def _log_capacity(log: MetricLogger, cfg: Config, ds,
                  auto_capacity: str = "off") -> Config:
    """The step-0 layer-0 capacity audit on the training data, logged. When
    the configured nv drops more than the budget: 'propose' also logs the
    smallest (nv, resolution) that fits, 'apply' trains with it, 'off'
    warns. Returns the (possibly updated) config."""
    report = audit_layer0_capacity(cfg, ds.points)
    log.log("capacity", **report)
    if not report["over_budget"]:
        return cfg
    if auto_capacity in ("propose", "apply"):
        prop = propose_layer0_capacity(cfg, ds.points,
                                       budget=report["budget"])
        log.log("capacity_proposal",
                applied=(auto_capacity == "apply" and prop["within_budget"]),
                **prop)
        if auto_capacity == "apply" and prop["within_budget"]:
            l0 = dataclasses.replace(cfg.model.layers[0], nv=prop["nv"],
                                     resolution=prop["resolution"])
            return dataclasses.replace(
                cfg, model=dataclasses.replace(
                    cfg.model, layers=(l0,) + cfg.model.layers[1:]))
        return cfg
    warnings.warn(
        f"layer-0 voxel table drops {report['dropped_frac']:.1%} of "
        f"points on this dataset (> {report['budget']:.0%} budget); "
        f"raise layers[0].nv (={report['nv']}) or resolution "
        f"(={report['resolution']}), or rerun with --auto-capacity apply",
        RuntimeWarning, stacklevel=2)
    return cfg


def train(cfg: Config, log_path: str | None = None,
          tensorboard_dir: str | None = None, auto_capacity: str = "off",
          device="cuda", mesh_devices: int = 0):
    """Train cfg on one device (CUDA unless device="cpu"; "cuda" raises
    without a card), resuming from the newest checkpoint in
    cfg.train.ckpt_dir. Returns the final `steps.TrainState`.

    mesh_devices=N trains data-parallel over N ranks of `device`: outside
    a process group it starts N workers that each run this function and
    returns None when they are done; inside one (a worker, or `torchrun`)
    it is this rank's part and returns this rank's state."""
    if mesh_devices and not dist.is_initialized():
        return launch(_train_worker, pmesh.mesh_devices(device, mesh_devices),
                      cfg, log_path, tensorboard_dir, auto_capacity, device,
                      mesh_devices, timeout_s=None)
    mesh = (pmesh.make_mesh(mesh_devices,
                            pmesh.mesh_devices(device, mesh_devices))
            if mesh_devices else None)
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        device = mesh.device
    log = (MetricLogger(log_path, tensorboard_dir=tensorboard_dir) if lead
           else MetricLogger(stream=io.StringIO()))
    log.log("config", name=cfg.name, config=to_json(cfg))

    train_ds = make_dataset(cfg.data, "train", cfg.model.num_classes,
                            cfg.model.task)
    val_ds = make_dataset(cfg.data, "test", cfg.model.num_classes,
                          cfg.model.task)
    steps_per_epoch = (cfg.train.steps_per_epoch
                       or train_ds.steps_per_epoch(cfg.data.batch_size))
    cfg = _log_capacity(log, cfg, train_ds, auto_capacity)

    model, state_dict = init_model(
        cfg.model, torch.Generator().manual_seed(cfg.train.seed))
    state = create_train_state(cfg, model, state_dict, steps_per_epoch,
                               device=device)

    class_weights = None
    if cfg.train.class_weighting and cfg.model.task == "seg":
        class_weights = class_weights_from_dataset(
            train_ds.labels, cfg.model.num_classes,
            ignore_label=cfg.model.ignore_label)
    train_step = make_train_step(cfg, class_weights=class_weights, mesh=mesh)
    eval_step = make_eval_step(cfg, mesh=mesh)

    if not lead:          # rank 0 writes the directory's config first
        mesh.sum(torch.zeros(1, device=device))
    ckpt = CheckpointManager(cfg.train.ckpt_dir, cfg, keep=cfg.train.keep_ckpts)
    if mesh is not None and lead:
        mesh.sum(torch.zeros(1, device=device))
    rng = jaxrng.PRNGKey(cfg.train.seed)
    restored = ckpt.restore(state, rng)
    start_epoch = 0
    if restored is not None:
        state, rng = restored["state"], restored.get("rng", rng)
        start_epoch = state.step // steps_per_epoch
        log.log("restore", step=state.step, epoch=start_epoch)

    def put(batch):
        return to_device(batch if mesh is None else pmesh.shard_batch(batch, mesh),
                         state.device)

    for epoch in range(start_epoch, cfg.train.epochs):
        t_ep = time.time()
        losses, accs = [], []
        # background host-side assembly and device staging overlap the steps
        for batch in Prefetcher(
                train_ds.batches(cfg.data.batch_size,
                                 seed=cfg.train.seed + epoch), put):
            state, m = train_step(state, batch, rng)
            losses.append(m["loss"])
            accs.append(m["acc"])
            if (cfg.train.log_every > 0
                    and state.step % cfg.train.log_every == 0):
                log.log("train_step", step=state.step,
                        loss=float(m["loss"]), acc=float(m["acc"]),
                        lr=float(m["lr"]), grad_norm=float(m["grad_norm"]))
        pts_per_sec = (steps_per_epoch * cfg.data.batch_size
                       * cfg.data.num_points) / max(time.time() - t_ep, 1e-9)
        log.log("epoch", epoch=epoch,
                loss=float(np.mean(torch.stack(losses).cpu().numpy())),
                acc=float(np.mean(torch.stack(accs).cpu().numpy())),
                points_per_sec=pts_per_sec)

        if cfg.train.eval_every > 0 and (
                (epoch + 1) % cfg.train.eval_every == 0
                or epoch == cfg.train.epochs - 1):
            C = cfg.model.num_classes
            cm = torch.zeros((C, C), dtype=torch.int32, device=state.device)
            ek = jaxrng.PRNGKey(10_000 + epoch)
            for batch in val_ds.batches(cfg.data.eval_batch_size,
                                        seed=0, shuffle=False,
                                        drop_last=False):
                cm = cm + eval_step(state, put(batch), ek)
            s = summarize_confusion(cm)
            log.log("eval", epoch=epoch,
                    overall_acc=float(s["overall_acc"]),
                    mean_class_acc=float(s["mean_class_acc"]),
                    miou=float(s["miou"]))

        if lead and ((cfg.train.ckpt_every > 0
                      and (epoch + 1) % cfg.train.ckpt_every == 0)
                     or epoch == cfg.train.epochs - 1):
            ckpt.save(state.step, state, rng)
    ckpt.wait()
    log.close()
    return state


def _train_worker(*args):
    """One rank of a launched `train`: the state stays in the worker."""
    train(*args)


def train_spatial(cfg: Config, mesh_devices: int,
                  log_path: str | None = None, capacity: int = 0,
                  tier: str = "resident",
                  tensorboard_dir: str | None = None, ghost_cap="0",
                  auto_capacity: str = "off", scene_batch: int = 0,
                  device="cuda"):
    """Spatially sharded training on whole scenes over mesh_devices ranks
    of `device` (the JAX package's `train_spatial`): each step trains one
    whole scene cut into slabs over the mesh with the tier-2
    (`tier="resident"`) or tier-3 (`"resident_ml"`) forward; with
    scene_batch B > 1 (tier 3, B dividing the mesh) B scenes per step on
    a B × mesh/B mesh, the last incomplete group of an epoch dropped. The
    scenes are augmented whole on the CPU before they are cut, under key
    fold_in(fold_in(PRNGKey(seed + 71717), epoch), first scene). capacity:
    the per-shard points (0: 2N/D rounded up to 256, at most N; a scene
    that overflows it runs at N). ghost_cap: tier 3's ghost rows per face,
    an int ("0": the full share) or "auto" (calibrated on up to 8 training
    scenes, logged as a `ghost_cap` record). There is no eval. Outside a
    process group it starts the ranks and returns None; inside one, this
    rank's state."""
    if cfg.model.task != "seg":
        raise ValueError("--spatial training is a segmentation protocol")
    if scene_batch and scene_batch > 1:
        if tier != "resident_ml":
            raise ValueError("--scene-batch spatial training is a tier-3 "
                             "(resident-ml) protocol")
        if mesh_devices % scene_batch:
            raise ValueError(f"--scene-batch {scene_batch} must divide "
                             f"--mesh {mesh_devices}")
    else:
        scene_batch = 0
    if not dist.is_initialized():
        return launch(_train_spatial_worker,
                      pmesh.mesh_devices(device, mesh_devices), cfg,
                      mesh_devices, log_path, capacity, tier,
                      tensorboard_dir, ghost_cap, auto_capacity, scene_batch,
                      device, timeout_s=None)
    from gridgcn_torch.parallel.resident_ml import calibrate_ghost_cap
    from gridgcn_torch.parallel.spatial_train import (
        make_spatial_train_step, shard_scene_batch, shard_scene_batches)

    devs = pmesh.mesh_devices(device, mesh_devices)
    if scene_batch:
        mesh = pmesh.make_mesh2d(scene_batch, mesh_devices // scene_batch,
                                 devs)
        D = mesh_devices // scene_batch      # slabs per scene
    else:
        mesh = pmesh.make_mesh(mesh_devices, devs)
        D = mesh_devices
    lead = mesh.rank == 0
    log = (MetricLogger(log_path, tensorboard_dir=tensorboard_dir) if lead
           else MetricLogger(stream=io.StringIO()))
    log.log("config", name=cfg.name, config=to_json(cfg), spatial=True)

    train_ds = make_dataset(cfg.data, "train", cfg.model.num_classes,
                            cfg.model.task)
    cfg = _log_capacity(log, cfg, train_ds, auto_capacity)
    # optimizer steps per epoch: one per scene, or one per scene group
    # (the JAX package sizes the scene-batched schedule by the scene
    # count, B times too many steps; this is the count the loop takes)
    opt_steps_per_epoch = (train_ds.size // scene_batch if scene_batch
                           else train_ds.size)
    steps_per_epoch = cfg.train.steps_per_epoch or opt_steps_per_epoch
    model, state_dict = init_model(
        cfg.model, torch.Generator().manual_seed(cfg.train.seed))
    state = create_train_state(cfg, model, state_dict, steps_per_epoch,
                               device=mesh.device)
    N = cfg.data.num_points
    if not capacity:
        capacity = min(N, ((2 * N // D + 255) // 256) * 256)

    class_weights = None
    if cfg.train.class_weighting:
        class_weights = class_weights_from_dataset(
            train_ds.labels, cfg.model.num_classes,
            ignore_label=cfg.model.ignore_label)
    caps = 0
    if str(ghost_cap) == "auto" and tier == "resident_ml":
        per_scene = [calibrate_ghost_cap(cfg, train_ds.points[i],
                                         np.ones(N, bool), D)
                     for i in range(min(train_ds.size, 8))]
        caps = tuple(int(max(c)) for c in zip(*per_scene))
        log.log("ghost_cap", caps=list(caps))
    elif str(ghost_cap) not in ("0", "auto"):
        caps = int(ghost_cap)
    step = make_spatial_train_step(
        cfg, mesh, class_weights=class_weights, tier=tier, ghost_cap=caps,
        batch_axis=pmesh.DATA_AXIS if scene_batch else None)

    if not lead:          # rank 0 writes the directory's config first
        mesh.sum(torch.zeros(1, device=mesh.device))
    ckpt = CheckpointManager(cfg.train.ckpt_dir, cfg, keep=cfg.train.keep_ckpts)
    if lead:
        mesh.sum(torch.zeros(1, device=mesh.device))
    rng = jaxrng.PRNGKey(cfg.train.seed)
    restored = ckpt.restore(state, rng)
    start_epoch = 0
    if restored is not None:
        state, rng = restored["state"], restored.get("rng", rng)
        start_epoch = state.step // max(opt_steps_per_epoch, 1)
        log.log("restore", step=state.step, epoch=start_epoch)

    aug_key = jaxrng.PRNGKey(int(cfg.train.seed) + 71_717)
    for epoch in range(start_epoch, cfg.train.epochs):
        t_ep = time.time()
        losses, accs, overflows = [], [], []
        order = np.random.default_rng(cfg.train.seed + epoch).permutation(
            train_ds.size)
        B = scene_batch or 1
        groups = [order[i:i + B] for i in range(0, len(order) - B + 1, B)]
        for grp in groups:
            xyz = np.stack([train_ds.points[i] for i in grp])
            labels = np.stack([train_ds.labels[i] for i in grp])
            feat = (np.stack([train_ds.features[i] for i in grp])
                    if train_ds.features is not None else None)
            masks = np.ones(xyz.shape[:2], bool)
            if cfg.data.augment:
                # the whole scene on the CPU, before it is cut: the
                # rotation precedes the slab cut, dropout rides the mask
                ax, am, af = augment_batch(
                    torch.as_tensor(xyz), torch.as_tensor(masks),
                    jaxrng.fold_in(jaxrng.fold_in(aug_key, epoch),
                                   int(grp[0])),
                    cfg.data,
                    None if feat is None else torch.as_tensor(feat))
                xyz, masks = ax.numpy(), am.numpy()
                feat = None if af is None else af.numpy()
            for cap in (capacity, N):     # a dense slab overflowing: N
                try:
                    batch = (shard_scene_batches(cfg, xyz, labels, masks,
                                                 mesh, cap, feats=feat)
                             if scene_batch else
                             shard_scene_batch(cfg, xyz[0], labels[0],
                                               masks[0], mesh, cap,
                                               feat=None if feat is None
                                               else feat[0]))
                    break
                except ValueError:
                    if cap == N:
                        raise
            state, m = step(state, batch, rng)
            losses.append(m["loss"])
            accs.append(m["acc"])
            if "ghost_overflow" in m:
                overflows.append(m["ghost_overflow"])
            if (cfg.train.log_every > 0
                    and state.step % cfg.train.log_every == 0):
                log.log("train_step", step=state.step,
                        loss=float(m["loss"]), acc=float(m["acc"]),
                        grad_norm=float(m["grad_norm"]))
        n_over = int(sum(int(o) for o in overflows))
        if n_over:
            warnings.warn(
                f"resident-ml training: {n_over} boundary rows overflowed "
                f"the per-face ghost buffers this epoch (ghost_cap="
                f"{caps!r}); raise --ghost-cap or re-run calibration with "
                f"a higher safety factor", RuntimeWarning, stacklevel=2)
        log.log("epoch", epoch=epoch,
                loss=float(np.mean(torch.stack(losses).cpu().numpy())),
                acc=float(np.mean(torch.stack(accs).cpu().numpy())),
                ghost_overflow=n_over,
                points_per_sec=train_ds.size * N
                / max(time.time() - t_ep, 1e-9))
        if lead and ((cfg.train.ckpt_every > 0
                      and (epoch + 1) % cfg.train.ckpt_every == 0)
                     or epoch == cfg.train.epochs - 1):
            ckpt.save(state.step, state, rng)
    ckpt.wait()
    log.close()
    return state


def _train_spatial_worker(*args):
    """One rank of a launched `train_spatial`."""
    train_spatial(*args)


def main(argv=None):
    p = argparse.ArgumentParser(description="gridgcn_torch trainer")
    p.add_argument("--preset", default="modelnet40_full",
                   choices=sorted(presets.PRESETS))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train (cuda raises without a card)")
    p.add_argument("--mesh", type=int, default=0,
                   help="train data-parallel over N devices of --device "
                        "(N worker processes, or the ranks of torchrun)")
    p.add_argument("--spatial", choices=["resident", "resident-ml"],
                   default=None,
                   help="with --mesh N: train on whole scenes, each cut "
                        "into slabs over the N ranks (tier 2 or tier 3)")
    p.add_argument("--spatial-capacity", type=int, default=0,
                   help="per-shard point capacity (0 = auto)")
    p.add_argument("--ghost-cap", default="0",
                   help="tier-3 per-face ghost buffer rows: an int, 0 = "
                        "the full share, or 'auto' = calibrated on the "
                        "training scenes")
    p.add_argument("--scene-batch", type=int, default=0,
                   help="with --spatial resident-ml: B whole scenes per "
                        "step on a B x N/B mesh")
    p.add_argument("--auto-capacity", choices=["off", "propose", "apply"],
                   default="off",
                   help="step-0 layer-0 capacity audit action when the "
                        "dropped-point budget is exceeded: 'propose' logs "
                        "the smallest (nv, resolution) bump that fits, "
                        "'apply' trains with it")
    p.add_argument("--log", default=None, help="JSONL metrics file")
    p.add_argument("--tensorboard", default=None, metavar="DIR",
                   help="also write metric scalars as TensorBoard events")
    p.add_argument("overrides", nargs="*",
                   help="config overrides, e.g. train.lr=3e-4")
    args = p.parse_args(argv)

    cfg = presets.get(args.preset)
    if args.overrides:
        cfg = apply_overrides(cfg, parse_cli_overrides(args.overrides))
    if args.spatial:
        if not args.mesh:
            p.error("--spatial requires --mesh N")
        train_spatial(cfg, mesh_devices=args.mesh, log_path=args.log,
                      capacity=args.spatial_capacity,
                      tier=args.spatial.replace("-", "_"),
                      tensorboard_dir=args.tensorboard,
                      ghost_cap=args.ghost_cap,
                      auto_capacity=args.auto_capacity,
                      scene_batch=args.scene_batch, device=args.device)
    else:
        train(cfg, log_path=args.log, tensorboard_dir=args.tensorboard,
              auto_capacity=args.auto_capacity, device=args.device,
              mesh_devices=args.mesh)


if __name__ == "__main__":
    sys.exit(main())
