"""The trainer CLI.

    python -m gridgcn_torch.train.train --preset scannet_seg \
        [--device cuda|cpu] [--mesh N] \
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
logs and checkpoints. The spatially sharded flags (`--spatial`, ...) are
parsed and refused: those tiers are not ported yet.
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

UNPORTED = ("the spatially sharded training tiers are not ported yet "
            "(ROADMAP queue 1, item 7: the resident tiers)")


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
                      mesh_devices)
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
                   help="spatially sharded training (not ported)")
    p.add_argument("--spatial-capacity", type=int, default=0,
                   help="per-shard point capacity (not ported)")
    p.add_argument("--ghost-cap", default="0",
                   help="tier-3 ghost buffer rows (not ported)")
    p.add_argument("--scene-batch", type=int, default=0,
                   help="whole scenes per spatial step (not ported)")
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
    if (args.spatial or args.spatial_capacity or args.ghost_cap != "0"
            or args.scene_batch):
        p.error(UNPORTED)

    cfg = presets.get(args.preset)
    if args.overrides:
        cfg = apply_overrides(cfg, parse_cli_overrides(args.overrides))
    train(cfg, log_path=args.log, tensorboard_dir=args.tensorboard,
          auto_capacity=args.auto_capacity, device=args.device,
          mesh_devices=args.mesh)


if __name__ == "__main__":
    sys.exit(main())
