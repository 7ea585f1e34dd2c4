"""Spatially sharded training on whole scenes (the JAX package's
`parallel/spatial_train.py`).

Each training example is one whole scene cut into slabs over the mesh
(`shard_scene_batch`; B scenes on a 2-D mesh, `shard_scene_batches`), run
through the tier-2 or tier-3 forward with batch-statistics BatchNorm. The
loss is the cross-entropy of the points each rank owns (halo and padded
rows carry no weight), divided by the global weight: each rank's loss is
its share of the JAX package's loss over the whole [D, cap] array. Each
rank differentiates its share through the differentiable collectives,
and the parameter gradients are summed over every rank, which is what
`shard_map`'s transpose gives a replicated input. Then the global norm,
the clip and Adam (`train.steps.Adam`), on every rank alike. The
running statistics are each rank's folded statistics averaged over the
ring (and the scenes), as the tiers return them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from gridgcn_torch.configs.base import Config
from gridgcn_torch.models.layers import BatchNorm
from gridgcn_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS, Mesh
from gridgcn_torch.parallel.resident import (
    make_resident_forward, resident_halo, scene_bounds, write_stats)
from gridgcn_torch.parallel.resident_ml import make_resident_ml_forward
from gridgcn_torch.parallel.spatial import partition_scene, suggest_capacity
from gridgcn_torch.train.steps import TrainState, global_norm
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.precision import full_fp32

def make_spatial_train_step(cfg: Config, mesh: Mesh, class_weights=None,
                            tier: str = "resident", ghost_cap=0,
                            batch_axis: Optional[str] = None):
    """(state, scene_batch, rng) → (state, metrics), the state updated in
    place, over the tier-2 (`tier="resident"`) or tier-3
    (`tier="resident_ml"`) forward. scene_batch is this rank's part
    (`shard_scene_batch`; with `batch_axis`, tier 3 on a `make_mesh2d`
    mesh, `shard_scene_batches`). metrics, the same on every rank:
    "loss", "acc", "grad_norm", "lr" (the optimizer's schedule at the step
    count after the update) and, for tier 3, "ghost_overflow"."""
    if batch_axis is not None and tier != "resident_ml":
        raise ValueError("scene-batched (2-D mesh) spatial training is a "
                         "tier-3 (resident_ml) protocol")
    if tier == "resident":
        fwd = make_resident_forward(cfg, mesh, train=True)
    elif tier == "resident_ml":
        fwd = make_resident_ml_forward(
            cfg, mesh, train=True, ghost_cap=ghost_cap,
            axis_name=DATA_AXIS if batch_axis is None else SPACE_AXIS,
            batch_axis=batch_axis)
    else:
        raise ValueError(f"unknown spatial tier: {tier}")
    C = cfg.model.num_classes

    def step(state: TrainState, batch: dict, rng: np.ndarray):
        model, dev = state.model, state.device
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        key = jaxrng.fold_in(rng, state.step)
        if batch_axis is not None:
            # one key per scene; this rank's row takes its scenes' keys
            data = mesh.axis(batch_axis)
            Bl = b["sx"].shape[0]
            key = jaxrng.split(key, Bl * data.size)[
                data.rank * Bl:(data.rank + 1) * Bl]
        pos = ((b["sx"], b["sf"], b["sm"]) if cfg.model.in_channels
               else (b["sx"], b["sm"]))
        geo = b["vsize"] if tier == "resident" else b["extent"]
        params = state.tx.params
        labels = b["label"].long()
        with full_fp32():
            with torch.enable_grad():
                out = fwd(model, *pos, b["edges"], b["origin"], geo, key)
                logits, stats = out[0].float(), out[-1]
                onehot = F.one_hot(labels, C).to(logits.dtype)
                ce = -(onehot * F.log_softmax(logits, -1)).sum(-1)
                owned = b["owned"]
                if cfg.model.ignore_label is not None:
                    owned = owned & (labels != cfg.model.ignore_label)
                w = owned.to(ce.dtype)
                if class_weights is not None:
                    cw = torch.as_tensor(class_weights, device=dev)
                    w = w * (onehot * cw.to(ce.dtype)).sum(-1)
                denom = torch.clamp_min(mesh.sum(w.sum()), 1e-6)
                num = (ce * w).sum()
                grads = torch.autograd.grad(num / denom, params,
                                            allow_unused=True)
            with torch.no_grad():
                grads = mesh.sum_all([torch.zeros_like(p) if g is None
                                      else g for g, p in zip(grads, params)])
                loss = mesh.sum(num.detach()) / denom
                hits = (owned & (logits.argmax(-1) == labels)).sum()
                acc = (mesh.sum(hits).float()
                       / torch.clamp_min(mesh.sum(owned.sum()), 1).float())
                write_stats(model, stats)
                for m in model.modules():      # a remat backward's records
                    if isinstance(m, BatchNorm):
                        m.batch_stats = None
                grad_norm = global_norm(grads)
                state.tx.update(grads, grad_norm)
        metrics = {"loss": loss, "acc": acc, "grad_norm": grad_norm,
                   "lr": torch.tensor(state.tx.sched(state.step))}
        if tier == "resident_ml":
            metrics["ghost_overflow"] = mesh.sum(out[1].sum())
        return state, metrics

    return step


def _scene_part(cfg, xyz, labels, mask, n_shards, capacity, feat):
    """One scene's partition: (sx, sm, owned, label, sf or None, edges,
    origin, vsize, extent), numpy, every shard."""
    res0 = cfg.model.layers[0].resolution
    origin, vsize = scene_bounds(xyz, mask, res0)
    sx, sm, owned, sidx, edges = partition_scene(
        xyz, mask, n_shards, resident_halo(cfg, vsize), capacity)
    sf = None
    if cfg.model.in_channels:
        if feat is None:
            raise ValueError(
                f"cfg.model.in_channels={cfg.model.in_channels} requires "
                f"per-point feat [N, in_channels]")
        sf = feat[sidx] * sm[..., None].astype(feat.dtype)
    return (sx, sm, owned, (labels[sidx] * sm).astype(np.int32), sf, edges,
            origin, vsize, vsize * res0 / (1.0 + 1e-5))


_KEYS = ("sx", "sm", "owned", "label", "sf", "edges", "origin", "vsize",
         "extent")


def shard_scene_batch(cfg: Config, xyz: np.ndarray, labels: np.ndarray,
                      mask: np.ndarray, mesh: Mesh, capacity: int,
                      feat: Optional[np.ndarray] = None) -> dict:
    """One scene cut into slabs and ghost strips (the tier-2 halo) on the
    host; this rank's slab as numpy: sx [1, cap, 3], sm, owned, label
    [1, cap] (halo and padded rows are not owned and carry no loss),
    sf [1, cap, in_channels] when the config has input channels (feat
    [N, in_channels] required), and the scene's edges [D+1], origin,
    vsize and extent [3]."""
    part = _scene_part(cfg, xyz, labels, mask, mesh.size, capacity, feat)
    d = mesh.rank
    return {k: (v[d:d + 1] if i < 5 else v)
            for i, (k, v) in enumerate(zip(_KEYS, part)) if v is not None}


def shard_scene_batches(cfg: Config, scenes_xyz: np.ndarray,
                        labels: np.ndarray, masks: np.ndarray, mesh: Mesh,
                        capacity: Optional[int] = None,
                        feats: Optional[np.ndarray] = None) -> dict:
    """B scenes [B, N, 3] for scene-batched tier-3 training on a 2-D mesh:
    each scene partitioned as `shard_scene_batch` does over the ring, at
    one capacity (the largest need unless given); this rank's scenes (its
    row's B / rows) and slab, every array with a leading scene axis
    ([B_l, 1, cap, ...], edges [B_l, D+1], origin ... [B_l, 3])."""
    if mesh.shape is None or SPACE_AXIS not in mesh.shape:
        raise ValueError(f"need a ('{DATA_AXIS}', '{SPACE_AXIS}') mesh "
                         f"(make_mesh2d); got axes {mesh.axis_names}")
    ring, data = mesh.axis(SPACE_AXIS), mesh.axis(DATA_AXIS)
    scenes_xyz = np.asarray(scenes_xyz, np.float32)
    masks = np.asarray(masks, bool)
    labels = np.asarray(labels)
    B = scenes_xyz.shape[0]
    if B % data.size:
        raise ValueError(f"scene count {B} not divisible by the data axis "
                         f"({data.size})")
    if cfg.model.in_channels and feats is None:
        raise ValueError(f"cfg.model.in_channels={cfg.model.in_channels} "
                         f"requires feats [B, N, {cfg.model.in_channels}]")
    res0 = cfg.model.layers[0].resolution
    if capacity is None:
        needs = []
        for b in range(B):
            _, vsize = scene_bounds(scenes_xyz[b], masks[b], res0)
            needs.append(suggest_capacity(scenes_xyz[b], masks[b],
                                          ring.size,
                                          resident_halo(cfg, vsize)))
        capacity = max(needs)
    # every rank partitions every scene, so that all raise alike when a
    # slab outgrows the capacity
    parts = [_scene_part(cfg, scenes_xyz[b], labels[b], masks[b], ring.size,
                         capacity,
                         None if feats is None
                         else np.asarray(feats[b], np.float32))
             for b in range(B)]
    Bl = B // data.size
    parts = parts[data.rank * Bl:(data.rank + 1) * Bl]
    d = ring.rank
    out = {}
    for i, k in enumerate(_KEYS):
        if parts[0][i] is None:
            continue
        out[k] = np.stack([p[i][d:d + 1] if i < 5 else p[i] for p in parts])
    return out
