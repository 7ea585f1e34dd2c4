"""Spatial sharding, tier 2: the dense level sharded, the coarse pyramid
replicated (the JAX package's `parallel/resident.py`).

Tier 1 (`parallel.spatial`) re-runs the whole network on every slab, so its
halo must cover the reach of every encoder level. Tier 2 shards only the
dense level, where most of the work and all the N-sized memory are:

  * each rank holds one slab of the scene plus a ghost strip as wide as the
    finest grid's context reach (`resident_halo`), and builds layer 0's
    voxel table on the global grid (explicit bounds, so voxel planes align
    across ranks);
  * it samples its share M₁/D of layer-1 centers, keeps those whose
    position its slab owns, and one differentiable all-gather
    (`parallel.mesh.all_gather`) assembles the whole layer-1 level on every
    rank;
  * the coarse pyramid (layers 1.., decoder stages down to level 1) runs
    replicated, each rank with the same keys, and the last decoder stage
    and the head run on the rank's own slab again.

A forward takes this rank's slab and returns this rank's logits; ghost
rows' logits mean nothing (the caller masks them with `owned`). Training
(`parallel.spatial_train`) runs the same forward with batch-statistics
BatchNorm: each rank normalises with its own statistics, as a flax
BatchNorm without an axis name does inside `shard_map`, and the folded
running statistics are averaged over the ring afterwards.

Keys follow the JAX package: layer 0 and the last stage draw from
`fold_in(rng, d)` (d the rank's slab), the replicated pyramid from
`fold_in(rng, 10000 + i)`, the decoder's replicated stages from
`fold_in(rng, 10100 + i)`, the head's dropout from `fold_in(rng, 99000)`;
each piece is a fresh flax `apply`, so its stage key is
`flax_make_rng(key, ("gridconv{i}",), 1)` (a grid decoder stage: counter 1
in the root scope).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from gridgcn_torch.configs.base import Config
from gridgcn_torch.models.layers import BatchNorm
from gridgcn_torch.ops.voxelize import grid_bounds
from gridgcn_torch.parallel.mesh import (
    Mesh, all_gather, all_gather_exact)
from gridgcn_torch.parallel.spatial import partition_scene, suggest_capacity
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.precision import full_fp32


def scene_bounds(xyz: np.ndarray, mask: np.ndarray, resolution: int):
    """(origin [3], vsize [3]) float32 numpy: the scene's grid at
    `resolution` (`ops.voxelize.grid_bounds`, on the host)."""
    origin, vsize = grid_bounds(torch.as_tensor(xyz, dtype=torch.float32)[None],
                                torch.as_tensor(mask)[None], resolution)
    return origin[0].numpy(), vsize[0].numpy()


def _resident_centers(cfg: Config, n_shards: int) -> tuple:
    """Each layer's center count on one shard: layer 0 samples
    n_centers / D (each rank covers its slab), deeper layers keep theirs."""
    l0 = cfg.model.layers[0]
    if l0.n_centers % n_shards:
        raise ValueError(f"layers[0].n_centers={l0.n_centers} not "
                         f"divisible by {n_shards} shards")
    return (l0.n_centers // n_shards,
            *(layer.n_centers for layer in cfg.model.layers[1:]))


@contextlib.contextmanager
def sharded_centers(model, n_centers: Sequence[int]):
    """Inside the block, GridConv stage i of `model` samples n_centers[i]
    centers (parameter shapes do not depend on them, so the network's own
    weights serve every shard)."""
    convs = [getattr(model, f"gridconv{i}") for i in range(len(n_centers))]
    specs = [c.spec for c in convs]
    for c, n in zip(convs, n_centers):
        c.spec = dataclasses.replace(c.spec, n_centers=n)
    try:
        yield
    finally:
        for c, s in zip(convs, specs):
            c.spec = s


def stage_key(key, i: int):
    """The CAGQ key of GridConv stage i in a fresh `apply` under `key`."""
    return jaxrng.flax_make_rng(key, (f"gridconv{i}",), 1)


def grid_key(model, i: int, n_support: int, key):
    """Decoder stage i's voxel-build key in a fresh `apply` under `key`
    (None where the stage does not query the grid)."""
    return jaxrng.flax_make_rng(key, (), 1) if model.uses_grid(i, n_support) \
        else None


def input_features(cfg: Config, sx: torch.Tensor, sf):
    """The network's input features: xyz prefixed when use_xyz_feature."""
    if cfg.model.in_channels:
        return torch.cat([sx, sf], -1) if cfg.model.use_xyz_feature else sf
    return sx if cfg.model.use_xyz_feature else None


def ring_mean_stats(model, mesh: Mesh) -> dict:
    """Each BatchNorm's running statistics with its last training forward's
    folded in, averaged over the mesh's ranks (JAX's `pmean` of the
    mutated collection): {module name: (mean, var)}. The recorded batch
    statistics are forgotten."""
    bns = [(n, m) for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    flat = []
    for _, bn in bns:
        flat.extend(bn.folded_stats())
        bn.batch_stats = None
    if not flat:
        return {}
    summed = mesh.sum_all(flat)
    return {n: (summed[2 * i] / mesh.size, summed[2 * i + 1] / mesh.size)
            for i, (n, _) in enumerate(bns)}


@torch.no_grad()
def write_stats(model, stats: dict) -> None:
    """Set the named BatchNorms' running statistics."""
    mods = dict(model.named_modules())
    for name, (mean, var) in stats.items():
        mods[name].running_mean.copy_(mean)
        mods[name].running_var.copy_(var)


def make_resident_forward(cfg: Config, mesh: Mesh, train: bool = False,
                          _corrupt_gather: bool = False):
    """The tier-2 forward over a 1-D mesh:

        fwd(model, sx [1, cap, 3], sm [1, cap], edges [D+1], origin [3],
            vsize [3], rng) -> logits [1, cap, num_classes]

    on each rank for its own slab (`partition_scene`'s row `mesh.rank`),
    with sf [1, cap, in_channels] after sx when the config has input
    channels. `model` is the network (its weights; the forward sets its
    mode). With train=True the BatchNorms take batch statistics, dropout
    is live, and fwd returns (logits, stats): the running statistics
    folded and averaged over the ring (`ring_mean_stats`), not yet
    written. `_corrupt_gather` (tests only) rolls the assembled layer-1
    features by one row, a mis-assembled level."""
    if cfg.model.task != "seg":
        raise ValueError("resident forward is for segmentation models")
    C_in = cfg.model.in_channels
    n_layers = len(cfg.model.layers)
    centers = _resident_centers(cfg, mesh.size)
    drop = train and cfg.model.dropout > 0

    def forward(model, sx, sf, sm, edges, origin, vsize, rng):
        dev = sx.device
        d = mesh.rank
        model.train(train)
        k_local = jaxrng.fold_in(rng, d)
        feat0 = input_features(cfg, sx, sf)
        edges = torch.as_tensor(edges, device=dev)
        bounds = (torch.as_tensor(origin, device=dev)[None],
                  torch.as_tensor(vsize, device=dev)[None])
        with sharded_centers(model, centers):
            # layer 0: sharded, on the global grid
            c_xyz, c_feat, c_valid = model.encode_layer(
                0, sx, feat0, sm, stage_key(k_local, 0), bounds)
            # a center belongs to the rank whose slab contains it
            cx = c_xyz[0, :, 0]
            own = c_valid[0] & (cx >= edges[d]) & (cx < edges[d + 1])
            # the one exchange: the whole layer-1 level on every rank
            g_xyz = all_gather(c_xyz[0], mesh)[None]
            g_feat = all_gather(c_feat[0], mesh)[None]
            g_valid = all_gather(own, mesh)[None]
            if _corrupt_gather:
                g_feat = torch.roll(g_feat, 1, dims=1)

            # the coarse pyramid, replicated
            levels = [(g_xyz, g_feat, g_valid)]
            xyz, feat, mask = levels[0]
            for i in range(1, n_layers):
                xyz, feat, mask = model.encode_layer(
                    i, xyz, feat, mask,
                    stage_key(jaxrng.fold_in(rng, 10_000 + i), i))
                levels.append((xyz, feat, mask))
            c_xyz2, c_feat2, c_mask2 = levels[-1]
            for i in range(n_layers - 1):
                d_xyz, d_feat, d_mask = levels[-2 - i]
                c_feat2 = model.decode_stage(
                    i, c_xyz2, c_feat2, c_mask2, d_xyz, d_feat, d_mask,
                    grid_key(model, i, c_xyz2.shape[1],
                             jaxrng.fold_in(rng, 10_100 + i)))
                c_xyz2, c_mask2 = d_xyz, d_mask

            # the last stage and the head: on the rank's slab
            x = model.decode_stage(
                n_layers - 1, c_xyz2, c_feat2, c_mask2, sx, feat0, sm,
                grid_key(model, n_layers - 1, c_xyz2.shape[1], k_local))
            logits = model.head_logits(
                x, jaxrng.fold_in(rng, 99_000) if drop else None)
        if not train:
            return logits
        return logits, ring_mean_stats(model, mesh)

    if C_in:
        return forward

    def fwd(model, sx, sm, edges, origin, vsize, rng):
        return forward(model, sx, None, sm, edges, origin, vsize, rng)
    return fwd


def resident_halo(cfg: Config, vsize: np.ndarray) -> float:
    """The ghost strip of the sharded level: the finest grid's context
    reach, (context // 2 + 1) layer-0 voxels."""
    reach = cfg.model.layers[0].context // 2 + 1
    return float(reach * np.max(vsize))


def slab_inputs(cfg: Config, sx, sm, sidx, rows, device, feat=None):
    """The slabs `rows` of a partition as tensors on `device`:
    (sx, [sf,] sm), the features (feat [N, in_channels], required when the
    config has input channels) riding the same partition."""
    if cfg.model.in_channels and feat is None:
        raise ValueError(f"cfg.model.in_channels={cfg.model.in_channels} "
                         f"requires per-point feat [N, in_channels]")
    x = torch.as_tensor(sx[rows], device=device)
    m = torch.as_tensor(sm[rows], device=device)
    if not cfg.model.in_channels:
        return x, m
    sf = feat[sidx[rows]] * sm[rows][..., None].astype(feat.dtype)
    return x, torch.as_tensor(sf, device=device), m


def stitch(logits: np.ndarray, owned: np.ndarray, sidx: np.ndarray,
           n: int) -> np.ndarray:
    """[n, C] logits in the original point order from the shards'
    [D, cap, C]: each point from the shard that owns it, zeros for
    points no shard owns."""
    C = logits.shape[-1]
    out = np.zeros((n, C), logits.dtype)
    flat = owned.reshape(-1)
    out[sidx.reshape(-1)[flat]] = logits.reshape(-1, C)[flat]
    return out


def resident_seg_predict(cfg: Config, model, xyz: np.ndarray,
                         mask: np.ndarray, mesh: Mesh,
                         capacity: Optional[int] = None,
                         rng: Optional[np.ndarray] = None,
                         fwd=None, votes: int = 1,
                         feat: Optional[np.ndarray] = None,
                         halo: Optional[float] = None) -> np.ndarray:
    """Whole-scene per-point logits with the dense level sharded over the
    mesh, on every rank: xyz [N, 3], mask [N] → [N, num_classes] (zeros
    for invalid points). `capacity` is the per-shard point budget
    (default: the scene's largest slab + halo occupancy), `fwd` a prebuilt
    `make_resident_forward`, `votes` > 1 averages the logits of keys
    fold_in(rng, v) (the partition is made once), `feat` [N, in_channels]
    rides the partition, `halo` overrides the ghost strip's width."""
    D = mesh.size
    origin, vsize = scene_bounds(xyz, mask, cfg.model.layers[0].resolution)
    halo = resident_halo(cfg, vsize) if halo is None else halo
    if capacity is None:
        capacity = suggest_capacity(xyz, mask, D, halo)
    sx, sm, owned, sidx, edges = partition_scene(xyz, mask, D, halo,
                                                 capacity)
    rows = slice(mesh.rank, mesh.rank + 1)
    pos = slab_inputs(cfg, sx, sm, sidx, rows, mesh.device, feat)
    if fwd is None:
        fwd = make_resident_forward(cfg, mesh)
    rng = jaxrng.PRNGKey(0) if rng is None else rng
    acc = None
    with torch.no_grad(), full_fp32():
        for v in range(votes):
            k = jaxrng.fold_in(rng, v) if votes > 1 else rng
            lg = fwd(model, *pos, edges, origin, vsize, k)
            acc = lg if acc is None else acc + lg
        logits = all_gather_exact(acc[0], mesh).cpu().numpy()
    return stitch(logits.reshape(D, capacity, -1) / votes, owned, sidx,
                  xyz.shape[0])
