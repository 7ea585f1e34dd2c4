"""Spatial sharding of one whole scene, tier 1 (the JAX package's
`parallel/spatial.py`).

The scene is cut into slabs along its first axis, one slab per rank of the
data-parallel mesh; each slab also holds a halo strip of its neighbours'
points, wide enough to cover every context query the network makes near
the slab's edge, so the unchanged single-device network runs on every slab
(the slabs ride the mesh's batch axis) and each point's logits are taken
from the slab that owns it and stitched back in the original order.
Partitioning runs on the host in numpy, value for value the JAX package's.
`exchange_halo_planes` is the device-side ghost-plane exchange between
ring neighbours (`parallel.mesh.shift`), the primitive of the resident
tiers (`parallel.resident`, `parallel.resident_ml`).
"""

from __future__ import annotations

import numpy as np
import torch

from gridgcn_torch.parallel.mesh import Mesh, fetch_global, shift


def required_halo(cfg, extent: float) -> float:
    """Ghost-zone width (world units) for tier-1 sharding of a scene of the
    given extent: the network's cumulative receptive-field reach. A level
    with grid `resolution` over the scene and a `context`-wide
    neighbourhood reaches (context // 2 + 1) voxels from a center; reaches
    sum over the encoder levels, and a decoder grid query reaches one more
    context at its own grid."""
    reach = 0.0
    for layer in cfg.model.layers:
        reach += (layer.context // 2 + 1) * extent / layer.resolution
    for up in cfg.model.up_layers:
        reach = max(reach, (up.context // 2 + 1) * extent / up.resolution)
    return reach


def _slab_edges(x: np.ndarray, n_shards: int) -> np.ndarray:
    """Slab boundaries along the partition axis: equal-width bins over the
    occupied extent, ±inf at the ends, in float32. The one binning rule of
    `partition_scene` and `suggest_capacity`."""
    edges = np.linspace(float(x.min()), float(x.max()), n_shards + 1)
    edges[0], edges[-1] = -np.inf, np.inf
    return edges.astype(np.float32)


def suggest_capacity(xyz: np.ndarray, mask: np.ndarray, n_shards: int,
                     halo: float, axis: int = 0,
                     round_to: int = 1024) -> int:
    """The smallest per-shard capacity `partition_scene` needs for this
    scene (the largest own + halo occupancy over the slabs), rounded up to
    a multiple of `round_to`, and at most the scene's point count."""
    pts = xyz[mask]
    if pts.shape[0] == 0:
        return round_to
    x = pts[:, axis]
    edges = _slab_edges(x, n_shards)
    need = max(int(((x >= edges[d] - halo) & (x < edges[d + 1] + halo)).sum())
               for d in range(n_shards))
    return int(min(-(-max(need, 1) // round_to) * round_to, pts.shape[0]))


def partition_scene(xyz: np.ndarray, mask: np.ndarray, n_shards: int,
                    halo: float, capacity: int, axis: int = 0):
    """Split one scene [N, 3] (validity [N]) into slabs plus halo strips →
    shard_xyz [D, cap, 3], shard_mask [D, cap], owned [D, cap],
    scatter_idx [D, cap] (the original point index, 0 where padded),
    edges [D + 1]. Raises when a slab needs more than `capacity`."""
    pts = xyz[mask]
    orig = np.nonzero(mask)[0].astype(np.int32)
    x = pts[:, axis]
    edges = _slab_edges(x, n_shards)

    shard_xyz = np.zeros((n_shards, capacity, 3), xyz.dtype)
    shard_mask = np.zeros((n_shards, capacity), bool)
    owned = np.zeros((n_shards, capacity), bool)
    scatter_idx = np.zeros((n_shards, capacity), np.int32)
    for d in range(n_shards):
        own_sel = (x >= edges[d]) & (x < edges[d + 1])
        halo_sel = (~own_sel) & (x >= edges[d] - halo) & \
            (x < edges[d + 1] + halo)
        sel = np.nonzero(own_sel | halo_sel)[0]
        if len(sel) > capacity:
            raise ValueError(
                f"shard {d}: {len(sel)} points > capacity {capacity}; "
                f"raise capacity or shard count")
        n = len(sel)
        shard_xyz[d, :n] = pts[sel]
        shard_mask[d, :n] = True
        owned[d, :n] = own_sel[sel]
        scatter_idx[d, :n] = orig[sel]
    return shard_xyz, shard_mask, owned, scatter_idx, edges


def sharded_scene_apply(apply_fn, xyz: np.ndarray, mask: np.ndarray,
                        mesh: Mesh, halo: float, capacity: int,
                        num_outputs: int, feat: np.ndarray = None
                        ) -> np.ndarray:
    """Whole-scene per-point inference over the mesh, on every rank: the
    scene is partitioned into one slab per rank, each rank runs
    `apply_fn(xyz [d, cap, 3], mask [d, cap], row0) -> logits [d, cap, C]`
    on its slabs (`apply_fn(xyz, feat, mask, row0)` with `feat` [N, C_in]:
    the features ride the same partition), rows [row0, row0 + d) of the
    slab batch, and the owned points' logits come back as [N, C] in the
    original order."""
    D = mesh.size
    sx, sm, owned, sidx, _ = partition_scene(xyz, mask, D, halo, capacity)
    r0, r1 = mesh.rows(D)
    dev = mesh.device
    x = torch.as_tensor(sx[r0:r1], device=dev)
    m = torch.as_tensor(sm[r0:r1], device=dev)
    if feat is not None:
        sf = feat[sidx] * sm[..., None].astype(feat.dtype)
        local = apply_fn(x, torch.as_tensor(sf[r0:r1], device=dev), m, r0)
    else:
        local = apply_fn(x, m, r0)
    logits = fetch_global(local.float(), mesh, D)

    out = np.zeros((xyz.shape[0], num_outputs), logits.dtype)
    flat_owned = owned.reshape(-1)
    out[sidx.reshape(-1)[flat_owned]] = logits.reshape(
        -1, num_outputs)[flat_owned]
    return out


def exchange_halo_planes(local: torch.Tensor, mesh: Mesh):
    """The ghost planes of this rank's slab of a voxel-major array whose
    leading axis is the sharded spatial axis: (left_ghost, right_ghost),
    the left neighbour's last plane and the right neighbour's first, each
    [1, ...]; the grid's two ends get zeros. Differentiable."""
    return shift(local[-1:], mesh, 1), shift(local[:1], mesh, -1)
