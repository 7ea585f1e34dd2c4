"""F-04: per-center node-point gather over the voxel context (SURVEY.md §2.1).

The reference walks the context neighborhood π(v) of each center voxel and
emits ≤ K node points, a validity mask and per-node coverage weights. As in
the JAX package, the walk is a dense gather over the packed key table:

  candidates[M, P·nv] = key_table[π(center)]     (P = context³)
  node selection      = top-K of the candidates' selection keys

Keys pack [valid | random | coverage code | point index], so the top-K keys
ARE the selection, with their payload: a uniform random K-subset of the
valid candidates, deterministic under the key. The context rows along z are
adjacent table rows, so the walk reads context² runs of `context` rows.

This slice ports the packed-key path (`approx=True`) and `center_positions`.
The slot-table path and `return_candidates` raise `NotImplementedError`.
The JAX package may select with an approximate top-k; the port always takes
the exact top-k of the same unique keys.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gridgcn_torch.ops.gridutil import (
    context_neighbors, context_offsets, vid_to_coords)
from gridgcn_torch.ops.voxelize import (
    COV_BITS, VALID_KEY_MIN, VoxelTable, decode_coverage)


@dataclass
class GroupedNodes:
    """CAGQ grouping output consumed by GCA (one GridConv layer).

    Attributes:
      neighbor_idx:  [B, M, K] int64 — indices into the level's point array
                     (0 where invalid; gate with neighbor_mask).
      neighbor_mask: [B, M, K] bool.
      node_xyz:      [B, M, K, 3] — node coordinates (0 where invalid).
      node_coverage: [B, M, K] int64 — raw point count of each node's voxel
                     (through the 6-bit codec), the GCA coverage weight.
      center_xyz:    [B, M, 3].
      center_valid:  [B, M] bool.
      center_vids:   [B, M] int64 — linear voxel id of each center.
    """

    neighbor_idx: torch.Tensor
    neighbor_mask: torch.Tensor
    node_xyz: torch.Tensor
    node_coverage: torch.Tensor
    center_xyz: torch.Tensor
    center_valid: torch.Tensor
    center_vids: torch.Tensor


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row take: x [B, R, ...], idx [B, ...] → [B, ..., ...]."""
    b = torch.arange(x.shape[0], device=x.device).view(
        -1, *([1] * (idx.dim() - 1)))
    return x[b, idx]


def _gather_packed(table: VoxelTable, xyz: torch.Tensor,
                   center_vids: torch.Tensor, center_valid: torch.Tensor,
                   K: int, context: int):
    """Packed-key node selection for the whole batch."""
    R = table.resolution
    V = R ** 3
    nv = table.nv
    B, M = center_vids.shape
    N = xyz.shape[1]
    P = context ** 3
    P2 = context * context
    r = (context - 1) // 2
    dev = xyz.device

    _, inb = context_neighbors(center_vids, R, context)           # [B, M, P]
    inb = inb & center_valid[..., None]

    # run (dx, dy) starts at padded row vid + dx·R² + dy·R (the table has r
    # sentinel rows on top, so a run starting at z−r is ≥ 0 in-bounds); the
    # clip only moves runs of fully masked pairs
    offs2 = context_offsets(context).reshape(P2, context, 3)[:, 0, :2]
    d2lin = torch.as_tensor(offs2[:, 0] * R * R + offs2[:, 1] * R,
                            dtype=torch.int64, device=dev)
    base = torch.clamp_max(center_vids, V)[..., None] + d2lin     # [B, M, P2]
    base = base.clamp(0, r + V)

    keys_p = table.key_table_pad
    if keys_p is None or keys_p.shape[1] != r + V + context:
        z = torch.zeros((B, r, nv), dtype=table.key_table.dtype, device=dev)
        zc = torch.zeros((B, context, nv), dtype=table.key_table.dtype,
                         device=dev)
        keys_p = torch.cat([z, table.key_table, zc], dim=1)
    rows = base[..., None] + torch.arange(context, device=dev)    # [B,M,P2,c]
    cand = _take_rows(keys_p, rows.reshape(B, M, P))              # [B,M,P,nv]
    cand = torch.where(inb[..., None], cand, 0).reshape(B, M, P * nv)

    kk = min(K, P * nv)
    top = torch.topk(cand, kk, dim=-1, largest=True, sorted=True).values
    if kk < K:
        top = torch.nn.functional.pad(top, (0, K - kk))
    top = top.long()

    # decode [valid | random | log-coverage | point index]
    idx_bits = max(1, int(N - 1).bit_length())
    neighbor_mask = top >= VALID_KEY_MIN
    neighbor_idx = torch.where(neighbor_mask, top & ((1 << idx_bits) - 1), 0)
    node_coverage = torch.where(neighbor_mask, decode_coverage(
        (top >> idx_bits) & ((1 << COV_BITS) - 1)), 0)

    node_xyz = _take_rows(xyz, neighbor_idx)                      # [B,M,K,3]
    node_xyz = torch.where(neighbor_mask[..., None], node_xyz, 0.0)
    return neighbor_idx, neighbor_mask, node_xyz, node_coverage


def center_positions(coord_csum, seg_pos, occupancy, center_vids,
                     center_valid, resolution: int, mode: str, origin,
                     vsize):
    """Group-center positions [B, M, 3]: stored-point barycenter or
    geometric voxel center (paper §3.1 ambiguity → config flag)."""
    V = resolution ** 3
    if mode == "barycenter":
        # voxel center + mean residual of the voxel's stored points, read
        # as a cumsum difference over its first `occupancy` sorted rows
        safe_vid = torch.where(center_valid, center_vids, V)
        svc = torch.clamp_max(safe_vid, V - 1)
        cnt = torch.where(center_valid, _take_rows(occupancy, svc), 0)
        pos = torch.where(center_valid, _take_rows(seg_pos, safe_vid), 0)
        hi_ = _take_rows(coord_csum, torch.clamp_min(pos + cnt - 1, 0))
        lo_ = torch.where((pos > 0)[..., None],
                          _take_rows(coord_csum, torch.clamp_min(pos - 1, 0)),
                          0.0)
        s_res = hi_ - lo_
        cx, cy, cz = vid_to_coords(svc, resolution)
        vcenter = (torch.stack([cx, cy, cz], -1).to(origin.dtype) + 0.5) \
            * vsize[:, None] + origin[:, None]
        bary = vcenter + s_res / torch.clamp_min(cnt, 1)[..., None].to(
            coord_csum.dtype)
        return torch.where(center_valid[..., None], bary, 0.0)
    if mode == "voxel_center":
        cx, cy, cz = vid_to_coords(torch.clamp_max(center_vids, V - 1),
                                   resolution)
        coords = torch.stack([cx, cy, cz], -1).to(origin.dtype) + 0.5
        c = origin[:, None] + coords * vsize[:, None]
        return torch.where(center_valid[..., None], c, 0.0)
    raise ValueError(f"unknown center_mode: {mode}")


def gather_nodes(table: VoxelTable, xyz: torch.Tensor,
                 center_vids: torch.Tensor, center_valid: torch.Tensor,
                 K: int, context: int, key: np.ndarray,
                 center_mode: str = "barycenter", approx: bool = False,
                 return_candidates: bool = False,
                 approx_topk: bool = False) -> GroupedNodes:
    """Batched F-04 gather; centers from F-02; xyz = level points [B, N, 3].

    `key` is kept for the signature: the packed path draws nothing from
    it. `approx_topk` is accepted for config parity: the port always
    selects the exact top-K."""
    if not approx or return_candidates:
        raise NotImplementedError(
            "only the packed-key gather (approx=True, no candidates) is "
            "ported")
    nidx, nmask, nxyz, ncov = _gather_packed(
        table, xyz, center_vids, center_valid, K, context)
    cxyz = center_positions(
        table.coord_csum, table.seg_pos, table.occupancy, center_vids,
        center_valid, table.resolution, center_mode, table.origin,
        table.vsize)
    return GroupedNodes(neighbor_idx=nidx, neighbor_mask=nmask,
                        node_xyz=nxyz, node_coverage=ncov, center_xyz=cxyz,
                        center_valid=center_valid, center_vids=center_vids)
