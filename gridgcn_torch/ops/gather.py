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

The slot-table path (`approx=False`) walks the index slot table instead,
with the raw coverage riding as an extra column, and selects the top-K of
uniform random scores in (1, 2) over the valid candidates (0 for the
rest), ties lower index first as `lax.top_k` takes them.
`return_candidates` also returns the [M, P·nv] candidates themselves, the
input of 'candidates' context pooling. The JAX package may select packed
keys with an approximate top-k; the port always takes the exact top-k of
the same unique keys.

A table built with `sel_coords` (the flag-off `coord_match`/`coord_payload`
studies) carries each slot's coordinates beside its key, so the walk
fetches [key | x | y | z] quads and the winners' coordinates come from
their candidates instead of a gather of the level's points: `coord_match`
takes the top-K keys and looks their coordinates up at the winners'
candidate positions (the JAX package's exact one-hot key match: keys are
unique); `coord_payload` sorts the candidates by key, descending, and
reads the coordinates in that order (its 4-operand sort). Both give the
packed path's outputs bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gridgcn_torch.ops.gridutil import (
    context_neighbors, context_offsets, device_constant, top_k,
    vid_to_coords)
from gridgcn_torch.ops.voxelize import (
    COV_BITS, VALID_KEY_MIN, VoxelTable, decode_coverage)
from gridgcn_torch.utils import jaxrng


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
      cand_idx:      [B, M, P·nv] int64 or None — every stored context point
                     (0 where invalid; return_candidates=True only).
      cand_valid:    [B, M, P·nv] bool or None.
    """

    neighbor_idx: torch.Tensor
    neighbor_mask: torch.Tensor
    node_xyz: torch.Tensor
    node_coverage: torch.Tensor
    center_xyz: torch.Tensor
    center_valid: torch.Tensor
    center_vids: torch.Tensor
    cand_idx: torch.Tensor | None = None
    cand_valid: torch.Tensor | None = None


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row take: x [B, R, ...], idx [B, ...] → [B, ..., ...]."""
    b = torch.arange(x.shape[0], device=x.device).view(
        -1, *([1] * (idx.dim() - 1)))
    return x[b, idx]


def _context_runs(padded: torch.Tensor, center_vids: torch.Tensor,
                  center_valid: torch.Tensor, resolution: int, context: int):
    """Each center's context rows of a table padded with r rows on top and
    `context` rows below: padded [B, r+V+context, W] → (rows [B, M, P, W],
    inb [B, M, P] — the context voxel is in the grid and the center valid).
    Run (dx, dy) starts at padded row vid + dx·R² + dy·R; the clip only
    moves runs of fully masked pairs."""
    R = resolution
    V = R ** 3
    B, M = center_vids.shape
    P2 = context * context
    r = (context - 1) // 2
    dev = center_vids.device
    _, inb = context_neighbors(center_vids, R, context)           # [B, M, P]
    inb = inb & center_valid[..., None]
    offs2 = context_offsets(context).reshape(P2, context, 3)[:, 0, :2]
    d2lin = device_constant(offs2[:, 0] * R * R + offs2[:, 1] * R,
                            torch.int64, dev)
    base = torch.clamp_max(center_vids, V)[..., None] + d2lin     # [B, M, P2]
    base = base.clamp(0, r + V)
    rows = base[..., None] + torch.arange(context, device=dev)    # [B,M,P2,c]
    return _take_rows(padded, rows.reshape(B, M, P2 * context)), inb


def _pad_rows(table: torch.Tensor, context: int, fill) -> torch.Tensor:
    """[B, V, W] → [B, r+V+context, W] with `fill` rows around it."""
    B, _, W = table.shape
    r = (context - 1) // 2
    return torch.cat([table.new_full((B, r, W), fill), table,
                      table.new_full((B, context, W), fill)], dim=1)


def _gather_packed(table: VoxelTable, xyz: torch.Tensor,
                   center_vids: torch.Tensor, center_valid: torch.Tensor,
                   K: int, context: int, return_candidates: bool):
    """Packed-key node selection for the whole batch → (neighbor_idx,
    neighbor_mask, node_coverage, cand_idx, cand_valid); the candidates
    are decoded only when asked for (None otherwise)."""
    nv = table.nv
    B, M = center_vids.shape
    N = xyz.shape[1]
    P = context ** 3
    r = (context - 1) // 2

    keys_p = table.key_table_pad
    if keys_p is None or keys_p.shape[1] != r + table.num_voxels + context:
        keys_p = _pad_rows(table.key_table, context, 0)
    cand, inb = _context_runs(keys_p, center_vids, center_valid,
                              table.resolution, context)          # [B,M,P,nv]
    cand = torch.where(inb[..., None], cand, 0).reshape(B, M, P * nv)

    kk = min(K, P * nv)
    top = torch.topk(cand, kk, dim=-1, largest=True, sorted=True).values
    if kk < K:
        top = torch.nn.functional.pad(top, (0, K - kk))

    neighbor_mask, neighbor_idx, node_coverage = _decode_keys(top, N)
    cand_valid = cand_idx = None
    if return_candidates:
        cand_valid, cand_idx, _ = _decode_keys(cand, N)
    return neighbor_idx, neighbor_mask, node_coverage, cand_idx, cand_valid


def _gather_sel(table: VoxelTable, center_vids: torch.Tensor,
                center_valid: torch.Tensor, K: int, context: int, N: int,
                coord_payload: bool):
    """Node selection over the combined selection table → (neighbor_idx,
    neighbor_mask, node_coverage, node_xyz, cand_keys); the table must be
    padded with (r, context) rows, as CAGQ builds it."""
    nv = table.nv
    B, M = center_vids.shape
    P = context ** 3
    r = (context - 1) // 2
    sel = table.sel_table_pad
    if sel.shape[1] != r + table.num_voxels + context:
        raise ValueError(f"the selection table needs key_pad=({r}, "
                         f"{context}) for context {context}")
    runs, inb = _context_runs(sel, center_vids, center_valid,
                              table.resolution, context)        # [B,M,P,128]
    runs = runs.view(B, M, P, 32, 4)[:, :, :, :nv]
    runs = torch.where(inb[..., None, None], runs, 0).reshape(B, M, P * nv, 4)
    cand_keys = runs[..., 0]
    cand_xyz = runs[..., 1:4].contiguous().view(torch.float32)
    kk = min(K, P * nv)
    if coord_payload:
        # descending by key = ascending by ~key: valid keys (bit 29 set)
        # come first, empty slots (key 0, quad 0) after them
        nk, pos = torch.sort(~cand_keys, dim=-1, stable=True)
        top, pos = ~nk[..., :kk], pos[..., :kk]
    else:
        top, pos = torch.topk(cand_keys, kk, dim=-1, largest=True,
                              sorted=True)
    node_xyz = torch.gather(cand_xyz, 2, pos[..., None].expand(B, M, kk, 3))
    if kk < K:
        top = torch.nn.functional.pad(top, (0, K - kk))
        node_xyz = torch.nn.functional.pad(node_xyz, (0, 0, 0, K - kk))
    neighbor_mask, neighbor_idx, node_coverage = _decode_keys(top, N)
    node_xyz = torch.where(neighbor_mask[..., None], node_xyz, 0.0)
    return neighbor_idx, neighbor_mask, node_coverage, node_xyz, cand_keys


def _decode_keys(keys: torch.Tensor, N: int):
    """[valid | random | log-coverage | point index] keys of a level of N
    points → (valid, point index, coverage), 0 where invalid."""
    idx_bits = max(1, int(N - 1).bit_length())
    keys = keys.long()
    valid = keys >= VALID_KEY_MIN
    idx = torch.where(valid, keys & ((1 << idx_bits) - 1), 0)
    cov = torch.where(valid, decode_coverage(
        (keys >> idx_bits) & ((1 << COV_BITS) - 1)), 0)
    return valid, idx, cov


def _gather_slots(table: VoxelTable, center_vids: torch.Tensor,
                  center_valid: torch.Tensor, K: int, context: int,
                  keys: np.ndarray):
    """Slot-table node selection for the whole batch (keys [B, 2]) →
    (neighbor_idx, neighbor_mask, node_coverage, cand_idx, cand_valid)."""
    nv = table.nv
    B, M = center_vids.shape
    P = context ** 3
    # coverage rides as an extra column, so the walk is one run gather
    slots_cov = torch.cat([table.slots, table.coverage[..., None]], dim=-1)
    runs, inb = _context_runs(_pad_rows(slots_cov, context, -1), center_vids,
                              center_valid, table.resolution, context)
    cand_idx = runs[..., :nv]                                     # [B,M,P,nv]
    cand_valid = ((cand_idx >= 0) & inb[..., None]).reshape(B, M, P * nv)
    cand_idx = cand_idx.reshape(B, M, P * nv)
    cand_cov = torch.where(inb, torch.clamp_min(runs[..., nv], 0), 0)
    cand_cov = cand_cov[..., None].expand(B, M, P, nv).reshape(B, M, P * nv)

    rscore = jaxrng.uniform(keys, (M, P * nv), center_vids.device)
    score = torch.where(cand_valid, 1.0 + rscore, 0.0)
    kk = min(K, P * nv)
    top_score, top_pos = top_k(score, kk)
    if kk < K:
        top_score = torch.nn.functional.pad(top_score, (0, K - kk))
        top_pos = torch.nn.functional.pad(top_pos, (0, K - kk))
    neighbor_mask = top_score > 0.5
    neighbor_idx = torch.where(
        neighbor_mask, torch.gather(cand_idx, -1, top_pos), 0)
    node_coverage = torch.where(
        neighbor_mask, torch.gather(cand_cov, -1, top_pos), 0)
    return (neighbor_idx, neighbor_mask, node_coverage,
            torch.where(cand_valid, cand_idx, 0), cand_valid)


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
                 approx_topk: bool = False, row0: int = 0,
                 coord_payload: bool = False) -> GroupedNodes:
    """Batched F-04 gather; centers from F-02/F-03; xyz = level points
    [B, N, 3]. approx=True: the packed-key path (needs the key table; on a
    table with the combined selection table, `coord_match`, or
    `coord_payload` when that is set); approx=False: the slot-table path
    (needs slots and coverage), whose random scores come from `key` split
    per cloud (the clouds are rows [row0, row0 + B) of the batch whose key
    this is). `approx_topk` is accepted for config parity: the port always
    selects the exact top-K."""
    nxyz = None
    if approx and table.sel_table_pad is not None:
        nidx, nmask, ncov, nxyz, ckeys = _gather_sel(
            table, center_vids, center_valid, K, context, xyz.shape[1],
            coord_payload)
        cvalid = cidx = None
        if return_candidates:
            cvalid, cidx, _ = _decode_keys(ckeys, xyz.shape[1])
    elif approx:
        nidx, nmask, ncov, cidx, cvalid = _gather_packed(
            table, xyz, center_vids, center_valid, K, context,
            return_candidates)
    else:
        nidx, nmask, ncov, cidx, cvalid = _gather_slots(
            table, center_vids, center_valid, K, context,
            jaxrng.split(key, center_vids.shape[0], start=row0))
    if nxyz is None:
        nxyz = _take_rows(xyz, nidx)                              # [B,M,K,3]
        nxyz = torch.where(nmask[..., None], nxyz, 0.0)
    cxyz = center_positions(
        table.coord_csum, table.seg_pos, table.occupancy, center_vids,
        center_valid, table.resolution, center_mode, table.origin,
        table.vsize)
    if not return_candidates:
        cidx = cvalid = None
    return GroupedNodes(neighbor_idx=nidx, neighbor_mask=nmask,
                        node_xyz=nxyz, node_coverage=ncov, center_xyz=cxyz,
                        center_valid=center_valid, center_vids=center_vids,
                        cand_idx=cidx, cand_valid=cvalid)
