"""F-01: fixed-capacity voxel-table build (SURVEY.md §2.1).

Sort-based and race-free, as in the JAX package's `ops/voxelize.py`:

  1. one stable sort of a key that packs [voxel id | random bits], so the
     first nv points of each voxel are a uniform random subset (the
     reference's shuffle-then-retain semantics),
  2. rank within the voxel segment by a cumulative max over segment starts,
  3. one scatter per table of each kept point's value into its (voxel,
     rank) cell; dropped points land on one discarded extra cell.

Besides the packed key table (`with_keys`), the build makes on request
the index slot table (`with_slots`), the raw per-voxel coverage grid
(`with_coverage`) and the packed coordinate table (`with_coords`), as the
JAX package's `ops/voxelize.py` does, and the combined selection table of
its flag-off `coord_match`/`coord_payload` studies (`sel_coords`): one
[rows, 128] int32 row per voxel of up to 32 [key | x | y | z] quads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gridgcn_torch.ops.gridutil import vid_to_coords
from gridgcn_torch.utils import jaxrng

COV_BITS = 6
COORD_SENTINEL = 1e10   # empty-slot coordinate; d2 to it ≈ 1e20
# selection-key valid flag at bit 29: every key stays below 0x40000000
VALID_KEY_MIN = 1 << 29


@dataclass
class VoxelTable:
    """Fixed-capacity voxel table for one grid level (batch-major).

    Attributes:
      key_table:     [B, V, nv] int32 or None — selection keys
                     [valid:1 @29 | random | coverage code:6 | point index]
                     (a view of key_table_pad when that is built;
                     with_keys=True).
      key_table_pad: [B, pad_lo+V+pad_hi, nv] int32 or None — the same keys
                     in a context-padded buffer whose pad rows are zero
                     (= invalid key).
      slots:         [B, V, nv] int64 or None — indices into the level's
                     point array, -1 for an empty slot (with_slots=True).
      coord_table:   [B, V+1, 3·nv] or None — packed slot coordinates
                     [x-slots | y-slots | z-slots]; empty slots and the
                     sentinel row V hold +COORD_SENTINEL (with_coords=True).
      coverage:      [B, V] int64 or None — raw points per voxel, uncapped
                     (with_coverage=True).
      sel_table_pad: [B, pad_lo+V+pad_hi, 128] int32 or None — the combined
                     selection table (sel_coords=True): slot j of a voxel's
                     row holds the quad [key | x | y | z] at columns
                     4j..4j+3, the coordinates' f32 bits; empty slots and
                     pad rows are zero. key_table is then a view of it and
                     key_table_pad None.
      coord_csum:    [B, N, 3] — inclusive cumulative sum of voxel-center
                     residuals (point − its voxel's center) in voxel-sorted
                     order; a voxel's barycenter is a difference of two rows.
      seg_pos:       [B, V+1] int64 — position of each voxel's first sorted
                     point (0 for unoccupied and for the sentinel row V).
      occupancy:     [B, V] int64 — stored points per voxel (≤ nv).
      point_vid:     [B, N] int64 — linear voxel id per input point (V for
                     invalid/padded points).
      sorted_vid:    [B, N] int64 — voxel id per point in voxel-sorted order.
      origin:        [B, 3] — minimum corner of the grid.
      vsize:         [B, 3] — voxel edge lengths.
      resolution:    grid is resolution³ voxels.
      nv:            slot capacity per voxel.
    """

    key_table: torch.Tensor | None
    key_table_pad: torch.Tensor | None
    coord_csum: torch.Tensor
    seg_pos: torch.Tensor
    occupancy: torch.Tensor
    point_vid: torch.Tensor
    sorted_vid: torch.Tensor
    origin: torch.Tensor
    vsize: torch.Tensor
    resolution: int
    nv: int
    slots: torch.Tensor | None = None
    coord_table: torch.Tensor | None = None
    coverage: torch.Tensor | None = None
    sel_table_pad: torch.Tensor | None = None

    @property
    def num_voxels(self) -> int:
        return self.resolution ** 3


def voxel_ids(xyz: torch.Tensor, mask: torch.Tensor, origin: torch.Tensor,
              vsize: torch.Tensor, resolution: int) -> torch.Tensor:
    """Linear voxel id per point; invalid points get the sentinel id V.
    origin/vsize broadcast against xyz [..., 3]."""
    V = resolution ** 3
    coords = torch.floor((xyz - origin) / vsize).long()
    coords = coords.clamp(0, resolution - 1)
    vid = (coords[..., 0] * resolution + coords[..., 1]) * resolution \
        + coords[..., 2]
    return torch.where(mask, vid, V)


def encode_coverage(count: torch.Tensor) -> torch.Tensor:
    """6-bit coverage codec, encode side: counts < 32 exactly (codes
    0..31), larger counts on 32 log-spaced codes at factor 2^(1/4) per step
    (codes 32..63, ≤ 10% relative decode error up to ≈ 6889)."""
    count = torch.clamp_min(count, 0)
    logc = torch.log2(torch.clamp_min(count, 32).float() / 32.0)
    code_log = 32 + torch.round(logc * 4.0).long()
    return torch.where(count < 32, count, torch.clamp_max(code_log, 63))


def decode_coverage(code: torch.Tensor) -> torch.Tensor:
    """Inverse of `encode_coverage` (exact below 32, ≤10% error above)."""
    approx = torch.round(
        32.0 * torch.exp2((code - 32).float() / 4.0)).long()
    return torch.where(code < 32, code, approx)


def grid_bounds(xyz: torch.Tensor, mask: torch.Tensor, resolution: int):
    """Per-cloud grid origin and voxel size from the valid-point bounding
    box: xyz [B, N, 3], mask [B, N] → (origin [B, 3], vsize [B, 3])."""
    big = torch.finfo(xyz.dtype).max
    m = mask[..., None]
    lo = torch.where(m, xyz, big).amin(dim=-2)
    hi = torch.where(m, xyz, -big).amax(dim=-2)
    extent = torch.clamp_min(hi - lo, 1e-4)
    # tiny inflation so points exactly at the max corner land inside the grid
    vsize = extent * (1.0 + 1e-5) / resolution
    return lo, vsize


def _scatter_cells(n_cells: int, fill, dest: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """[B, n_cells] filled with `fill`, values written at dest; dest ==
    n_cells (an extra, discarded cell) drops a value. Every other
    destination is unique."""
    out = torch.full((dest.shape[0], n_cells + 1), fill, dtype=values.dtype,
                     device=dest.device)
    out.scatter_(1, dest, values)
    return out[:, :n_cells]


def build_voxel_table(xyz: torch.Tensor, mask: torch.Tensor, resolution: int,
                      nv: int, key: np.ndarray, with_coords: bool = False,
                      with_keys: bool = False, with_slots: bool = True,
                      bounds=None, key_pad: tuple[int, int] = (0, 0),
                      sel_coords: bool = False,
                      with_coverage: bool = True, row0: int = 0) -> VoxelTable:
    """Build fixed-capacity voxel tables for a batch of point clouds.

    Args:
      xyz:  [B, N, 3] float32 point positions.
      mask: [B, N] bool validity (padded points False).
      resolution: grid edge; V = resolution³ voxels.
      nv: per-voxel slot capacity.
      key: jaxrng key driving the random slot-retention order.
      with_coords: also build the packed [V+1, 3·nv] coordinate table.
      with_keys: also build the selection-key table.
      with_slots: build the index slot table.
      bounds: optional (origin [B, 3], vsize [B, 3]) fixing the grid.
      key_pad: (lo, hi) sentinel rows around the key table.
      with_coverage: build the raw coverage grid; without it seg_pos and
        occupancy come from one packed scatter.
      sel_coords: with with_keys, build the combined selection table
        (`VoxelTable.sel_table_pad`, nv ≤ 32) in place of key_table_pad.
      row0: the clouds are rows [row0, row0 + B) of the batch whose key
        this is (one data-parallel rank's rows).
    """
    B, N = xyz.shape[:2]
    V = resolution ** 3
    dev = xyz.device
    # random per-voxel retention order
    rand = jaxrng.bits(key, (B, N), dev, row0=row0)

    if bounds is None:
        origin, vsize = grid_bounds(xyz, mask, resolution)
    else:
        origin, vsize = bounds
    vid = voxel_ids(xyz, mask, origin[:, None], vsize[:, None], resolution)

    # ONE single-key sort over [voxel id | random bits]; the sentinel id V
    # packs to the largest keys, so invalid points sort last. Stable, so a
    # tie in the random bits keeps the lower point index first, as XLA's
    # sort does.
    vid_bits = int(V).bit_length()
    srand_bits = 32 - vid_bits
    skey = (vid << srand_bits) | (rand >> vid_bits)
    sorted_skey, sorted_pidx = torch.sort(skey, dim=-1, stable=True)
    sorted_vid = sorted_skey >> srand_bits

    idx = torch.arange(N, device=dev).expand(B, N)
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    is_start = torch.cat([ones, sorted_vid[:, 1:] != sorted_vid[:, :-1]], 1)
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    rank = idx - seg_start
    keep = (sorted_vid < V) & (rank < nv)
    col = torch.clamp_max(rank, nv - 1)

    # segment length (= raw voxel coverage) via the next segment start
    nxt_src = torch.where(torch.cat([is_start[:, 1:], ones], 1), idx + 1, N)
    next_start = torch.flip(
        torch.cummin(torch.flip(nxt_src, [1]), dim=-1).values, [1])
    seg_len = next_start - seg_start

    slots = None
    if with_slots:
        slots = _scatter_cells(
            V * nv, -1, torch.where(keep, sorted_vid * nv + col, V * nv),
            sorted_pidx).view(B, V, nv)

    # the points' coordinates in voxel-sorted order
    coords = torch.gather(xyz, 1, sorted_pidx[..., None].expand(B, N, 3))
    key_table = key_table_pad = sel_table_pad = None
    if with_keys:
        idx_bits = max(1, int(N - 1).bit_length())
        if idx_bits + COV_BITS + 1 > 29:
            raise ValueError(
                f"selection-key packing supports at most "
                f"2^{29 - COV_BITS - 1} points per cloud (N={N})")
        rand_bits = max(1, 29 - idx_bits - COV_BITS)
        cov_q = encode_coverage(seg_len)
        # random selection-key bits: the top of the sort key's random field
        rbits = (sorted_skey >> max(srand_bits - rand_bits, 0)) \
            & ((1 << rand_bits) - 1)
        keys = ((keep.long() << 29) | (rbits << (idx_bits + COV_BITS))
                | (cov_q << idx_bits) | sorted_pidx)
        # scatter into the context-padded buffer; (voxel, rank) cells are
        # unique, dropped points land on one discarded extra cell
        lo, hi = key_pad
        rows = lo + V + hi
        if not sel_coords:
            key_table_pad = _scatter_cells(
                rows * nv, 0, torch.where(keep, (sorted_vid + lo) * nv + col,
                                          rows * nv),
                keys.int()).view(B, rows, nv)
            key_table = key_table_pad[:, lo:lo + V]
            if lo == 0 and hi == 0:
                key_table_pad = None
        else:
            # the combined selection table: the quad [key | x | y | z] of
            # the point at (voxel, rank) at row voxel + lo, columns
            # 4·rank .. 4·rank + 3 (the coordinates' f32 bits)
            if nv > 32:
                raise ValueError(f"sel_coords supports nv <= 32, got {nv}")
            base = (sorted_vid + lo) * 128 + col * 4
            dest = torch.cat([torch.where(keep, base + a, rows * 128)
                              for a in range(4)], 1)
            cbits = coords.float().view(torch.int32)
            vals = torch.cat([keys.int(), cbits[..., 0], cbits[..., 1],
                              cbits[..., 2]], 1)
            sel_table_pad = _scatter_cells(rows * 128, 0, dest,
                                           vals).view(B, rows, 128)
            key_table = sel_table_pad.view(B, rows, 32, 4)[:, lo:lo + V,
                                                           :nv, 0]

    # barycenter inputs: prefix sums of voxel-center residuals in sorted
    # order (residuals are ≤ vsize/2, so the sum does not cancel). Each
    # cloud's [3, N] is scanned over its last dim on its own, accumulating
    # in float64 and rounded once, as torch's CPU cumsum does: the card
    # then gives the CPU's sums but where a float64 rounding crosses a
    # float32 one. Over dim 1 of [B, N, 3] CUDA's cumsum gives each of the
    # B·3 columns one thread that walks all N rows, and its last-dim scan
    # sizes its blocks by the number of rows, so one call over the batch
    # would sum a cloud in an order that depends on its batchmates
    sx, sy, sz = vid_to_coords(torch.clamp_max(sorted_vid, V - 1), resolution)
    vcenter = (torch.stack([sx, sy, sz], -1).to(xyz.dtype) + 0.5) \
        * vsize[:, None] + origin[:, None]
    residual = (coords - vcenter).transpose(1, 2).contiguous()
    scans = [torch.cumsum(r, dim=-1, dtype=torch.float64)
             for r in residual.split(1)]
    coord_csum = (scans[0] if B == 1 else torch.cat(scans)).to(
        residual.dtype).transpose(1, 2)

    coord_table = None
    if with_coords:
        # axis a of the point at (voxel, rank) lands at row vid, column
        # a·nv + rank of the [V+1, 3·nv] table
        cells = (V + 1) * 3 * nv
        base = sorted_vid * 3 * nv + col
        dest = torch.cat([torch.where(keep, base + a * nv, cells)
                          for a in range(3)], 1)
        vals = torch.cat([coords[..., a] for a in range(3)], 1)
        coord_table = _scatter_cells(cells, COORD_SENTINEL, dest,
                                     vals).view(B, V + 1, 3 * nv)

    start_dest = torch.where(is_start & (sorted_vid < V), sorted_vid, V)
    coverage = None
    if with_coverage:
        coverage = _scatter_cells(V, 0, start_dest, seg_len)
        seg_pos = _scatter_cells(V, 0, start_dest, seg_start)
        seg_pos = torch.cat([seg_pos, torch.zeros_like(seg_pos[:, :1])], 1)
        occupancy = torch.clamp_max(coverage, nv)
    else:
        # seg_pos and occupancy packed into ONE scatter of the segment starts
        occ_bits = int(nv).bit_length()
        packed = (seg_start << occ_bits) | torch.clamp_max(seg_len, nv)
        posocc = _scatter_cells(V, 0, start_dest, packed)
        posocc = torch.cat([posocc, torch.zeros_like(posocc[:, :1])], 1)
        seg_pos = posocc >> occ_bits
        occupancy = (posocc & ((1 << occ_bits) - 1))[:, :V]
    return VoxelTable(key_table=key_table, key_table_pad=key_table_pad,
                      coord_csum=coord_csum, seg_pos=seg_pos,
                      occupancy=occupancy, point_vid=vid,
                      sorted_vid=sorted_vid, origin=origin, vsize=vsize,
                      resolution=resolution, nv=nv, slots=slots,
                      coord_table=coord_table, coverage=coverage,
                      sel_table_pad=sel_table_pad)


def capacity_stats(table: VoxelTable) -> dict:
    """Diagnostics for SURVEY §7 H1: how many points the capacity nv
    dropped (the valid-point total comes from the per-point voxel ids)."""
    stored = table.occupancy.sum(-1)
    total = (table.point_vid < table.num_voxels).sum(-1)
    dropped = total - stored
    return {
        "stored_points": stored,
        "total_points": total,
        "dropped_points": dropped,
        "dropped_frac": dropped / torch.clamp_min(total, 1),
        "occupied_voxels": (table.occupancy > 0).sum(-1),
    }
