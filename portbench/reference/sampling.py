"""F-02 (RVS) and F-03 (CAS) group-center sampling (SURVEY.md §2.1).

RVS — Random Voxel Sampling: M occupied voxels at random. Two forms, as in
the JAX package's `ops/sampling.py`:

  * exact: a Gumbel top-k over the occupancy mask (classifier scales);
  * threshold (`approx=True`, M ≥ 11): each occupied voxel kept i.i.d.
    with probability p chosen so that the binomial count stays below M
    with high probability, the kept voxels compacted into M slots by a
    cumulative sum (whole-scene scale).

CAS — Coverage-Aware Sampling: start from RVS; each of `cas_iters` rounds
pits M challengers (unselected occupied voxels) against a random
permutation of the incumbents and applies every swap that raises grid
coverage, all against the round's starting coverage (the JAX package's
batched greedy). Coverage gains and losses are context³ box sums of
indicator grids.

Every function runs the whole batch at once: the per-cloud keys are split
on the host and the draws are made in one pass with a [B, 2] key array. Top-k
selection is a stable descending sort, which keeps the lower index first
among equal scores, as `lax.top_k` does (torch.topk does not), so the tie
run of unoccupied voxels when fewer than M are occupied comes out in the
same order. Scatters whose destinations may repeat repeat only at a
discarded sentinel cell, which is never read.
"""

from __future__ import annotations

import numpy as np
import torch

from .gridutil import top_k
from .voxelize import VoxelTable
from . import jaxrng

_NEG_INF = -1e30


def _threshold_margin_ok(M: int) -> bool:
    """Threshold sampling keeps the count under M via an M − 3√M margin,
    which needs M ≥ 11; smaller M takes the exact Gumbel path."""
    return M - 3.0 * float(M) ** 0.5 >= 1.0


def _split_each(keys, num: int):
    """`split(key, num)` of each of [B, 2] keys (numpy or tensor) →
    [num, B, 2]."""
    return jaxrng.split(keys, num).swapaxes(0, 1)


def _keep_probability(n_occ: torch.Tensor, M: int) -> torch.Tensor:
    """p = clip((M − 3√M) / max(n_occ, 1), 0, 1) in the JAX package's
    float32 arithmetic; n_occ [B] → [B, 1]."""
    num = np.float32(M) - np.float32(3.0) * np.sqrt(np.float32(M))
    p = float(num) / torch.clamp_min(n_occ, 1).float()
    return torch.clamp(p, 0.0, 1.0)[:, None]


def _compact(sel: torch.Tensor, values: torch.Tensor, M: int):
    """The first M selected entries of each row, in row order, by a
    cumulative-sum scatter: sel [B, L], values [B, L] → (vids [B, M] with
    0 where invalid, valid [B, M])."""
    rank = torch.cumsum(sel.long(), 1) - 1
    dest = torch.where(sel & (rank < M), rank, M)
    vids = torch.full((sel.shape[0], M + 1), -1, dtype=torch.int64,
                      device=sel.device)
    vids.scatter_(1, dest, values)
    vids = vids[:, :M]
    return torch.clamp_min(vids, 0), vids >= 0


def _rvs_one(occupied: torch.Tensor, M: int, keys: np.ndarray,
             approx: bool = False):
    """M distinct occupied voxels of each cloud: occupied [B, V] bool,
    keys [B, 2] → (vids [B, M] int64, valid [B, M] bool).

    approx=False (or M < 11): exact Gumbel top-k. approx=True: threshold
    sampling over the grid, output in ascending-vid order."""
    B, V = occupied.shape
    dev = occupied.device
    if not approx or not _threshold_margin_ok(M):
        g = jaxrng.gumbel(keys, (V,), dev)
        vals, vids = top_k(torch.where(occupied, g, _NEG_INF), M)
        return vids, vals > _NEG_INF * 0.5
    n_occ = occupied.sum(-1)
    u = jaxrng.uniform(keys, (V,), dev)
    sel = occupied & ((n_occ <= M)[:, None] | (u < _keep_probability(n_occ,
                                                                     M)))
    return _compact(sel, torch.arange(V, device=dev).expand(B, V), M)


def _rvs_one_sorted(sorted_vid: torch.Tensor, V: int, M: int,
                    keys: np.ndarray):
    """Threshold RVS over the voxel-sorted point arrays [B, N]: occupied
    voxels are the segment starts of sorted_vid. Same distribution as
    `_rvs_one(approx=True)`; output in ascending-vid order."""
    B, N = sorted_vid.shape
    dev = sorted_vid.device
    is_start = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                          sorted_vid[:, 1:] != sorted_vid[:, :-1]], 1)
    occ_start = is_start & (sorted_vid < V)
    n_occ = occ_start.sum(-1)
    u = jaxrng.uniform(keys, (N,), dev)
    sel = occ_start & ((n_occ <= M)[:, None] | (u < _keep_probability(n_occ,
                                                                      M)))
    return _compact(sel, sorted_vid, M)


def sample_centers_rvs(table: VoxelTable, M: int, key: np.ndarray,
                       approx: bool = False, row0: int = 0):
    """Returns (center_vids [B, M] int64, center_valid [B, M] bool). The
    clouds are rows [row0, row0 + B) of the batch whose key this is."""
    B = table.occupancy.shape[0]
    keys = jaxrng.split(key, B, start=row0)
    if approx and _threshold_margin_ok(M):
        return _rvs_one_sorted(table.sorted_vid, table.num_voxels, M, keys)
    # occupancy > 0 <=> coverage > 0; the exact path takes the Gumbel top-k
    return _rvs_one(table.occupancy > 0, M, keys, approx)


def _box_sum(x: torch.Tensor, resolution: int, context: int) -> torch.Tensor:
    """Sum of x over each voxel's context³ neighborhood, zero-padded at the
    grid boundary: x [B, V] integer → [B, V], a separable context-tap
    stencil of exact integer slices and adds."""
    r = (context - 1) // 2
    R = resolution
    g = x.reshape(-1, R, R, R)
    for axis in (1, 2, 3):
        pad = [0, 0] * 3
        pad[2 * (3 - axis)] = pad[2 * (3 - axis) + 1] = r
        gp = torch.nn.functional.pad(g, pad)
        g = sum(gp.narrow(axis, t, R) for t in range(context))
    return g.reshape(x.shape)


def _coverage_counts(sel_vids: torch.Tensor, sel_valid: torch.Tensor,
                     resolution: int, context: int) -> torch.Tensor:
    """C_u: the number of selected voxels whose context covers voxel u,
    [B, V+1] (the last cell 0): one scatter of the selected voxels' ones,
    then the box stencil."""
    B = sel_vids.shape[0]
    V = resolution ** 3
    sel = torch.zeros((B, V + 1), dtype=torch.int64, device=sel_vids.device)
    sel.scatter_(1, torch.where(sel_valid, sel_vids, V), 1)
    return torch.cat([_box_sum(sel[:, :V], resolution, context),
                      torch.zeros_like(sel[:, :1])], 1)


def _cas(occupied: torch.Tensor, M: int, keys: np.ndarray, resolution: int,
         context: int, rounds: int, approx: bool,
         sorted_vid: torch.Tensor):
    """Batched-greedy CAS over [B, V] occupancy (see the module docstring);
    keys [B, 2]. approx=True draws the initial centers and each round's
    challengers by threshold sampling instead of a Gumbel top-k."""
    B, V = occupied.shape
    k_init, k_rounds = _split_each(keys, 2)
    if approx and _threshold_margin_ok(M):
        sel_vids, sel_valid = _rvs_one_sorted(sorted_vid, V, M, k_init)
    else:
        sel_vids, sel_valid = _rvs_one(occupied, M, k_init, approx=approx)
    sentinel = torch.full_like(sel_vids, V)
    sel_mask = torch.zeros((B, V + 1), dtype=torch.bool,
                           device=occupied.device)
    sel_mask.scatter_(1, torch.where(sel_valid, sel_vids, V), True)
    C = _coverage_counts(sel_vids, sel_valid, resolution, context)

    for rkeys in _split_each(k_rounds, max(1, rounds)):
        k_chal, k_perm = _split_each(rkeys, 2)
        avail = occupied & ~sel_mask[:, :V]
        if approx:
            chal, chal_ok = _rvs_one(avail, M, k_chal, approx=True)
        else:
            g = jaxrng.gumbel(k_chal, (V,), occupied.device)
            _, chal = top_k(torch.where(avail, g, _NEG_INF), M)
            chal_ok = torch.gather(avail, 1, chal)

        slot = jaxrng.permutation(k_perm, M, occupied.device)
        inc = torch.gather(sel_vids, 1, slot)
        inc_valid = torch.gather(sel_valid, 1, slot)
        uncovered3 = _box_sum((C[:, :V] == 0).long(), resolution, context)
        once3 = _box_sum((C[:, :V] == 1).long(), resolution, context)
        h_add = torch.gather(uncovered3, 1, chal)
        h_rmv = torch.gather(once3, 1, torch.clamp_max(inc, V - 1))
        swap = chal_ok & inc_valid & (h_add > h_rmv)

        # winners are distinct unselected voxels, their incumbents distinct
        # selected ones, slot a permutation: only the sentinel V repeats
        won = torch.where(swap, chal, sentinel)
        lost = torch.where(swap, inc, sentinel)
        sel_vids = sel_vids.scatter(1, slot, torch.where(swap, chal, inc))
        sel_mask.scatter_(1, won, True)
        sel_mask.scatter_(1, lost, False)
        delta = torch.zeros_like(C)
        delta.scatter_(1, won, 1)
        delta.scatter_(1, lost, -1)
        C[:, :V] += _box_sum(delta[:, :V], resolution, context)
    return sel_vids, sel_valid


def sample_centers_cas(table: VoxelTable, M: int, key: np.ndarray,
                       context: int = 3, cas_iters: int = 1,
                       approx: bool = False, row0: int = 0):
    """Coverage-Aware Sampling → (center_vids [B, M], center_valid [B, M]).
    cas_iters = 0 is RVS (CAS's initialization) and dispatches to it. The
    clouds are rows [row0, row0 + B) of the batch whose key this is."""
    if cas_iters == 0:
        return sample_centers_rvs(table, M, key, approx=approx, row0=row0)
    B = table.occupancy.shape[0]
    return _cas(table.occupancy > 0, M, jaxrng.split(key, B, start=row0),
                table.resolution, context, cas_iters, approx,
                table.sorted_vid)
