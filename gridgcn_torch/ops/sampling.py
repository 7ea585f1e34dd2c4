"""F-02 group-center sampling (RVS, SURVEY.md §2.1), threshold path.

RVS — Random Voxel Sampling: M occupied voxels at random. At whole-scene
scale the JAX package samples by threshold over the voxel-sorted points:
each occupied voxel is kept i.i.d. with probability p chosen so that the
binomial count stays below M with high probability, then the kept voxels
are compacted into M slots by a cumulative sum. That path is ported here.
The exact Gumbel top-k path and CAS raise `NotImplementedError`.
"""

from __future__ import annotations

import numpy as np
import torch

from gridgcn_torch.ops.voxelize import VoxelTable
from gridgcn_torch.utils import jaxrng


def _threshold_margin_ok(M: int) -> bool:
    """Threshold sampling keeps the count under M via an M − 3√M margin,
    which needs M ≥ 11; smaller M takes the exact Gumbel path."""
    return M - 3.0 * float(M) ** 0.5 >= 1.0


def _rvs_one_sorted(sorted_vid: torch.Tensor, V: int, M: int,
                    key: np.ndarray):
    """Threshold RVS over one cloud's voxel-sorted point array [N]:
    occupied voxels are the segment starts of sorted_vid. Output in
    ascending-vid order → (vids [M], valid [M])."""
    N = sorted_vid.shape[0]
    dev = sorted_vid.device
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sorted_vid[1:] != sorted_vid[:-1]])
    occ_start = is_start & (sorted_vid < V)
    n_occ = occ_start.sum()
    u = jaxrng.uniform(key, (N,), dev)
    # the same float32 arithmetic as the JAX expression
    num = np.float32(M) - np.float32(3.0) * np.sqrt(np.float32(M))
    p = torch.clamp(float(num) / torch.clamp_min(n_occ, 1).float(), 0.0, 1.0)
    sel = occ_start & ((n_occ <= M) | (u < p))
    rank = torch.cumsum(sel.long(), 0) - 1
    dest = torch.where(sel & (rank < M), rank, M)
    vids = torch.full((M + 1,), -1, dtype=torch.int64, device=dev)
    vids.scatter_(0, dest, sorted_vid)
    vids = vids[:M]
    return torch.clamp_min(vids, 0), vids >= 0


def sample_centers_rvs(table: VoxelTable, M: int, key: np.ndarray,
                       approx: bool = False):
    """Returns (center_vids [B, M] int64, center_valid [B, M] bool)."""
    if not (approx and _threshold_margin_ok(M)):
        raise NotImplementedError(
            "only threshold RVS (approx=True, M >= 11) is ported")
    B = table.occupancy.shape[0]
    keys = jaxrng.split(key, B)
    out = [_rvs_one_sorted(table.sorted_vid[b], table.num_voxels, M, keys[b])
           for b in range(B)]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))
