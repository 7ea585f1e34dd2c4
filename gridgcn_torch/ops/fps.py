"""Baseline samplers: farthest point sampling and ball query (the JAX
package's `ops/fps.py`).

GridConv does not use them. They are the baseline of the paper's "CAGQ vs
FPS + ball query" data-structuring comparison and the primitives that
PointNet++-lineage users know. The JAX package runs them under XLA (a
`fori_loop` and a `scan`), so the port runs them as plain torch: FPS is a
loop of M dependent steps, each an argmax over the running min-distance
field, and ball query streams the points in `block`-sized slabs. Indices
match the JAX package's bit for bit (the random start is the same jaxrng
draw; the scatter keeps JAX's first-found order and its unwritten zeros).
"""

from __future__ import annotations

import numpy as np
import torch

from gridgcn_torch.utils import jaxrng

_BIG = 1e10


def _fps(xyz: torch.Tensor, mask: torch.Tensor, M: int,
         start: torch.Tensor) -> torch.Tensor:
    """[B, M] int32 FPS indices from each cloud's start index; masked
    points are never picked (their field is −1)."""
    B = xyz.shape[0]
    d_min = torch.where(mask, _BIG, -1.0)
    rows = torch.arange(B, device=xyz.device)
    idx = torch.zeros((B, M), dtype=torch.int32, device=xyz.device)
    cur = start
    for i in range(M):
        idx[:, i] = cur
        diff = xyz - xyz[rows, cur][:, None]
        d_cur = (diff * diff).sum(-1)
        d_min = torch.minimum(d_min, torch.where(mask, d_cur, -1.0))
        cur = torch.argmax(d_min, dim=-1)
    return idx


def farthest_point_sampling(xyz: torch.Tensor, mask: torch.Tensor, M: int,
                            key: np.ndarray) -> torch.Tensor:
    """FPS indices [B, M] int32 (a random valid start point per cloud):
    xyz [B, N, 3] f32, mask [B, N] bool."""
    B, N = xyz.shape[:2]
    score = torch.where(mask, jaxrng.uniform(jaxrng.split(key, B), (N,),
                                             xyz.device), -1.0)
    return _fps(xyz.float(), mask, M, torch.argmax(score, dim=-1))


def ball_query(xyz: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor,
               radius: float, K: int, block: int = 4096):
    """For each center, up to K points within `radius`, in first-found
    order: xyz [B, N, 3], mask [B, N], centers [B, M, 3] → (idx [B, M, K]
    int32, valid [B, M, K] bool). Streams the points in `block`-sized
    slabs so [M, N] never materializes; d² is |c|² + |x|² − 2c·x as in
    the JAX package."""
    B, N = xyz.shape[:2]
    M = centers.shape[1]
    dev = xyz.device
    r2 = radius * radius
    block = min(block, N)
    nb = -(-N // block)
    xp = torch.zeros((B, nb * block, 3), dtype=xyz.dtype, device=dev)
    xp[:, :N] = xyz
    mp = torch.zeros((B, nb * block), dtype=torch.bool, device=dev)
    mp[:, :N] = mask
    idx = torch.zeros((B, M, K + 1), dtype=torch.int32, device=dev)
    valid = torch.zeros((B, M, K + 1), dtype=torch.bool, device=dev)
    count = torch.zeros((B, M), dtype=torch.int64, device=dev)
    cn = (centers * centers).sum(-1, keepdim=True)                # [B, M, 1]
    for b in range(nb):
        xs = xp[:, b * block:(b + 1) * block]
        ms = mp[:, b * block:(b + 1) * block]
        d2 = (cn + (xs * xs).sum(-1)[:, None, :]
              - 2.0 * torch.bmm(centers, xs.transpose(1, 2)))     # [B,M,blk]
        hit = (d2 <= r2) & ms[:, None, :]
        # rank of each hit within its row, after the ones already found
        rank = torch.cumsum(hit, dim=-1) - 1 + count[..., None]
        write = hit & (rank < K)
        dest = torch.where(write, rank, K)                        # K: scratch
        src = torch.arange(b * block, (b + 1) * block, dtype=torch.int32,
                           device=dev).expand_as(dest)
        # only the writes: the scratch slot K is dropped below, and a write
        # lands on a slot no other write of the scan reaches
        bi, mi, ji = torch.nonzero(write, as_tuple=True)
        idx[bi, mi, dest[bi, mi, ji]] = src[bi, mi, ji]
        valid[bi, mi, dest[bi, mi, ji]] = True
        count = torch.clamp_max(count + hit.sum(-1), K)
    return idx[..., :K], valid[..., :K]
