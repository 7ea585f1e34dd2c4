"""F-05: decoder-side 3-NN query and inverse-distance interpolation.

For every point of the denser level, its k nearest points of the coarser
level and inverse-distance weights, three ways (the decoder's `method`):

  * `kernels.knn.flash_three_nn` ("pallas"): the CUDA flash-kNN kernel;
  * `dense_three_nn` ("dense"): brute force, d² = |q|² + |s|² − 2 q·s with
    the cross term a matmul. Exact: supports streamed in blocks with a
    carried running top-k. approx=True: the whole [Nq, Ns] matrix cast to
    bf16 and its k smallest taken (the JAX package's `approx_min_k`, which
    is an exact min-k off the TPU), ties lower index first;
  * `grid_three_nn` ("grid"): candidates are the ≤ context³·nv support
    points stored in the query's voxel context, read as rows of the
    packed [V+1, 3·nv] coordinate table.

The k winners are k masked argmins (the first minimum each time), as in
the JAX package's `ops/upsample.py`. A query with no support in reach gets
all-zero weights; `found` says which queries found one.
"""

from __future__ import annotations

import numpy as np
import torch

from .gridutil import context_neighbors, top_k
from .voxelize import build_voxel_table, voxel_ids
from .xla_math import fma32

_FOUND_THRESH = 1e19
_BIG = 1e10       # masked-support distance sentinel (approx dense path)


def _topk_min(d2: torch.Tensor, k: int):
    """k iterative masked argmins over the last axis → (vals, pos)."""
    vals, poss = [], []
    cur = d2
    for _ in range(k):
        pos = torch.argmin(cur, dim=-1, keepdim=True)
        vals.append(torch.gather(cur, -1, pos))
        poss.append(pos)
        cur = cur.scatter(-1, pos, torch.inf)
    return torch.cat(vals, -1), torch.cat(poss, -1)


def _weights(d2: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weights normalized over the valid neighbors (all
    zero where none is)."""
    w = torch.where(valid, 1.0 / (d2 + 1e-8), 0.0)
    w_sum = w.sum(dim=-1, keepdim=True)
    return torch.where(w_sum > 0, w / torch.clamp_min(w_sum, 1e-12), 0.0)


def _norm2(x: torch.Tensor, fused: bool) -> torch.Tensor:
    """|x|² over the last axis of [..., 3], summed x, y, z: unfused, or as
    the FMA chain fma(z, z, fma(y, y, x·x))."""
    if fused:
        return fma32(x[..., 2], x[..., 2],
                     fma32(x[..., 1], x[..., 1], x[..., 0] * x[..., 0]))
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
        + x[..., 2] * x[..., 2]


def _sq_dist(q: torch.Tensor, s: torch.Tensor,
             fused_s2: bool) -> torch.Tensor:
    """|q|² + |s|² − 2 q·s: q [B, Nq, 3], s [B, Ns, 3] → [B, Nq, Ns], with
    XLA:CPU's roundings: the matmul an FMA chain in x, y, z order (as
    torch's CPU matmul sums it), |q|² unfused, |s|² fused in the exact
    path's fusion and unfused in the approx path's. The expanded form
    cancels: its error is a few roundings of |q|² + |s|², not of d²."""
    s2 = _norm2(s, fused_s2)
    return (_norm2(q, False)[..., None] + s2[:, None, :]) \
        - 2.0 * torch.matmul(q, s.transpose(1, 2))


def _dense_exact(q, qm, s, sm, k: int, block: int):
    B, Nq, _ = q.shape
    Ns = s.shape[1]
    block = min(block, Ns)
    best_d = torch.full((B, Nq, k), torch.inf, device=q.device)
    best_i = torch.zeros((B, Nq, k), dtype=torch.int64, device=q.device)
    for b0 in range(0, Ns, block):
        sb, mb = s[:, b0:b0 + block], sm[:, b0:b0 + block]
        if sb.shape[1] < block:                 # the zero-padded last block
            pad = block - sb.shape[1]
            sb = torch.nn.functional.pad(sb, (0, 0, 0, pad))
            mb = torch.nn.functional.pad(mb, (0, pad))
        d2 = torch.where(mb[:, None, :], _sq_dist(q, sb, True), torch.inf)
        ids = torch.arange(b0, b0 + block, device=q.device).expand(B, Nq,
                                                                  block)
        best_d, pos = _topk_min(torch.cat([best_d, d2], -1), k)
        best_i = torch.gather(torch.cat([best_i, ids], -1), -1, pos)
    valid = torch.isfinite(best_d) & qm[..., None]
    best_d = torch.clamp_min(best_d, 0.0)       # guard fp-negative d²
    return (torch.where(valid, best_i, 0), _weights(best_d, valid),
            valid.any(-1))


def _dense_approx(q, qm, s, sm, k: int):
    d2 = torch.where(sm[:, None, :], _sq_dist(q, s, False), _BIG)
    vals, idx = top_k(-d2.to(torch.bfloat16), k)
    best_d = torch.clamp_min(-vals.float(), 0.0)
    valid = (best_d < _BIG * 0.5) & qm[..., None]
    return torch.where(valid, idx, 0), _weights(best_d, valid), valid.any(-1)


def dense_three_nn(query_xyz: torch.Tensor, query_mask: torch.Tensor,
                   support_xyz: torch.Tensor, support_mask: torch.Tensor,
                   k: int = 3, block: int = 2048, approx: bool = False):
    """k-NN + inverse-distance weights by brute force (batched): query
    [B, Nq, 3] and support [B, Ns, 3] with masks → (nn_idx [B, Nq, k]
    int64, weights [B, Nq, k], found [B, Nq])."""
    if approx:
        return _dense_approx(query_xyz, query_mask, support_xyz,
                             support_mask, k)
    return _dense_exact(query_xyz, query_mask, support_xyz, support_mask, k,
                        block)


def grid_three_nn(query_xyz: torch.Tensor, query_mask: torch.Tensor,
                  support_xyz: torch.Tensor, support_mask: torch.Tensor,
                  resolution: int, nv: int, key: np.ndarray, k: int = 3,
                  context: int = 3, chunk: int = 8192, row0: int = 0):
    """Grid-indexed k-NN from each query point into the support set, over
    the support's voxel table (built with `key`), `chunk` queries at a
    time.

    Returns:
      nn_idx:  [B, Nq, k] int64 indices into support points (0-padded)
      weights: [B, Nq, k] inverse-distance weights (rows sum to 1 or 0)
      found:   [B, Nq] bool — at least one support point in context
    """
    table = build_voxel_table(support_xyz, support_mask, resolution, nv, key,
                              with_coords=True, row0=row0)
    V = resolution ** 3
    B, Nq, _ = query_xyz.shape
    q_vid = voxel_ids(query_xyz, query_mask, table.origin[:, None],
                      table.vsize[:, None], resolution)
    bidx = torch.arange(B, device=query_xyz.device)[:, None, None]
    out = []
    for c0 in range(0, Nq, chunk):
        qx, qv = query_xyz[:, c0:c0 + chunk], q_vid[:, c0:c0 + chunk]
        C = qx.shape[1]
        nvid, inb = context_neighbors(qv, resolution, context)  # [B, C, P]
        nvid = torch.where(inb, nvid, V)                # sentinel row = BIG
        rows = table.coord_table[bidx, nvid]            # [B, C, P, 3·nv]
        rows = rows.view(B, C, -1, 3, nv)
        d = rows - qx[:, :, None, :, None]
        d2 = (d[..., 0, :] * d[..., 0, :] + d[..., 1, :] * d[..., 1, :]
              + d[..., 2, :] * d[..., 2, :]).reshape(B, C, -1)
        nn_d2, pos = _topk_min(d2, k)
        valid = nn_d2 < _FOUND_THRESH
        # winner → (context voxel, slot) → support point index
        win_vox = torch.clamp_max(torch.gather(nvid, -1, pos // nv), V - 1)
        win_idx = torch.clamp_min(
            table.slots[bidx, win_vox, pos % nv], 0)
        out.append((torch.where(valid, win_idx, 0), _weights(nn_d2, valid),
                    valid.any(-1)))
    return tuple(torch.cat(parts, 1) for parts in zip(*out))


def three_nn_interpolate(support_feat: torch.Tensor, nn_idx: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Inverse-distance feature interpolation: [B,Ns,C] → [B,Nq,C].

    nn_idx [B, Nq, k], weights [B, Nq, k]. The sum runs neighbor by
    neighbor, w0·f0 + w1·f1 + w2·f2 left to right, the JAX package's add
    order."""
    b = torch.arange(support_feat.shape[0],
                     device=support_feat.device)[:, None]
    out = weights[..., 0:1] * support_feat[b, nn_idx[..., 0]]
    for j in range(1, nn_idx.shape[-1]):
        out = out + weights[..., j:j + 1] * support_feat[b, nn_idx[..., j]]
    return out
