"""Shared voxel-grid index arithmetic for CAGQ (F-01..F-05), and the
top-k order every selection in the port uses."""

from __future__ import annotations

import numpy as np
import torch


def vid_to_coords(vid: torch.Tensor, resolution: int):
    """Linear voxel id → (x, y, z) integer grid coordinates."""
    z = vid % resolution
    y = (vid // resolution) % resolution
    x = vid // (resolution * resolution)
    return x, y, z


def context_offsets(context: int) -> np.ndarray:
    """Static [context³, 3] array of context-neighborhood offsets π(v),
    x slowest and z fastest (3 → the 3×3×3 block centered on the voxel)."""
    r = np.arange(context) - (context - 1) // 2
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)


_CONSTANTS: dict = {}


def device_constant(values: np.ndarray, dtype: torch.dtype,
                    device) -> torch.Tensor:
    """`torch.as_tensor(values, dtype=dtype, device=device)`, made once per
    value and device and kept: a forward that a CUDA graph captures may
    not copy a host array to the card (the eager call before a capture
    makes it). A tensor made under a tracer (`torch.export`'s fake
    tensors) is returned and not kept."""
    key = (values.dtype.str, values.shape, values.tobytes(), dtype,
           torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.as_tensor(values, dtype=dtype, device=device)
        if type(t) is torch.Tensor:
            _CONSTANTS[key] = t
    return t


def context_neighbors(vid: torch.Tensor, resolution: int, context: int):
    """Voxel ids of the context neighborhood π(v) for each input voxel.

    Args:
      vid: [...] linear voxel ids (may include the sentinel V for invalid).
    Returns:
      nvid: [..., context³] neighbor linear ids (clipped; see inb)
      inb:  [..., context³] bool — neighbor lies inside the grid AND the
            query voxel itself was valid.
    """
    V = resolution ** 3
    offs = device_constant(context_offsets(context), vid.dtype, vid.device)
    x, y, z = vid_to_coords(torch.clamp_max(vid, V - 1), resolution)
    nx = x[..., None] + offs[:, 0]
    ny = y[..., None] + offs[:, 1]
    nz = z[..., None] + offs[:, 2]
    inb = ((nx >= 0) & (nx < resolution) & (ny >= 0) & (ny < resolution)
           & (nz >= 0) & (nz < resolution) & (vid[..., None] < V))
    nvid = ((nx.clamp(0, resolution - 1) * resolution
             + ny.clamp(0, resolution - 1)) * resolution
            + nz.clamp(0, resolution - 1))
    return nvid, inb


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis,
    largest first and, among equal values, lower index first — the order
    of `lax.top_k` (torch.topk does not keep it): a stable descending
    sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
