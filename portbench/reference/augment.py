"""Point-cloud augmentation on the batch's device (the JAX package's
`data/augment.py`): random rotation about the up (y) axis, scale, shift,
clipped jitter and point dropout, every draw from the jaxrng key the train
step derives, so the same key gives the JAX package's draws bit for bit.

The rotated coordinates may differ from the JAX package's by an ulp:
`torch.cos`/`torch.sin` round some float32 values differently from
XLA:CPU's, and the 3-term rotation products sum in another order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import DataConfig
from . import jaxrng


def augment_draws(key: np.ndarray, B: int, N: int, cfg: DataConfig,
                  device, row0: int = 0) -> dict:
    """Every draw `augment_batch` makes for key and config: theta [B],
    scale [B, 1, 1], shift [B, 1, 3], noise [B, N, 3] (the clipped
    jitter), ratio [B, 1] and u [B, N] (point dropout); a draw that the
    config turns off is absent. The key splits 6 ways as in JAX. The B
    clouds are rows [row0, row0 + B) of the batch whose key this is."""
    k_rot, k_scale, k_shift, k_jit, k_drop, k_dropn = jaxrng.split(key, 6)
    out = {}
    if cfg.rotate:
        out["theta"] = jaxrng.uniform(k_rot, (B,), device, 0.0, 2.0 * math.pi,
                                      row0=row0)
    if cfg.scale_high > cfg.scale_low:
        out["scale"] = jaxrng.uniform(k_scale, (B, 1, 1), device,
                                      cfg.scale_low, cfg.scale_high,
                                      row0=row0)
    if cfg.shift_range > 0:
        out["shift"] = jaxrng.uniform(k_shift, (B, 1, 3), device,
                                      -cfg.shift_range, cfg.shift_range,
                                      row0=row0)
    if cfg.jitter_sigma > 0:
        sigma = float(np.float32(cfg.jitter_sigma))
        out["noise"] = torch.clamp(
            sigma * jaxrng.normal(k_jit, (B, N, 3), device, row0=row0),
            -cfg.jitter_clip, cfg.jitter_clip)
    if cfg.dropout_max > 0:
        out["ratio"] = jaxrng.uniform(k_drop, (B, 1), device,
                                      maxval=cfg.dropout_max, row0=row0)
        out["u"] = jaxrng.uniform(k_dropn, (B, N), device, row0=row0)
    return out


def rotation_y(theta: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotations by theta about the up (y) axis, PointNet++
    convention: rows (c, 0, s), (0, 1, 0), (−s, 0, c)."""
    c, s = torch.cos(theta), torch.sin(theta)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, zeros, s], -1),
                        torch.stack([zeros, ones, zeros], -1),
                        torch.stack([-s, zeros, c], -1)], -2)


def augment_batch(xyz: torch.Tensor, mask: torch.Tensor, key: np.ndarray,
                  cfg: DataConfig, feat: torch.Tensor | None = None,
                  row0: int = 0):
    """Rotation (up axis) + scale + shift + jitter + point dropout:
    xyz [B, N, 3] f32, mask [B, N] bool, feat [B, N, C] or None → (xyz,
    mask, feat). The feature columns `cfg.feat_geo_channels` rotate with
    the cloud; dropped points leave the mask. The clouds are rows [row0,
    row0 + B) of the batch whose key this is."""
    if not cfg.augment:
        return xyz, mask, feat
    B, N = xyz.shape[:2]
    d = augment_draws(key, B, N, cfg, xyz.device, row0)
    if "theta" in d:
        rot = rotation_y(d["theta"])                           # [B, 3, 3]
        xyz = torch.bmm(xyz, rot)
        geo = list(cfg.feat_geo_channels)
        if feat is not None and geo:
            if len(geo) != 3:
                raise ValueError("feat_geo_channels must name 3 columns")
            feat = feat.clone()
            feat[..., geo] = torch.bmm(feat[..., geo].to(xyz.dtype),
                                       rot).to(feat.dtype)
    if "scale" in d:
        xyz = xyz * d["scale"]
    if "shift" in d:
        xyz = xyz + d["shift"]
    if "noise" in d:
        xyz = xyz + d["noise"]
    if "ratio" in d:
        mask = mask & (d["u"] >= d["ratio"])
    return xyz, mask, feat
