"""Validation: the voxel tables' capacity audit and non-finite checks.

  * `check_capacity` flags a voxel table whose capacity nv drops too many
    points for a config; `audit_layer0_capacity` measures layer 0's drop
    on a sample of a dataset and `propose_layer0_capacity` finds the
    smallest (nv, resolution) that keeps it within a budget. They return
    the JAX package's dicts for the same points.
  * `debug_mode` turns on autograd's anomaly detection for a scope (a NaN
    produced in the backward pass raises where it arose).
  * `checkify_call` runs a function and raises if an output is not finite.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from gridgcn_torch.ops.voxelize import (
    VoxelTable, build_voxel_table, capacity_stats)
from gridgcn_torch.utils import jaxrng


def check_capacity(table: VoxelTable, max_dropped_frac: float = 0.05):
    """Raises if the table's nv drops more than the budget of some cloud's
    points; returns `capacity_stats(table)`. For tuning a config's
    (resolution, nv) on a representative batch, not for the hot path."""
    stats = capacity_stats(table)
    frac = float(torch.max(stats["dropped_frac"]))
    if frac > max_dropped_frac:
        raise ValueError(
            f"voxel table drops {frac:.1%} of points (> {max_dropped_frac:.1%}); "
            f"raise nv (={table.nv}) or resolution (={table.resolution})")
    return stats


def _layer0_drop(points, res: int, nv: int, max_clouds: int):
    """(worst cloud's dropped fraction, most occupied voxels, clouds) of a
    layer-0 table over the first max_clouds clouds, built on the CPU with
    PRNGKey(0)."""
    pts = torch.as_tensor(points[:max_clouds], dtype=torch.float32)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    st = capacity_stats(build_voxel_table(pts, mask, res, nv,
                                          jaxrng.PRNGKey(0)))
    return (float(torch.max(st["dropped_frac"])),
            int(torch.max(st["occupied_voxels"])), int(pts.shape[0]))


def audit_layer0_capacity(cfg, points, budget: float = 0.05,
                          max_clouds: int = 8) -> dict:
    """What fraction of points does layers[0]'s (resolution, nv) drop on a
    sample of a dataset? Real data has other occupancy skew than the
    synthetic scenes the presets were sized on, so the trainer logs this
    at step 0. `over_budget` flags a worst-cloud fraction above budget."""
    spec = cfg.model.layers[0]
    frac, occupied, clouds = _layer0_drop(points, spec.resolution, spec.nv,
                                          max_clouds)
    return {
        "layer": 0, "resolution": spec.resolution, "nv": spec.nv,
        "clouds_sampled": clouds,
        "dropped_frac": round(frac, 5),
        "occupied_voxels": occupied,
        "budget": budget, "over_budget": frac > budget,
    }


def propose_layer0_capacity(cfg, points, budget: float = 0.05,
                            max_clouds: int = 8) -> dict:
    """The smallest layer-0 capacity bump that brings the dropped fraction
    within budget, cheapest lever first: nv doubles from the configured
    value up to 64; if nv=64 still drops too much, the resolution doubles
    once with the configured nv. Returns the proposal and every point
    audited."""
    spec = cfg.model.layers[0]
    tried = []

    def audit(res, nv):
        f = _layer0_drop(points, res, nv, max_clouds)[0]
        tried.append({"resolution": res, "nv": nv,
                      "dropped_frac": round(f, 5)})
        return f

    res, nv = spec.resolution, spec.nv
    f = audit(res, nv)
    while f > budget and nv < 64:
        nv = min(2 * nv, 64)
        f = audit(res, nv)
    if f > budget:
        res, nv = 2 * spec.resolution, spec.nv
        f = audit(res, nv)
    return {"nv": nv, "resolution": res, "dropped_frac": round(f, 5),
            "budget": budget, "within_budget": f <= budget,
            "tried": tried}


@contextlib.contextmanager
def debug_mode():
    """NaN debugging for a scope: `with debug_mode(): step(...)`. Restores
    the prior setting on exit."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def checkify_call(fn: Callable, *args):
    """fn(*args), raising ValueError if a floating-point tensor among its
    outputs (a tensor, or a tuple, list or dict of them) holds a NaN or an
    infinity."""
    out = fn(*args)
    leaves = (out.values() if isinstance(out, dict)
              else out if isinstance(out, (tuple, list)) else (out,))
    for i, t in enumerate(leaves):
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and not bool(torch.isfinite(t).all())):
            raise ValueError(f"output {i} of {getattr(fn, '__name__', fn)} "
                             f"is not finite")
    return out
