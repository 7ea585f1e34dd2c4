"""Coverage-Aware Grid Query — the fused F-01→F-04 pipeline (SURVEY §3.2).

One call per GridConv layer: voxel-table build → center sampling → node
gather, the same three-way key split and call order as the JAX package's
`ops/cagq.py`. Pure index computation: no parameters, no gradients.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gridgcn_torch.configs.base import GridLayerSpec
from gridgcn_torch.ops.gather import GroupedNodes, gather_nodes
from gridgcn_torch.ops.sampling import sample_centers_cas, sample_centers_rvs
from gridgcn_torch.ops.voxelize import VoxelTable, build_voxel_table
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.profiling import annotate


@dataclass
class CAGQOutput:
    table: VoxelTable
    groups: GroupedNodes


def cagq(xyz: torch.Tensor, mask: torch.Tensor, spec: GridLayerSpec,
         key: np.ndarray, bounds=None, row0: int = 0) -> CAGQOutput:
    """Run one layer's CAGQ: xyz [B, N, 3], mask [B, N] → centers + groups.

    Index tensors equal the JAX package's bit for bit for the same key.
    'candidates' context pooling needs the raw [M, P·nv] candidates, so it
    takes the slot-table build and gather (with the raw coverage grid);
    every other layer takes the packed-key path. The clouds are rows
    [row0, row0 + B) of the batch whose key this is. The three steps are
    the spans `voxelize`, `sample` and `gather` in a profiler's trace.
    """
    k_build, k_sample, k_gather = jaxrng.split(key, 3)
    need_candidates = (spec.use_context_pool
                       and spec.context_pool_source == "candidates")
    use_packed = not need_candidates
    r = (spec.context - 1) // 2
    with annotate("voxelize"):
        table = build_voxel_table(
            xyz, mask, spec.resolution, spec.nv, k_build,
            with_keys=use_packed, with_slots=not use_packed, bounds=bounds,
            key_pad=(r, spec.context),
            sel_coords=use_packed and (spec.coord_match
                                       or spec.coord_payload),
            with_coverage=not use_packed, row0=row0)
    with annotate("sample"):
        if spec.sampler == "rvs":
            center_vids, center_valid = sample_centers_rvs(
                table, spec.n_centers, k_sample, approx=spec.approx_select,
                row0=row0)
        elif spec.sampler == "cas":
            center_vids, center_valid = sample_centers_cas(
                table, spec.n_centers, k_sample, context=spec.context,
                cas_iters=spec.cas_iters, approx=spec.approx_select,
                row0=row0)
        else:
            raise ValueError(f"unknown sampler: {spec.sampler}")
    with annotate("gather"):
        groups = gather_nodes(
            table, xyz, center_vids, center_valid, spec.k_neighbors,
            spec.context, k_gather, center_mode=spec.center_mode,
            approx=use_packed, return_candidates=need_candidates,
            approx_topk=spec.approx_topk, row0=row0,
            coord_payload=spec.coord_payload)
    return CAGQOutput(table=table, groups=groups)
