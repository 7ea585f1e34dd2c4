"""Coverage-Aware Grid Query — the fused F-01→F-04 pipeline (SURVEY §3.2).

One call per GridConv layer: voxel-table build → center sampling → node
gather, the same three-way key split and call order as the JAX package's
`ops/cagq.py`. Pure index computation: no parameters, no gradients.
This slice runs the packed-key path with threshold RVS.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gridgcn_torch.configs.base import GridLayerSpec
from gridgcn_torch.ops.gather import GroupedNodes, gather_nodes
from gridgcn_torch.ops.sampling import sample_centers_rvs
from gridgcn_torch.ops.voxelize import VoxelTable, build_voxel_table
from gridgcn_torch.utils import jaxrng


@dataclass
class CAGQOutput:
    table: VoxelTable
    groups: GroupedNodes


def cagq(xyz: torch.Tensor, mask: torch.Tensor, spec: GridLayerSpec,
         key: np.ndarray, bounds=None) -> CAGQOutput:
    """Run one layer's CAGQ: xyz [B, N, 3], mask [B, N] → centers + groups.

    Index tensors equal the JAX package's bit for bit for the same key.
    """
    k_build, k_sample, k_gather = jaxrng.split(key, 3)
    if spec.use_context_pool and spec.context_pool_source == "candidates":
        raise NotImplementedError(
            "'candidates' context pooling needs the slot-table gather, "
            "which is not ported yet")
    if spec.sampler != "rvs":
        raise NotImplementedError(f"sampler {spec.sampler!r} is not ported")
    if spec.coord_match or spec.coord_payload:
        raise NotImplementedError("coord_match/coord_payload gathers are "
                                  "not ported")
    r = (spec.context - 1) // 2
    table = build_voxel_table(xyz, mask, spec.resolution, spec.nv, k_build,
                              with_keys=True, with_slots=False,
                              bounds=bounds, key_pad=(r, spec.context),
                              sel_coords=False, with_coverage=False)
    center_vids, center_valid = sample_centers_rvs(
        table, spec.n_centers, k_sample, approx=spec.approx_select)
    groups = gather_nodes(
        table, xyz, center_vids, center_valid, spec.k_neighbors,
        spec.context, k_gather, center_mode=spec.center_mode, approx=True,
        approx_topk=spec.approx_topk)
    return CAGQOutput(table=table, groups=groups)
