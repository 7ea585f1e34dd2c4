"""F-08: GridConv block = CAGQ ∘ GCA (SURVEY.md §2.2, paper §3).

CAGQ (pure index computation) runs first; its indices drive the gathers of
node positions and features, and GCA does the dense work. The layer's CAGQ
key is passed in: the network derives it from the forward's key the way
flax's `make_rng("cagq")` does in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import GridLayerSpec
from .gca import GCA
from .cagq import cagq


def gather_point_features(feat: torch.Tensor, idx: torch.Tensor):
    """Batched take: feat [B, N, C], idx [B, M, K] → [B, M, K, C]."""
    b = torch.arange(feat.shape[0], device=feat.device)[:, None, None]
    return feat[b, idx]


def run_stage(conv: nn.Module, remat: bool, *args):
    """conv(*args); with remat, in training, the stage's activations are
    recomputed in the backward pass, as the JAX package's
    `nn.remat(GridConv)` does (the same key gives the same CAGQ
    indices)."""
    if remat and conv.training and torch.is_grad_enabled():
        return checkpoint(conv, *args, use_reentrant=False)
    return conv(*args)


class GridConv(nn.Module):
    def __init__(self, spec: GridLayerSpec, in_channels: int,
                 dtype: torch.dtype = torch.float32, fold_bn: bool = False,
                 att_dtype: Optional[torch.dtype] = None,
                 bn_dtype: Optional[torch.dtype] = None,
                 feat_has_xyz_prefix: bool = False,
                 bn_momentum: float = 0.9):
        """in_channels: width of the level's point features (0: none).
        feat_has_xyz_prefix: feat[..., :3] is the raw xyz (the input layer
        with use_xyz_feature), so those channels come from the gathered
        node positions instead of a second gather."""
        super().__init__()
        self.spec = spec
        self.feat_has_xyz_prefix = feat_has_xyz_prefix
        self.gca = GCA(spec, in_channels, dtype=dtype, fold_bn=fold_bn,
                       att_dtype=att_dtype, bn_dtype=bn_dtype,
                       bn_momentum=bn_momentum)

    def forward(self, xyz: torch.Tensor, feat: Optional[torch.Tensor],
                mask: torch.Tensor, key: np.ndarray, bounds=None,
                row0: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One downsampling stage: xyz [B, N, 3] f32, feat [B, N, C] or
        None, mask [B, N] → (center_xyz [B, M, 3], center_feat [B, M, Co],
        center_valid [B, M]). The clouds are rows [row0, row0 + B) of the
        batch whose key this is."""
        g = cagq(xyz, mask, self.spec, key, bounds=bounds, row0=row0).groups
        # node positions are always the f32 gather of xyz (g.node_xyz); the
        # JAX package's bf16 bitcast-pair gather gives the same values
        node_xyz = g.node_xyz
        if feat is None:
            node_feat = None
        elif self.feat_has_xyz_prefix:
            nxyz = node_xyz.to(feat.dtype)
            if feat.shape[-1] > 3:
                rest = gather_point_features(feat[..., 3:], g.neighbor_idx)
                node_feat = torch.cat([nxyz, rest], dim=-1)
            else:
                node_feat = nxyz
        else:
            node_feat = gather_point_features(feat, g.neighbor_idx)

        delta_p = node_xyz - g.center_xyz[:, :, None, :]
        delta_p = torch.where(g.neighbor_mask[..., None], delta_p, 0.0)
        # 'candidates' context pooling: the masked mean over every stored
        # context point, in place of GCA's mean over the K nodes
        ctx_feat = None
        if g.cand_idx is not None and feat is not None:
            cand_feat = gather_point_features(feat, g.cand_idx)
            w = g.cand_valid[..., None].to(cand_feat.dtype)
            denom = torch.clamp_min(w.sum(dim=-2), 1.0)
            ctx_feat = (cand_feat * w).sum(dim=-2) / denom
        center_feat = self.gca(node_feat, delta_p, g.neighbor_mask,
                               g.node_coverage, ctx_feat=ctx_feat)
        return g.center_xyz, center_feat, g.center_valid
