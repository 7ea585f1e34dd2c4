"""F-09: the plain reference of the Grid-GCN classifier (SURVEY.md §2.2,
arXiv:1912.02984 §4.3), module for module the port's
`models/classifier.py`: the reference's GridConv stages (CAGQ then GCA)
with fewer centers each, a global masked max-pool over the last level's
centers, then the head (Dense, BatchNorm, ReLU, dropout per width) and
float32 logits [B, C]. Plain torch in float32 (TF32 off: `serve.py` and
`train.py` call it inside `precision.full_fp32`), with no kernel, cache or
batching beyond the batch it is given; it imports only the reference's
other modules, numpy and torch. Module names follow the port's
(`gridconv{i}`, `head_dense{h}`, `head_bn{h}`, `logits`), so the
benchmark's seeded weights load by name; each layer's CAGQ key is derived
as the segmentation network derives it (flax's `make_rng("cagq")` inside
`gridconv{i}`).

Departures from the paper, all the repo's preset values (`modelnet40_cas`)
that no file in the repo checks against the paper's tables (SURVEY.md §0):
the per-layer grids (16³, 8³, 4³), the voxel capacities `nv` (8, 16, 32),
the center counts (512, 128, 32), K = 32 nodes a center, context 3, CAS
with 2 rounds in every layer, the GCA widths (MLPs (64, 128), (128, 256),
(256, 512), context channels 32 / 64 / 128, attention hidden 16) and the
head (512, 256). Group centers are the barycenters of the center voxels'
stored points (the repo's `center_mode`); the head's pool is a max over the
last level's centers."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .config import ModelConfig
from .gridconv import GridConv, run_stage
from .jaxrng import flax_make_rng
from .layers import Dense, add_mlp, run_mlp, to_dtype

_NEG_INF = -1e30


class GridGCNClassifier(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dtype = to_dtype(cfg.dtype)
        adt = to_dtype(cfg.att_dtype) if cfg.att_dtype else None
        bdt = to_dtype(cfg.bn_dtype) if cfg.bn_dtype else dtype
        c = cfg.in_channels + (3 if cfg.use_xyz_feature else 0)
        for i, spec in enumerate(cfg.layers):
            self.add_module(f"gridconv{i}", GridConv(
                spec, c, dtype=dtype, fold_bn=cfg.fold_bn, att_dtype=adt,
                bn_dtype=(None if cfg.bn_dtype == "" else bdt),
                feat_has_xyz_prefix=(i == 0 and cfg.use_xyz_feature),
                bn_momentum=cfg.bn_momentum))
            c = spec.mlp[-1]
        c = add_mlp(self, "head", c, cfg.head, dtype, bdt, cfg.fold_bn,
                    cfg.bn_momentum)
        self.logits = Dense(c, cfg.num_classes, torch.float32)

    def forward(self, xyz: torch.Tensor, feat: Optional[torch.Tensor],
                mask: torch.Tensor, key: np.ndarray,
                dropout_key: np.ndarray | None = None) -> torch.Tensor:
        """xyz [B, N, 3] f32, feat [B, N, in_channels] or None, mask [B, N]
        bool, key (and in training dropout_key) the jaxrng keys → logits
        [B, num_classes] f32."""
        cfg = self.cfg
        if cfg.use_xyz_feature:
            feat = xyz if feat is None else torch.cat([xyz, feat], -1)
        for i in range(len(cfg.layers)):
            k = flax_make_rng(key, (f"gridconv{i}",), 1)
            xyz, feat, mask = run_stage(getattr(self, f"gridconv{i}"),
                                        cfg.remat, xyz, feat, mask, k)
        # a cloud with no valid center pools to 0
        x = torch.where(mask[..., None], feat, _NEG_INF).amax(dim=-2)
        x = torch.where(mask.any(dim=-1, keepdim=True), x, 0.0)
        keys = None if dropout_key is None else [
            flax_make_rng(dropout_key, (f"Dropout_{h}",), 1)
            for h in range(len(cfg.head))]
        x = run_mlp(self, "head", len(cfg.head), x, cfg.fold_bn, cfg.dropout,
                    keys)
        return self.logits(x)
