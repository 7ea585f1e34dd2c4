"""F-09: GridGCN classification network for ModelNet40 (SURVEY.md §2.2).

A stack of GridConv downsampling layers (progressively fewer centers) →
global masked max-pool over the last level's centers → FC head (Dense,
BatchNorm, ReLU, dropout per width) → float32 logits, module for module the
JAX package's `models/classifier.py`. Module names follow flax
(`gridconv{i}`, `head_dense{h}`, `head_bn{h}`, `logits`), so converted
weights load by name and `models.fold` folds them. Training mode works as
in `models/segmentation.py`; the head's dropout layers are flax's compact
`Dropout_{h}` modules, each with its own key. Each stage is the span
`gridconv{i}`, as in the segmentation network; the pool, the head MLP and
the logits are the span `head`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from gridgcn_torch.configs.base import ModelConfig
from gridgcn_torch.models.gridconv import GridConv, run_stage
from gridgcn_torch.models.layers import Dense, add_mlp, run_mlp, to_dtype
from gridgcn_torch.utils.jaxrng import flax_make_rng
from gridgcn_torch.utils.profiling import annotate

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
                dropout_key: np.ndarray | None = None,
                row0: int = 0) -> torch.Tensor:
        """xyz [B, N, 3] f32, feat [B, N, in_channels] or None, mask [B, N]
        bool, key and dropout_key: the jaxrng keys that the JAX package
        passes as rngs={"cagq": key, "dropout": dropout_key} (dropout_key
        only in training with dropout) → logits [B, num_classes] f32.
        row0: the clouds are rows [row0, row0 + B) of the batch whose keys
        these are (a data-parallel rank's rows of the global batch)."""
        cfg = self.cfg
        if cfg.use_xyz_feature:
            feat = xyz if feat is None else torch.cat([xyz, feat], -1)
        for i in range(len(cfg.layers)):
            with annotate(f"gridconv{i}"):
                # flax: self.make_rng("cagq") inside module gridconv{i}
                k = flax_make_rng(key, (f"gridconv{i}",), 1)
                xyz, feat, mask = run_stage(getattr(self, f"gridconv{i}"),
                                            cfg.remat, xyz, feat, mask, k,
                                            None, row0)

        keys = None if dropout_key is None else [
            flax_make_rng(dropout_key, (f"Dropout_{h}",), 1)
            for h in range(len(cfg.head))]
        with annotate("head"):
            # global masked max-pool (in the compute dtype); a cloud with no
            # valid center pools to 0
            x = torch.where(mask[..., None], feat, _NEG_INF).amax(dim=-2)
            x = torch.where(mask.any(dim=-1, keepdim=True), x, 0.0)
            x = run_mlp(self, "head", len(cfg.head), x, cfg.fold_bn,
                        cfg.dropout, keys, row0)
            return self.logits(x)
