"""F-10: GridGCN segmentation network (S3DIS / ScanNet), SURVEY.md §2.2, §3.4.

PointNet++-style encoder–decoder built from GridConv stages:
  encoder: cfg.layers GridConv downsampling stages (levels cached for skips)
  decoder: per stage — 3-NN query + inverse-distance interpolation +
           skip-concat + shared MLP
  head:    per-point MLP → class logits.

Module names follow the JAX package (`gridconv{i}`, `up{i}_dense{j}`,
`up{i}_bn{j}`, `head_dense{h}`, `head_bn{h}`, `logits`), so converted flax
weights load by name. The decoder ports `method="pallas"`: its 3-NN query is
the CUDA flash-kNN kernel for CUDA tensors and its plain version for CPU
tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gridgcn_torch.configs.base import ModelConfig
from gridgcn_torch.kernels.knn import flash_three_nn
from gridgcn_torch.models.gridconv import GridConv
from gridgcn_torch.models.layers import BatchNorm, Dense, to_dtype
from gridgcn_torch.ops.upsample import three_nn_interpolate
from gridgcn_torch.utils.jaxrng import flax_make_rng


class GridGCNSegmentation(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if len(cfg.up_layers) != len(cfg.layers):
            raise ValueError("seg model needs one up_layer per encoder layer")
        if cfg.remat:
            raise NotImplementedError("remat belongs to the training slice")
        self.cfg = cfg
        dtype = to_dtype(cfg.dtype)
        self.dtype = dtype
        adt = to_dtype(cfg.att_dtype) if cfg.att_dtype else None
        bdt = to_dtype(cfg.bn_dtype) if cfg.bn_dtype else dtype
        self.interp_dtype = to_dtype(cfg.interp_dtype) if cfg.interp_dtype \
            else dtype

        # feature width per level (0: the level carries no features)
        widths = [cfg.in_channels + (3 if cfg.use_xyz_feature else 0)]
        for i, spec in enumerate(cfg.layers):
            self.add_module(f"gridconv{i}", GridConv(
                spec, widths[-1], dtype=dtype, fold_bn=cfg.fold_bn,
                att_dtype=adt, bn_dtype=(None if cfg.bn_dtype == "" else bdt),
                feat_has_xyz_prefix=(i == 0 and cfg.use_xyz_feature)))
            widths.append(spec.mlp[-1])

        c = widths[-1]
        for i, up in enumerate(cfg.up_layers):
            if up.method != "pallas":
                raise NotImplementedError(
                    f"decoder method {up.method!r} is not ported yet")
            c += widths[-2 - i] or 3          # skip: level feat, else xyz
            for li, w in enumerate(up.mlp):
                self.add_module(f"up{i}_dense{li}", Dense(c, w, dtype))
                if not cfg.fold_bn:
                    self.add_module(f"up{i}_bn{li}", BatchNorm(w, bdt))
                c = w
        for hi, w in enumerate(cfg.head):
            self.add_module(f"head_dense{hi}", Dense(c, w, dtype))
            if not cfg.fold_bn:
                self.add_module(f"head_bn{hi}", BatchNorm(w, bdt))
            c = w
        self.logits = Dense(c, cfg.num_classes, torch.float32)

    # ---- pieces ----

    def encode_layer(self, i: int, xyz, feat, mask, key: np.ndarray,
                     bounds=None):
        """GridConv stage i: one CAGQ + GCA downsampling step."""
        return getattr(self, f"gridconv{i}")(xyz, feat, mask, key, bounds)

    def _mlp(self, stem: str, n: int, x, dropout: float = 0.0):
        for li in range(n):
            x = getattr(self, f"{stem}_dense{li}")(x)
            if not self.cfg.fold_bn:
                x = getattr(self, f"{stem}_bn{li}")(x)
            x = torch.relu(x)
            if dropout > 0:
                x = F.dropout(x, dropout, training=self.training)
        return x

    def decode_stage(self, i: int, c_xyz, c_feat, c_mask,
                     d_xyz, d_feat, d_mask):
        """Feature-propagation stage i: 3-NN interpolation from the coarse
        level (c_*) to the dense level (d_*), skip-concat, shared MLP."""
        up = self.cfg.up_layers[i]
        nn_idx, weights, _ = flash_three_nn(d_xyz, d_mask, c_xyz, c_mask,
                                            k=up.k_interp)
        idt = self.interp_dtype
        interp = three_nn_interpolate(
            c_feat.to(idt), nn_idx, weights.to(idt)).to(self.dtype)
        skip = d_feat if d_feat is not None else d_xyz
        x = torch.cat([interp, skip.to(self.dtype)], dim=-1)
        x = self._mlp(f"up{i}", len(up.mlp), x)
        return torch.where(d_mask[..., None], x, 0.0)

    def head_logits(self, x):
        """Per-point classification head (logits in float32)."""
        return self.logits(self._mlp("head", len(self.cfg.head), x,
                                     dropout=self.cfg.dropout))

    # ---- full network ----

    def forward(self, xyz: torch.Tensor, feat: Optional[torch.Tensor],
                mask: torch.Tensor, key: np.ndarray) -> torch.Tensor:
        """xyz [B, N, 3] f32, feat [B, N, in_channels] or None, mask [B, N]
        bool, key: the jaxrng key that the JAX package passes as
        rngs={"cagq": key} → logits [B, N, num_classes] f32."""
        cfg = self.cfg
        if cfg.use_xyz_feature:
            feat = xyz if feat is None else torch.cat([xyz, feat], -1)

        levels = [(xyz, feat, mask)]
        for i in range(len(cfg.layers)):
            # flax: self.make_rng("cagq") inside module gridconv{i}
            k = flax_make_rng(key, (f"gridconv{i}",), 1)
            xyz, feat, mask = self.encode_layer(i, xyz, feat, mask, k)
            levels.append((xyz, feat, mask))

        c_xyz, c_feat, c_mask = levels[-1]
        for i in range(len(cfg.up_layers)):
            d_xyz, d_feat, d_mask = levels[-2 - i]
            c_feat = self.decode_stage(i, c_xyz, c_feat, c_mask,
                                       d_xyz, d_feat, d_mask)
            c_xyz, c_mask = d_xyz, d_mask
        return self.head_logits(c_feat)
