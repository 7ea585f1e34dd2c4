"""F-10: GridGCN segmentation network (S3DIS / ScanNet), SURVEY.md §2.2, §3.4.

PointNet++-style encoder–decoder built from GridConv stages:
  encoder: cfg.layers GridConv downsampling stages (levels cached for skips)
  decoder: per stage — 3-NN query + inverse-distance interpolation +
           skip-concat + shared MLP
  head:    per-point MLP → class logits.

Module names follow the JAX package (`gridconv{i}`, `up{i}_dense{j}`,
`up{i}_bn{j}`, `head_dense{h}`, `head_bn{h}`, `logits`), so converted flax
weights load by name. In training mode (`model.train()`) the BatchNorms
use batch statistics, the head's dropout draws its masks from the
forward's dropout key as flax's `"dropout"` stream does, and `cfg.remat`
recomputes each GridConv stage in the backward pass. Each decoder stage's
3-NN query follows its `UpLayerSpec.method`: "pallas" is the CUDA
flash-kNN kernel (its plain version for CPU tensors), "dense" the
brute-force query, "grid" the voxel-table query, and "auto" dense up to
`_DENSE_KNN_MAX_SUPPORT` coarse points and grid above.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from gridgcn_torch.configs.base import ModelConfig
from gridgcn_torch.kernels.knn import flash_three_nn
from gridgcn_torch.models.gridconv import GridConv, run_stage
from gridgcn_torch.models.layers import Dense, add_mlp, run_mlp, to_dtype
from gridgcn_torch.ops.upsample import (
    dense_three_nn, grid_three_nn, three_nn_interpolate)
from gridgcn_torch.utils.jaxrng import flax_make_rng
from gridgcn_torch.utils.profiling import annotate

# above this coarse-level size the voxel-table query wins over brute force
_DENSE_KNN_MAX_SUPPORT = 16384
_METHODS = ("pallas", "dense", "grid", "auto")


class GridGCNSegmentation(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if len(cfg.up_layers) != len(cfg.layers):
            raise ValueError("seg model needs one up_layer per encoder layer")
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
            if up.method not in _METHODS:
                raise ValueError(f"unknown decoder method {up.method!r}; "
                                 f"expected one of {_METHODS}")
            c += widths[-2 - i] or 3          # skip: level feat, else xyz
            c = add_mlp(self, f"up{i}", c, up.mlp, dtype, bdt, cfg.fold_bn,
                        cfg.bn_momentum)
        c = add_mlp(self, "head", c, cfg.head, dtype, bdt, cfg.fold_bn,
                    cfg.bn_momentum)
        self.logits = Dense(c, cfg.num_classes, torch.float32)

    # ---- pieces ----

    def encode_layer(self, i: int, xyz, feat, mask, key: np.ndarray,
                     bounds=None, row0: int = 0):
        """GridConv stage i: one CAGQ + GCA downsampling step
        (rematerialized in training with cfg.remat); the span
        `gridconv{i}`. `key`: the layer's CAGQ key, or a function that
        derives it inside the span (a tensor key's hash is then the
        layer's work in a trace)."""
        with annotate(f"gridconv{i}"):
            if callable(key):
                key = key()
            return run_stage(getattr(self, f"gridconv{i}"), self.cfg.remat,
                             xyz, feat, mask, key, bounds, row0)

    def uses_grid(self, i: int, n_support: int) -> bool:
        """Whether decoder stage i queries through the voxel grid for a
        coarse level of n_support points (it then draws a CAGQ key)."""
        method = self.cfg.up_layers[i].method
        return method == "grid" or (method == "auto"
                                    and n_support > _DENSE_KNN_MAX_SUPPORT)

    def decode_stage(self, i: int, c_xyz, c_feat, c_mask,
                     d_xyz, d_feat, d_mask, key: np.ndarray | None = None,
                     row0: int = 0):
        """Feature-propagation stage i: 3-NN interpolation from the coarse
        level (c_*) to the dense level (d_*), skip-concat, shared MLP. `key`
        is the grid query's voxel-build key (grid stages only), or a
        function that derives it inside the query's span. The stage is the
        span `up{i}`, its query the span `knn3`."""
        up = self.cfg.up_layers[i]
        with annotate(f"up{i}"):
            with annotate("knn3"):
                if up.method == "pallas":
                    nn_idx, weights, _ = flash_three_nn(
                        d_xyz, d_mask, c_xyz, c_mask, k=up.k_interp)
                elif self.uses_grid(i, c_xyz.shape[1]):
                    if key is None:
                        raise ValueError(f"decoder stage {i} queries the "
                                         "grid and needs a key")
                    if callable(key):
                        key = key()
                    nn_idx, weights, _ = grid_three_nn(
                        d_xyz, d_mask, c_xyz, c_mask, up.resolution, up.nv,
                        key, k=up.k_interp, context=up.context, row0=row0)
                else:
                    nn_idx, weights, _ = dense_three_nn(
                        d_xyz, d_mask, c_xyz, c_mask, k=up.k_interp,
                        approx=up.approx_knn)
            idt = self.interp_dtype
            interp = three_nn_interpolate(
                c_feat.to(idt), nn_idx, weights.to(idt)).to(self.dtype)
            skip = d_feat if d_feat is not None else d_xyz
            x = torch.cat([interp, skip.to(self.dtype)], dim=-1)
            x = run_mlp(self, f"up{i}", len(up.mlp), x, self.cfg.fold_bn)
            return torch.where(d_mask[..., None], x, 0.0)

    def head_logits(self, x, dropout_key: np.ndarray | None = None,
                    row0: int = 0):
        """Per-point classification head (logits in float32). In training,
        head layer h drops out under flax's key for the h-th call of the
        network's one `Dropout` submodule, `_dropout`. The span `head`."""
        n = len(self.cfg.head)
        keys = None if dropout_key is None else [
            flax_make_rng(dropout_key, ("_dropout",), h + 1) for h in range(n)]
        with annotate("head"):
            return self.logits(run_mlp(self, "head", n, x, self.cfg.fold_bn,
                                       self.cfg.dropout, keys, row0))

    # ---- full network ----

    def forward(self, xyz: torch.Tensor, feat: Optional[torch.Tensor],
                mask: torch.Tensor, key: np.ndarray,
                dropout_key: np.ndarray | None = None,
                row0: int = 0) -> torch.Tensor:
        """xyz [B, N, 3] f32, feat [B, N, in_channels] or None, mask [B, N]
        bool, key and dropout_key: the jaxrng keys that the JAX package
        passes as rngs={"cagq": key, "dropout": dropout_key} (dropout_key
        only in training with dropout) → logits [B, N, num_classes] f32.
        row0: the clouds are rows [row0, row0 + B) of the batch whose keys
        these are (a data-parallel rank's rows of the global batch)."""
        cfg = self.cfg
        if cfg.use_xyz_feature:
            feat = xyz if feat is None else torch.cat([xyz, feat], -1)

        levels = [(xyz, feat, mask)]
        for i in range(len(cfg.layers)):
            # flax: self.make_rng("cagq") inside module gridconv{i}
            k = functools.partial(flax_make_rng, key, (f"gridconv{i}",), 1)
            xyz, feat, mask = self.encode_layer(i, xyz, feat, mask, k,
                                                row0=row0)
            levels.append((xyz, feat, mask))

        c_xyz, c_feat, c_mask = levels[-1]
        n_grid = 0
        for i in range(len(cfg.up_layers)):
            d_xyz, d_feat, d_mask = levels[-2 - i]
            k = None
            if self.uses_grid(i, c_xyz.shape[1]):
                # flax: self.make_rng("cagq") in the root module's scope,
                # whose counter only the grid stages advance
                n_grid += 1
                k = functools.partial(flax_make_rng, key, (), n_grid)
            c_feat = self.decode_stage(i, c_xyz, c_feat, c_mask,
                                       d_xyz, d_feat, d_mask, k, row0)
            c_xyz, c_mask = d_xyz, d_mask
        return self.head_logits(c_feat, dropout_key, row0)
