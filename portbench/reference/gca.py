"""F-07: Grid Context Aggregation (SURVEY.md §2.2, §3.3; paper §3.2).

For every (center i, node j) pair
    edge feature   f̃_ij = MLP_e([f_j ; Δp_ij ; |Δp_ij|])
    attention      e_ij = MLP_a([geo_ij ; coverage_j ; ctx_i])
    output         out_i = pool_j ( mask ⊙ e_ij · f̃_ij )
where coverage_j is the raw-point count of node j's voxel and ctx_i is a
masked pool over the group's node features. Dense [B, M, K, C] work,
module for module the JAX package's `models/gca.py`, including its dtype
islands (`att_dtype` for the attention path, `bn_dtype` for BatchNorm).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import GridLayerSpec
from .layers import BatchNorm, Dense

_NEG_INF = -1e30


class GCA(nn.Module):
    def __init__(self, spec: GridLayerSpec, in_channels: int,
                 dtype: torch.dtype = torch.float32, fold_bn: bool = False,
                 att_dtype: Optional[torch.dtype] = None,
                 bn_dtype: Optional[torch.dtype] = None,
                 bn_momentum: float = 0.9):
        """in_channels: width of the node features (0: none, geometry
        only). In training mode the edge BatchNorms take their statistics
        over every (center, node) row, masked rows included, as the JAX
        package's do: the mask applies after the ReLU."""
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.fold_bn = fold_bn
        self.att_dtype = dtype if att_dtype is None else att_dtype
        bdt = dtype if bn_dtype is None else bn_dtype
        c = in_channels + 4
        for li, w in enumerate(spec.mlp):
            self.add_module(f"edge_dense{li}", Dense(c, w, dtype))
            if not fold_bn:
                self.add_module(f"edge_bn{li}",
                                BatchNorm(w, bdt, bn_momentum))
            c = w
        att_in = 4
        if spec.use_coverage:
            att_in += 2
        if spec.use_context_pool:
            # 'candidates' pooling passes the level's features (GridConv's
            # ctx_feat); the default pools the edge inputs [feat; geo]
            ctx_in = in_channels if (spec.context_pool_source == "candidates"
                                     and in_channels) else in_channels + 4
            self.ctx_dense = Dense(ctx_in, spec.context_channels,
                                   self.att_dtype)
            att_in += spec.context_channels
        self.att_dense0 = Dense(att_in, spec.att_hidden, self.att_dtype)
        self.att_dense1 = Dense(spec.att_hidden, 1, self.att_dtype)
        if spec.pool == "maxsum":
            self.pool_proj = Dense(2 * spec.mlp[-1], spec.mlp[-1], dtype)
        elif spec.pool != "max":
            raise ValueError(f"unknown pool: {spec.pool}")
        if spec.att_activation not in ("softmax", "sigmoid"):
            raise ValueError(
                f"unknown att_activation: {spec.att_activation}")

    def _edge_mlp(self, x, mask):
        for li in range(len(self.spec.mlp)):
            x = getattr(self, f"edge_dense{li}")(x)
            if not self.fold_bn:
                x = getattr(self, f"edge_bn{li}")(x)
            x = torch.relu(x)
            x = torch.where(mask[..., None], x, 0.0)
        return x

    def forward(self, node_feat: Optional[torch.Tensor],
                delta_p: torch.Tensor, mask: torch.Tensor,
                coverage: torch.Tensor,
                ctx_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """node_feat [B,M,K,C] or None, delta_p [B,M,K,3], mask [B,M,K],
        coverage [B,M,K] int → [B, M, mlp[-1]] center features."""
        spec = self.spec
        adt = self.att_dtype
        m = mask[..., None]
        delta_p = delta_p.to(adt)
        d = delta_p + 1e-12
        dist = torch.sqrt((d * d).sum(dim=-1, keepdim=True))
        geo = torch.where(m, torch.cat([delta_p, dist], dim=-1), 0.0)

        geo_e = geo.to(self.dtype)
        if node_feat is None:
            edge_in = geo_e
        else:
            edge_in = torch.cat(
                [torch.where(m, node_feat.to(self.dtype), 0.0), geo_e], -1)
        edge = self._edge_mlp(edge_in, mask)                   # [B,M,K,Co]

        att_parts = [geo]
        if spec.use_coverage:
            cov = coverage.to(adt)
            cov_sum = torch.where(mask, cov, 0.0).sum(dim=-1, keepdim=True)
            cov_norm = cov / torch.clamp_min(cov_sum, 1.0)
            att_parts.append(torch.where(mask, cov_norm, 0.0)[..., None])
            att_parts.append(torch.where(mask, torch.log1p(cov), 0.0)[..., None])
        if spec.use_context_pool:
            if ctx_feat is not None:
                ctx = ctx_feat.to(adt)
            else:
                denom = torch.clamp_min(mask.sum(dim=-1, keepdim=True), 1)
                ctx = (edge_in.to(adt) * m).sum(dim=-2) / denom
            ctx = torch.relu(self.ctx_dense(ctx))              # [B,M,Cctx]
            att_parts.append(ctx[:, :, None, :].expand(
                *mask.shape, spec.context_channels))
        att_in = torch.cat(att_parts, dim=-1)

        a = torch.relu(self.att_dense0(att_in))
        a = self.att_dense1(a)[..., 0]                         # [B,M,K]
        if spec.att_activation == "softmax":
            a = torch.where(mask, a, _NEG_INF)
            att = torch.softmax(a, dim=-1)
            # scale so an all-uniform attention is the identity wrt max-pool
            att = att * torch.clamp_min(mask.sum(dim=-1, keepdim=True), 1)
        else:
            att = torch.sigmoid(a) * 2.0
        att = torch.where(mask, att, 0.0).to(self.dtype)

        weighted = edge * att[..., None]                       # [B,M,K,Co]
        pooled = torch.where(m, weighted, _NEG_INF).amax(dim=-2)
        pooled = torch.where(mask.any(dim=-1)[..., None], pooled, 0.0)
        if spec.pool == "maxsum":
            denom = torch.clamp_min(mask.sum(dim=-1, keepdim=True), 1)
            mean = (weighted * m).sum(dim=-2) / denom
            pooled = self.pool_proj(torch.cat([pooled, mean], dim=-1))
        return pooled
