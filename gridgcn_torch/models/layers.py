"""Dense and BatchNorm with flax's numerics, over the last axis.

`Dense` computes in a chosen dtype like flax's `nn.Dense(dtype=...)`: the
input, weight and bias are cast to it. Its weight is stored [out, in], as
torch's `nn.Linear` stores it. `BatchNorm` is flax's inference-mode
`nn.BatchNorm`: (x − mean)·(rsqrt(var + eps)·scale) + bias in float32, cast
to its dtype. Parameter names follow torch (`weight`, `bias`,
`running_mean`, `running_var`); `utils/convert.py` maps flax's onto them.
"""

from __future__ import annotations

import math

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5      # flax.linen.BatchNorm default epsilon

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def to_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; expected one of "
                         f"{sorted(DTYPES)}")
    return DTYPES[name]


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator):
        """flax's default init: LeCun-normal weight (truncated at ±2σ),
        zero bias."""
        fan_in = self.weight.shape[1]
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "batch-statistics BatchNorm is not ported yet; call .eval()")
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        return ((x.float() - self.running_mean) * mul + self.bias).to(
            self.dtype)


def add_mlp(owner: nn.Module, stem: str, in_features: int,
            widths: Sequence[int], dtype: torch.dtype,
            bn_dtype: torch.dtype, fold_bn: bool) -> int:
    """Register `<stem>_dense{i}` (and, unless folded, `<stem>_bn{i}`) on
    `owner` for each width, flax's names; returns the output width."""
    c = in_features
    for i, w in enumerate(widths):
        owner.add_module(f"{stem}_dense{i}", Dense(c, w, dtype))
        if not fold_bn:
            owner.add_module(f"{stem}_bn{i}", BatchNorm(w, bn_dtype))
        c = w
    return c


def run_mlp(owner: nn.Module, stem: str, n: int, x: torch.Tensor,
            fold_bn: bool, dropout: float = 0.0) -> torch.Tensor:
    """Dense → BatchNorm (unless folded) → ReLU → dropout, n times, through
    the modules that `add_mlp` registered."""
    for i in range(n):
        x = getattr(owner, f"{stem}_dense{i}")(x)
        if not fold_bn:
            x = getattr(owner, f"{stem}_bn{i}")(x)
        x = torch.relu(x)
        if dropout > 0:
            x = F.dropout(x, dropout, training=owner.training)
    return x
