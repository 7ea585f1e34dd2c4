"""Dense, BatchNorm and dropout with flax's numerics, over the last axis.

`Dense` computes in a chosen dtype like flax's `nn.Dense(dtype=...)`: the
input, weight and bias are cast to it. Its weight is stored [out, in], as
torch's `nn.Linear` stores it. `BatchNorm` is flax's `nn.BatchNorm`:
(x − mean)·(rsqrt(var + eps)·scale) + bias in float32, cast to its dtype,
with the running statistics in eval mode and, in training mode, the batch's
own (flax's float32 fast variance, over every axis but the last). Parameter
names follow torch (`weight`, `bias`, `running_mean`, `running_var`);
`utils/convert.py` maps flax's onto them. `dropout` is flax's
`nn.Dropout`, its mask drawn from a jaxrng key.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gridgcn_torch.utils import jaxrng

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


class _GroupSum(torch.autograd.Function):
    """The sum of a tensor over a process group's ranks, differentiable:
    every rank's loss depends on every rank's input through the sum, so
    the backward sums the incoming gradients over the group too."""

    @staticmethod
    def forward(ctx, t, group):
        from gridgcn_torch.parallel.mesh import all_reduce_

        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        from gridgcn_torch.parallel.mesh import all_reduce_

        return all_reduce_(grad.clone(), ctx.group), None


class BatchNorm(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.9):
        """momentum: flax's convention, the share of the running
        statistics kept at each update (torch's momentum is 1 − this)."""
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dtype = dtype
        self.momentum = momentum
        self.batch_stats = None
        # a data-parallel step's process group: the batch statistics are
        # then those of the global batch (`parallel.dp`)
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            # flax's fast variance: E[x²] − E[x]², clipped at 0, in f32;
            # every row counts, masked (padded) rows included. Under a
            # process group the sums are all-reduced with a differentiable
            # all-reduce first, so the statistics are the global batch's,
            # as in the JAX package's GSPMD step (every rank holds as many
            # rows: the row count is this one's times the group's size).
            axes = tuple(range(x.dim() - 1))
            s, ss = xf.sum(axes), (xf * xf).sum(axes)
            n = float(math.prod(x.shape[:-1]))
            if self.group is not None:
                import torch.distributed as dist

                c = len(s)
                tot = _GroupSum.apply(torch.cat([s, ss]), self.group)
                s, ss = tot[:c], tot[c:]
                n *= dist.get_world_size(self.group)
            mean = s / n
            var = torch.clamp_min(ss / n - mean * mean, 0.0)
            self.batch_stats = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.dtype)

    @torch.no_grad()
    def folded_stats(self):
        """The running statistics with those of the last training forward
        folded in as flax folds them, m·running + (1 − m)·batch with the
        biased variance, as new tensors ((mean, var); the running ones
        when no training forward was recorded)."""
        if self.batch_stats is None:
            return self.running_mean.clone(), self.running_var.clone()
        m = float(np.float32(self.momentum))
        keep = float(np.float32(1.0 - self.momentum))
        return tuple(ra * m + keep * batch for ra, batch in
                     zip((self.running_mean, self.running_var),
                         self.batch_stats))

    @torch.no_grad()
    def update_running_stats(self) -> None:
        """Fold the statistics of the last training forward into the
        running ones (`folded_stats`) and forget them. A no-op without a
        training forward since the last update."""
        if self.batch_stats is None:
            return
        for ra, new in zip((self.running_mean, self.running_var),
                           self.folded_stats()):
            ra.copy_(new)
        self.batch_stats = None


def update_batch_stats(model: nn.Module) -> None:
    """`BatchNorm.update_running_stats` on every BatchNorm of `model`: what
    flax's `mutable=["batch_stats"]` returns, applied once per step (a
    rematerialized stage that runs its BatchNorms again records the same
    statistics again)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.update_running_stats()


@contextlib.contextmanager
def batch_stats_over(model: nn.Module, group):
    """Inside the block, every BatchNorm of `model` in training mode takes
    the statistics of the batch summed over `group` (a data-parallel
    step's process group; None: this process's batch alone)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None


def dropout(x: torch.Tensor, rate: float, key: np.ndarray,
            row0: int = 0) -> torch.Tensor:
    """flax's `nn.Dropout(rate)` in training mode under `key`: keep
    bernoulli(key, 1 − rate, x.shape) and return x / (1 − rate) there, 0
    elsewhere, in x's dtype. x's rows are rows [row0, row0 + B) of the
    batch whose key this is."""
    keep_prob = 1.0 - rate
    keep = jaxrng.bernoulli(key, keep_prob, x.shape, x.device, row0=row0)
    scale = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, 0.0)


def add_mlp(owner: nn.Module, stem: str, in_features: int,
            widths: Sequence[int], dtype: torch.dtype,
            bn_dtype: torch.dtype, fold_bn: bool,
            bn_momentum: float = 0.9) -> int:
    """Register `<stem>_dense{i}` (and, unless folded, `<stem>_bn{i}`) on
    `owner` for each width, flax's names; returns the output width."""
    c = in_features
    for i, w in enumerate(widths):
        owner.add_module(f"{stem}_dense{i}", Dense(c, w, dtype))
        if not fold_bn:
            owner.add_module(f"{stem}_bn{i}",
                             BatchNorm(w, bn_dtype, bn_momentum))
        c = w
    return c


def run_mlp(owner: nn.Module, stem: str, n: int, x: torch.Tensor,
            fold_bn: bool, dropout_rate: float = 0.0,
            dropout_keys: Sequence[np.ndarray] | None = None,
            row0: int = 0) -> torch.Tensor:
    """Dense → BatchNorm (unless folded) → ReLU → dropout, n times, through
    the modules that `add_mlp` registered. Dropout runs in training mode
    only, layer i under dropout_keys[i], x's rows being rows [row0, row0 +
    B) of the batch."""
    for i in range(n):
        x = getattr(owner, f"{stem}_dense{i}")(x)
        if not fold_bn:
            x = getattr(owner, f"{stem}_bn{i}")(x)
        x = torch.relu(x)
        if dropout_rate > 0 and owner.training:
            if dropout_keys is None:
                raise ValueError("training with dropout needs dropout keys")
            x = dropout(x, dropout_rate, dropout_keys[i], row0)
    return x
