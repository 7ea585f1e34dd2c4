"""Dense, BatchNorm and dropout with flax's numerics, over the last axis
(a frozen copy of the port's `models/layers.py`, without its data-parallel
statistics; `Dense.fp8` added for the benchmark's low-precision control).

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

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import jaxrng

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
        # the control's precision: the operands and the output rounded to
        # float8 e4m3 (one scale per tensor, its largest magnitude at
        # e4m3's 448), the product summed in float32; in the backward the
        # gradients that reach them are rounded alike
        self.fp8 = False

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
        if self.fp8:
            y = F.linear(round_fp8(x.float()), round_fp8(self.weight.float()),
                         self.bias.float())
            return round_fp8(y).to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


FP8_MAX = 448.0     # the largest finite float8 e4m3 value


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp_min(t.abs().amax(), 1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale, in t's dtype;
    its gradient is rounded alike in the backward."""
    return _RoundFP8.apply(t)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            # flax's fast variance: E[x²] − E[x]², clipped at 0, in f32;
            # every row counts, masked (padded) rows included.
            axes = tuple(range(x.dim() - 1))
            s, ss = xf.sum(axes), (xf * xf).sum(axes)
            n = float(math.prod(x.shape[:-1]))
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
