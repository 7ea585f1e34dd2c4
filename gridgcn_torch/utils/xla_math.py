"""XLA:CPU's float32 roundings, repeated in torch ops.

The JAX package's CAGQ indices depend on float32 values that XLA:CPU
computes with its own roundings: it fuses a multiply feeding an add into
one FMA where LLVM contracts them, and it computes log with the Cephes
polynomial (`polynomial_approximations`). The port repeats those roundings
op by op, each in its own torch kernel, so the values are the same bits on
the CPU and on CUDA, and equal the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c rounded once to float32 (b, c tensors or floats): the f64
    product is exact, and the f64 sum rounds to the fused result except
    when it lands exactly on a float32 midpoint."""
    return (a.double() * b + c).float()


def _f32(v: float) -> float:
    """v rounded to float32, as a Python float."""
    return float(np.float32(v))


TINY = float(np.finfo(np.float32).tiny)
_LOG_P = [_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 log of positive finite x with XLA:CPU's roundings: the
    Cephes range reduction to [√½, √2) and polynomial, multiply-adds fused
    where XLA fuses them. Bit for bit `jnp.log` on the CPU for every
    positive finite input tested (1.1 M values)."""
    x = torch.clamp_min(x, TINY)
    xb = x.view(torch.int32)
    e = ((xb >> 23) - 0x7F).float() + 1.0
    m = ((xb & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _f32(0.707106781186547524)
    e = e - low.float()
    x = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = fma32(fma32(x, p[0], p[1]), x, p[2])
    y1 = fma32(fma32(x, p[3], p[4]), x, p[5])
    y2 = fma32(fma32(x, p[6], p[7]), x, p[8])
    y = fma32(fma32(y, x3, y1), x3, y2)
    y = fma32(y, x3, _f32(-2.12194440e-4) * e)
    x = x - 0.5 * x2
    x = x + y
    return x + _f32(0.693359375) * e
