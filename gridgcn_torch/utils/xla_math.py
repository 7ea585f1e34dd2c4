"""XLA:CPU's float32 roundings, repeated in torch ops.

The JAX package's CAGQ indices and augmentation draws depend on float32
values that XLA:CPU computes with its own roundings: it fuses a multiply
feeding an add into one FMA where LLVM contracts them, it computes log
with the Cephes polynomial (`polynomial_approximations`), log1p with a
Cephes rational for small |x|, and erf⁻¹ with Giles' polynomials. The port
repeats those roundings op by op, each in its own torch kernel, so the
values are the same bits on the CPU and on CUDA, and equal the JAX
package's. The draws' kernel (`csrc/rng.cu`, through `kernels.rng`)
repeats `fma32` and `log` once more inside its `uniform` and `gumbel`
epilogues, with explicitly rounded CUDA intrinsics and no contraction;
`erf_inv` (for `jaxrng.normal`) stays in torch ops. `torch.log1p`, `torch.special.erfinv` and even the CPU's
float32 `torch.sqrt` (not correctly rounded there) would not be.
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


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (XLA's `vsqrtps`): the
    float64 root rounded once more. The float64 root is within an ulp of
    exact, and the root of a float32 never lies that close to a float32
    rounding midpoint, so the second rounding cannot go wrong."""
    return torch.sqrt(x.double()).float()


# XLA's elemental log1p (`EmitLog1p`): the Cephes rational for
# |x| < √2 − 1, log(1 + x) above; each polynomial's coefficients from the
# highest degree down
_LOG1P_SMALL = _f32(0.41421356237309504880)
_LOG1P_NUM = [_f32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)]
_LOG1P_DEN = [_f32(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)]


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """((c0·x + c1)·x + c2)…, every step one fused multiply-add."""
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma32(p, x, c)
    return p


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log(1 + x) for x > −1 with XLA:CPU's roundings. Bit for bit
    `jnp.log1p` on the CPU for every input tested (1 M values in (−1, 0])."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + fma32(x2, -0.5, small)
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + 1.0))


# Giles' single-precision erf⁻¹ (XLA's `ErfInv32`), w = −log1p(−x²): one
# polynomial in w − 2.5 below w = 5, one in √w − 3 above
_ERFINV_LT5 = [_f32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941)]
_ERFINV_GE5 = [_f32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682)]


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf⁻¹ of x in [−1, 1] with XLA:CPU's roundings (±inf at ±1).
    Bit for bit `jax.lax.erf_inv` on the CPU for every input tested."""
    w = -log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    p = None
    for lo, hi in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, lo, hi)
        p = c if p is None else fma32(p, w, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)
