"""The float32 precision of the port's own work, scoped to its calls.

The JAX package computes float32 products in float32 (its default
precision on the CPU, `precision=HIGHEST` where it matters). On the card,
PyTorch runs cuDNN's float32 convolutions in TF32 unless told otherwise,
and a caller may have turned TF32 on for matrix products too. The port
turns both off around its own calls and gives the caller's settings back
on exit, so a process that serves or trains with the port keeps its own
choice elsewhere. The flags are read when an op is dispatched, so the
scope works per call in eager mode; an exported program does not carry
them, which is why the exported predictor enters the scope too.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matrix products and cuDNN inside the block; the
    caller's two flags restored on exit, also when the block raises."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
