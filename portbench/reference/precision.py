"""TF32 off for the reference's products, the caller's flags restored."""

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
