"""Structured metric logging: one JSON object per line on a stream (stdout
by default) and optionally in a file, plus optional TensorBoard scalars.
The records are the JAX package's: `kind`, `t` (seconds since the logger
was made) and the metrics, numpy arrays and torch tensors turned into
Python numbers or lists."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

import torch


def _to_py(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.numel() == 1 else v.tolist()
    if hasattr(v, "item") and getattr(v, "size", 1) == 1:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class MetricLogger:
    def __init__(self, path: Optional[str] = None,
                 stream: Optional[IO] = None,
                 tensorboard_dir: Optional[str] = None):
        """path: also append the lines to this file; stream: where to print
        them (default: sys.stdout at construction); tensorboard_dir: also
        write numeric metrics as TensorBoard scalars."""
        self.stream = sys.stdout if stream is None else stream
        self.tb = None
        self._tb_step = 0
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "tensorboard_dir (--tensorboard) needs the tensorboard "
                    "package, which is not installed") from e
            self.tb = SummaryWriter(tensorboard_dir)
        self.file = open(path, "a") if path else None
        self.t0 = time.time()

    def log(self, kind: str, **metrics):
        rec = {"kind": kind, "t": round(time.time() - self.t0, 3)}
        rec.update({k: _to_py(v) for k, v in metrics.items()})
        line = json.dumps(rec)
        print(line, file=self.stream, flush=True)
        if self.file:
            self.file.write(line + "\n")
            self.file.flush()
        if self.tb is not None:
            step = rec.get("step")
            step = int(step) if isinstance(step, (int, float)) else self._tb_step
            self._tb_step = max(self._tb_step, step) + 1
            for k, v in rec.items():
                if k not in ("kind", "step") and isinstance(
                        v, (int, float)) and not isinstance(v, bool):
                    self.tb.add_scalar(f"{kind}/{k}", v, global_step=step)
            self.tb.flush()

    def close(self):
        if self.file:
            self.file.close()
        if self.tb is not None:
            self.tb.close()
