"""Checkpoint and resume with `torch.save`, one file per step.

A directory holds `config.json` (written on first use) and `ckpt-<step>.pt`
files, each the full training state: the model's state_dict (parameters
and BatchNorm running statistics), the optimizer's moments and step count,
and the jaxrng key. The newest `keep` files are kept. A directory is bound
to one config: a manager made with another config is refused, so that a
run never resumes or serves old weights under new hyperparameters. Each
file is written under a temporary name and renamed into place, so a crash
never leaves a half-written newest checkpoint.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from gridgcn_torch.configs.base import Config, from_json, to_json

_NAME = re.compile(r"^ckpt-(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, cfg: Config, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.cfg = cfg
        self.keep = keep
        cfg_path = os.path.join(self.directory, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                existing = f.read()
            # compared through the current schema (parsed, then written
            # again), so a directory written before a config field was
            # added (new fields carry defaults) keeps loading
            if to_json(from_json(existing)) != to_json(cfg):
                raise ValueError(
                    f"{cfg_path} was written by a different config; "
                    f"pick a fresh ckpt_dir for a new configuration "
                    f"(or delete the directory to restart)")
        else:
            with open(cfg_path, "w") as f:
                f.write(to_json(cfg))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.pt")

    def steps(self) -> list[int]:
        """The steps that have a checkpoint, in increasing order."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state, rng: Optional[np.ndarray] = None):
        """Write the train state (`steps.TrainState`) and the key at
        `step`, then drop all but the newest `keep` checkpoints."""
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.tx.state_dict()}
        if rng is not None:
            # int64: torch.load(weights_only=True) takes tensors, not numpy
            payload["rng"] = torch.from_numpy(
                np.asarray(rng, np.uint32).astype(np.int64))
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if self.keep > 0:
            for old in self.steps()[:-self.keep]:
                os.remove(self._path(old))

    def wait(self):
        """Saves are synchronous: nothing to wait for."""

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def read(self, step: Optional[int] = None, device="cpu"):
        """The checkpoint at `step` (default the newest) as saved, its
        tensors on `device`: {"model": state_dict, "optimizer": ...,
        "rng"?: ...}; None when the directory holds no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location=device,
                          weights_only=True)

    def restore(self, state, rng: Optional[np.ndarray] = None,
                step: Optional[int] = None):
        """Load the checkpoint at `step` (default the newest) into `state`,
        in place, its tensors on the state's device → {"state": state,
        "rng"?: uint32[2]}; None when the directory holds no checkpoint.
        `rng` is accepted for symmetry with `save` and not read."""
        payload = self.read(step, state.device)
        if payload is None:
            return None
        state.model.load_state_dict(payload["model"])
        state.tx.load_state_dict(payload["optimizer"])
        out = {"state": state}
        if payload.get("rng") is not None:
            out["rng"] = payload["rng"].cpu().numpy().astype(np.uint32)
        return out

    @staticmethod
    def load_config(directory: str) -> Config:
        with open(os.path.join(os.path.abspath(directory), "config.json")) as f:
            return from_json(f.read())
