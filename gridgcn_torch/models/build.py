"""Model factory: ModelConfig → torch module, and a seeded init."""

from __future__ import annotations

import torch
from torch import nn

from gridgcn_torch.configs.base import ModelConfig
from gridgcn_torch.models.layers import Dense
from gridgcn_torch.models.segmentation import GridGCNSegmentation


def build_model(cfg: ModelConfig) -> nn.Module:
    """The module for a config. Dense weights are uninitialized: load a
    state_dict or call `init_model`."""
    if cfg.task == "seg":
        return GridGCNSegmentation(cfg)
    raise NotImplementedError(f"task {cfg.task!r} is not ported yet")


def init_model(cfg: ModelConfig, generator: torch.Generator):
    """(model, state_dict) with flax's default init drawn from
    `generator`: LeCun-normal Dense weights, zero biases, identity
    BatchNorms."""
    model = build_model(cfg)
    for m in model.modules():
        if isinstance(m, Dense):
            m.reset_parameters(generator)
    return model, model.state_dict()
