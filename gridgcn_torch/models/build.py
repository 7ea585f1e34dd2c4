"""Model factory: ModelConfig → torch module, a seeded init, and the JAX
package's dummy inputs."""

from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch import nn

from gridgcn_torch.configs.base import Config, ModelConfig
from gridgcn_torch.models.classifier import GridGCNClassifier
from gridgcn_torch.models.layers import BatchNorm, Dense
from gridgcn_torch.models.segmentation import GridGCNSegmentation
from gridgcn_torch.utils import jaxrng


def build_model(cfg: ModelConfig) -> nn.Module:
    """The module for a config. Dense weights are uninitialized: load a
    state_dict or call `init_model`."""
    if cfg.task == "cls":
        return GridGCNClassifier(cfg)
    if cfg.task == "seg":
        return GridGCNSegmentation(cfg)
    raise ValueError(f"unknown task: {cfg.task}")


def example_inputs(cfg: Config, batch_size: int | None = None,
                   device="cuda"):
    """The JAX package's deterministic dummy inputs for a config, bit for
    bit: xyz uniform in [-1, 1) and feat in [0, 1) from PRNGKey(0), every
    point valid → (xyz [B, N, 3], feat [B, N, C] or None, mask [B, N])."""
    B = batch_size or cfg.data.batch_size
    N = cfg.data.num_points
    key = jaxrng.PRNGKey(0)
    xyz = jaxrng.uniform(key, (B, N, 3), device, minval=-1.0, maxval=1.0)
    feat = None
    if cfg.model.in_channels > 0:
        feat = jaxrng.uniform(key, (B, N, cfg.model.in_channels), device)
    mask = torch.ones((B, N), dtype=torch.bool, device=device)
    return xyz, feat, mask


def init_model(cfg: ModelConfig, generator: torch.Generator):
    """(model, state_dict) with flax's default init drawn from
    `generator`: LeCun-normal Dense weights, zero biases, identity
    BatchNorms."""
    model = build_model(cfg)
    for m in model.modules():
        if isinstance(m, Dense):
            m.reset_parameters(generator)
    return model, model.state_dict()


def numpy_state_dict(cfg: ModelConfig, seed: int) -> dict:
    """Weights for cfg drawn with numpy's `default_rng(seed)`, the same on
    any machine and any torch version (torch's generator is not): each
    tensor of the model's state_dict in its order, Dense weights normal at
    √(2 / fan_in), BatchNorm scales in [0.5, 1.5) and variances in
    [0.5, 2), every bias and mean 0.1·normal. Non-trivial BatchNorms, so
    folding is exercised. float32 tensors."""
    model = build_model(cfg)
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        mod, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod)
        if isinstance(owner, Dense) and leaf == "weight":
            v = rng.standard_normal(t.shape) * np.sqrt(2.0 / t.shape[1])
        elif isinstance(owner, BatchNorm) and leaf == "weight":
            v = rng.uniform(0.5, 1.5, t.shape)
        elif isinstance(owner, BatchNorm) and leaf == "running_var":
            v = rng.uniform(0.5, 2.0, t.shape)
        else:
            v = 0.1 * rng.standard_normal(t.shape)
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


def state_dict_digests(state_dict: dict) -> dict:
    """SHA-256 of each tensor's bytes (float32, C order), by name."""
    return {k: hashlib.sha256(
        np.ascontiguousarray(v.detach().cpu().numpy()).tobytes()).hexdigest()
        for k, v in state_dict.items()}
