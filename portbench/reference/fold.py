"""Inference-time BatchNorm folding.

At inference a BatchNorm after a Dense is the per-channel affine
    y = (x - mean) * scale / sqrt(var + eps) + bias,
which the Dense absorbs:
    W' = W * g,   b' = (b - mean) * g + bias,   g = scale / sqrt(var+eps)
The naming convention `<stem>_dense<i>` / `<stem>_bn<i>` pairs them, and the
model skips BN via `ModelConfig.fold_bn`. Works on the port's state_dict
(weights [out, in], so g scales rows), with the JAX package's arithmetic.
Inference only — never fold a model that will keep training.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .layers import BN_EPS, to_dtype


def _module_and_leaf(key: str) -> Tuple[str, str]:
    mod, _, leaf = key.rpartition(".")
    return mod, leaf


def fold_batchnorm(state_dict: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Fold every `<stem>_bn<i>` into its `<stem>_dense<i>` sibling.

    Returns (state_dict', n_folded): BN entries removed, Dense weights and
    biases rewritten in float32. A BN without a Dense sibling raises."""
    bn_mods = sorted({_module_and_leaf(k)[0] for k in state_dict
                      if "_bn" in _module_and_leaf(k)[0].rpartition(".")[2]})
    out = {k: v for k, v in state_dict.items()
           if _module_and_leaf(k)[0] not in bn_mods}
    for bn in bn_mods:
        parent, _, name = bn.rpartition(".")
        dense = (parent + "." if parent else "") + name.replace("_bn",
                                                                "_dense")
        if dense + ".weight" not in state_dict:
            raise ValueError(f"BatchNorm {bn} has no '{dense}' sibling to "
                             "fold into")
        g = state_dict[bn + ".weight"].float() / torch.sqrt(
            state_dict[bn + ".running_var"].float() + BN_EPS)
        out[dense + ".weight"] = state_dict[dense + ".weight"].float() \
            * g[:, None]
        out[dense + ".bias"] = (
            (state_dict[dense + ".bias"].float()
             - state_dict[bn + ".running_mean"]) * g
            + state_dict[bn + ".bias"])
    return out, len(bn_mods)


def fold_inference(cfg, state_dict):
    """(Config or ModelConfig, state_dict) → (fold_bn=True config, folded
    state_dict). For bf16 compute the folded Dense parameters are pre-cast
    to bf16; 'logits' stays float32 (its Dense computes in f32)."""
    model_cfg = cfg.model if hasattr(cfg, "model") else cfg
    folded, _ = fold_batchnorm(state_dict)
    dtype_str = model_cfg.eval_dtype or model_cfg.dtype
    if to_dtype(dtype_str) == torch.bfloat16:
        folded = {k: (v if k.startswith("logits.") else v.to(torch.bfloat16))
                  for k, v in folded.items()}
    new_model = dataclasses.replace(model_cfg, fold_bn=True, dtype=dtype_str)
    if hasattr(cfg, "model"):
        return dataclasses.replace(cfg, model=new_model), folded
    return new_model, folded
