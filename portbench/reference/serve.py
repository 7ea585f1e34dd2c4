"""The reference's served forward: the unfolded weights folded here (the
port's inference protocol, BatchNorm into each Dense), every layer in
float32; or in the control's precision (`precision="fp8"`): the
configuration's own dtypes, with every Dense but the logits taking its
operands rounded to float8 e4m3, one step below its bfloat16. The network
is the class that the caller names (`net`): per-point logits [B, N, C] or
per-cloud logits [B, C]."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Config
from .fold import fold_batchnorm
from .layers import Dense
from .precision import full_fp32

PRECISIONS = ("float32", "fp8")


def float32_model_config(model_cfg, **changes):
    """The model config with `changes` and every dtype float32."""
    return dataclasses.replace(model_cfg, **{
        **changes, "dtype": "float32", "att_dtype": "", "interp_dtype": "",
        "bn_dtype": "", "eval_dtype": ""})


def model_config(model_cfg, precision: str, **changes):
    """The model config of a precision: every dtype float32, or (fp8) the
    configuration's own."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one "
                         f"of {PRECISIONS}")
    if precision == "float32":
        return float32_model_config(model_cfg, **changes)
    return dataclasses.replace(model_cfg, **changes)


def set_precision(model: torch.nn.Module, precision: str) -> None:
    """Plain, or the control's fp8 operands in every Dense but the logits
    (which the port computes in float32)."""
    for name, m in model.named_modules():
        if isinstance(m, Dense):
            m.fp8 = precision == "fp8" and name != "logits"


class ServeReference:
    """The served network `net` on `device` with `state_dict`'s weights
    folded anew; `__call__(xyz [B, N, 3], key, feat [B, N, C_in] or
    None)` → logits float32 on the device ([B, N, C] or [B, C]), every
    point valid."""

    def __init__(self, cfg: Config, state_dict, device,
                 precision: str = "float32", *, net):
        folded, _ = fold_batchnorm({k: v.to(device) for k, v in
                                    state_dict.items()})
        mc = cfg.model
        model = net(model_config(
            mc, precision, fold_bn=True, dtype=mc.eval_dtype or mc.dtype))
        model.load_state_dict(folded)
        set_precision(model, precision)
        self.model = model.to(device).eval()
        self.device = torch.device(device)

    @torch.no_grad()
    def __call__(self, xyz, key: np.ndarray, feat=None) -> torch.Tensor:
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=self.device)
        if feat is not None:
            feat = torch.as_tensor(feat, dtype=torch.float32,
                                   device=self.device)
        mask = torch.ones(xyz.shape[:2], dtype=torch.bool,
                          device=self.device)
        with full_fp32():
            return self.model(xyz, feat, mask, key).float()
