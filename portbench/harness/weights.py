"""The network's weights, made on the device from the seed in a few large
draws: every Dense weight normal at √(2 / fan_in), BatchNorm scales in
[0.5, 1.5) and running variances in [0.5, 2), every bias and running mean
0.1·normal (non-trivial BatchNorms, so the fold is exercised), float32 and
unfolded. Names and shapes come from the module tree of the reference
network that the configuration names (`net`, from
`spec.reference_network`), which names its tensors as the port does."""

from __future__ import annotations

import torch

from reference.layers import BatchNorm, Dense
from reference.serve import float32_model_config


def layout(model_cfg, net) -> list:
    """[(name, shape, kind)] of the state_dict of `net(model_cfg)`, kind
    one of "dense", "scale", "var", "shift"."""
    with torch.device("meta"):
        model = net(float32_model_config(model_cfg))
    out = []
    for name, t in model.state_dict().items():
        mod, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod)
        if isinstance(owner, Dense) and leaf == "weight":
            kind = "dense"
        elif isinstance(owner, BatchNorm) and leaf == "weight":
            kind = "scale"
        elif isinstance(owner, BatchNorm) and leaf == "running_var":
            kind = "var"
        else:
            kind = "shift"
        out.append((name, tuple(t.shape), kind))
    return out


def make_state_dict(model_cfg, seed: int, device, net) -> dict:
    """{name: float32 tensor on device} for `net(model_cfg)`, drawn from
    `seed` by one normal and one uniform draw of a generator on the
    device."""
    lay = layout(model_cfg, net)
    numel = [int(torch.Size(s).numel()) for _, s, _ in lay]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(numel)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(lay, numel):
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "dense":
            out[name] = z * (2.0 / shape[1]) ** 0.5
        elif kind == "scale":
            out[name] = 0.5 + u
        elif kind == "var":
            out[name] = 0.5 + 1.5 * u
        else:
            out[name] = 0.1 * z
    return out
