"""The network's levels and stages as the configuration implies them."""

from __future__ import annotations


def point_counts(cfg: dict) -> list:
    """Points of each level: the input cloud, then each encoder layer's
    centers."""
    return [int(cfg["data"]["num_points"])] + [
        int(layer["n_centers"]) for layer in cfg["model"]["layers"]]


def widths(cfg: dict) -> list:
    """Feature width of each level (the input's: its channels, with xyz
    when the model feeds it; 0 where a level carries none)."""
    m = cfg["model"]
    first = int(m["in_channels"]) + (3 if m.get("use_xyz_feature", True)
                                     else 0)
    return [first] + [int(layer["mlp"][-1]) for layer in m["layers"]]


def decoder_calls(cfg: dict) -> list:
    """[(queries, supports, k, method)] of each decoder stage's k-NN, per
    cloud: stage i interpolates from level L − i to level L − 1 − i. A
    classifier (task `"cls"`) and a configuration without `up_layers` have
    none."""
    m = cfg["model"]
    if m.get("task", "cls") == "cls":
        return []
    n = point_counts(cfg)
    L = len(m["layers"])
    return [(n[L - 1 - i], n[L - i], int(up.get("k_interp", 3)),
             up.get("method", "auto"))
            for i, up in enumerate(m.get("up_layers", ()))]
