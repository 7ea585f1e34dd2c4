"""Surface-like indoor room scans (`harness/scenes.py`, a frozen copy of the
port's `data/synthetic.synthetic_scene_surface`): xyz and, when asked, the
part labels; no per-point features.

params: `num_points`, optionally `room` ([W, H, D] in metres)."""

from __future__ import annotations

from harness import scenes


def generate(seed: int, return_labels: bool, params: dict):
    """(xyz [N, 3] float32, None, labels [N] int32 or None)."""
    params = dict(params)
    if "room" in params:
        params["room"] = tuple(params["room"])
    out = scenes.synthetic_scene_surface(seed=seed,
                                         return_labels=return_labels,
                                         **params)
    xyz, labels = out if return_labels else (out, None)
    return xyz, None, labels
