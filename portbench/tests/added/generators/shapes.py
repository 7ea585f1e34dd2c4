"""Object clouds: points on the surface of one of three primitives (a
sphere, a box, a cylinder), centred in [-1, 1]³ at a random scale, with a
little noise, each cloud's shape drawn from the seed; with `channels` > 0
also colour-like per-point features in [0, 1) (a colour of the cloud's
shape plus noise, then zeros beyond the third channel). numpy only.

params: `num_points`, optionally `channels` (default 0)."""

from __future__ import annotations

import numpy as np

SHAPES = ("sphere", "box", "cylinder")


def _surface(rng, shape: str, n: int) -> np.ndarray:
    if shape == "sphere":
        p = rng.standard_normal((n, 3))
        return p / np.linalg.norm(p, axis=1, keepdims=True)
    if shape == "box":
        p = rng.uniform(-1.0, 1.0, (n, 3))
        face = rng.integers(0, 3, n)
        p[np.arange(n), face] = np.sign(p[np.arange(n), face])
        return p
    t = rng.uniform(0.0, 2 * np.pi, n)
    return np.stack([np.cos(t), rng.uniform(-1.0, 1.0, n), np.sin(t)], 1)


def generate(seed: int, return_labels: bool, params: dict):
    """(xyz [N, 3] float32, feat [N, channels] float32 or None, per-point
    labels [N] int32 (the shape's index) or None)."""
    rng = np.random.default_rng(seed)
    n = int(params["num_points"])
    c = int(params.get("channels", 0))
    s = int(rng.integers(0, len(SHAPES)))
    xyz = _surface(rng, SHAPES[s], n) * rng.uniform(0.5, 1.0)
    xyz = (xyz + 0.01 * rng.standard_normal((n, 3))).astype(np.float32)
    feat = None
    if c:
        colour = np.eye(3)[s] * 0.6 + 0.2
        feat = np.zeros((n, c), np.float32)
        k = min(c, 3)
        feat[:, :k] = np.clip(colour[:k] + 0.1 * rng.standard_normal(
            (n, k)), 0.0, 0.999)
    labels = np.full(n, s, np.int32) if return_labels else None
    return xyz, feat, labels
