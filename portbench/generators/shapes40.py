"""ModelNet40-like object clouds, one a seed: a frozen numpy-only copy of the
geometry of the port's `data/synthetic.synthetic_shapes40`, the 40-class
stand-in for ModelNet40 (which is not in the repo). A class is one of 5 base
surfaces (sphere, cube, capped cylinder, cone, torus) × 4 aspect ratios of
the up axis × a small cube on top or none; each cloud is rotated about the
up axis, scaled by a jitter, noised, centred and scaled into [-1, 1]³, and
its points permuted: ModelNet40's preprocessing, which sets the voxel
occupancy that CAGQ's work depends on. Each cloud comes from its own seed,
and its class is the first draw of that seed's stream.

params: `num_points`. No per-point features; the label, when asked, is the
cloud's class (int32)."""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 40
ASPECTS = (0.4, 0.7, 1.0, 1.6)


def _base_surface(rng, kind: int, n: int) -> np.ndarray:
    if kind == 0:        # sphere
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)
    if kind == 1:        # cube
        p = rng.uniform(-1, 1, size=(n, 3))
        ax = rng.integers(0, 3, n)
        p[np.arange(n), ax] = rng.choice([-1.0, 1.0], n)
        return p
    if kind == 2:        # cylinder (capped)
        n_side = int(n * 0.7)
        theta = rng.uniform(0, 2 * np.pi, n)
        r = np.ones(n)
        y = rng.uniform(-1, 1, n)
        caps = np.arange(n) >= n_side
        r[caps] = np.sqrt(rng.uniform(0, 1, caps.sum()))
        y[caps] = rng.choice([-1.0, 1.0], caps.sum())
        return np.stack([r * np.cos(theta), y, r * np.sin(theta)], 1)
    if kind == 3:        # cone
        u = np.sqrt(rng.uniform(0, 1, n))   # area-uniform along the slant
        theta = rng.uniform(0, 2 * np.pi, n)
        base = np.arange(n) >= int(n * 0.75)
        r, y = u.copy(), 1.0 - 2.0 * u
        r[base] = np.sqrt(rng.uniform(0, 1, base.sum()))
        y[base] = -1.0
        return np.stack([r * np.cos(theta), y, r * np.sin(theta)], 1)
    # torus, tube radius 0.35
    theta = rng.uniform(0, 2 * np.pi, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    rr = 1.0 + 0.35 * np.cos(phi)
    return np.stack([rr * np.cos(theta), 0.35 * np.sin(phi),
                     rr * np.sin(theta)], 1)


def cloud(rng, label: int, num_points: int) -> np.ndarray:
    """One cloud of class `label` [num_points, 3] float32, drawn from `rng`
    as `synthetic_shapes40` draws each of its clouds."""
    kind, aspect, part = label % 5, ASPECTS[(label // 5) % 4], label >= 20
    n_part = int(num_points * 0.15) if part else 0
    p = _base_surface(rng, kind, num_points - n_part)
    p[:, 1] *= aspect
    if part:             # small cube riding the +y extreme
        q = rng.uniform(-0.2, 0.2, size=(n_part, 3))
        ax = rng.integers(0, 3, n_part)
        q[np.arange(n_part), ax] = rng.choice([-0.2, 0.2], n_part)
        q[:, 1] += p[:, 1].max() + 0.2
        p = np.concatenate([p, q])
    ang = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(ang), np.sin(ang)
    p = p @ np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    p *= rng.uniform(0.85, 1.15)
    p += rng.normal(scale=0.01, size=p.shape)
    p -= p.mean(0, keepdims=True)
    p /= np.abs(p).max()
    return p[rng.permutation(num_points)].astype(np.float32)


def generate(seed: int, return_labels: bool, params: dict):
    """(xyz [N, 3] float32 in [-1, 1]³, None, the class as int32 or
    None)."""
    rng = np.random.default_rng(seed)
    label = int(rng.integers(0, NUM_CLASSES))
    xyz = cloud(rng, label, int(params["num_points"]))
    return xyz, None, np.int32(label) if return_labels else None
