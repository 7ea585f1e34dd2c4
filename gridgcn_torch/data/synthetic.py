"""Synthetic datasets for tests, the overfit gate, and training and
benchmarking when no real dataset is on disk: numpy copies of the JAX
package's generators (classification shapes, quadrant segmentation, the
40-class shape stand-in, surface scenes and the noisy feature field), so
that the port needs no JAX. The same arrays per seed, bit for bit."""

from __future__ import annotations

import numpy as np


def synthetic_classification(num_clouds: int, num_points: int,
                             num_classes: int = 4, seed: int = 0):
    """Geometrically distinguishable shape classes: sphere surface, cube
    surface, two-cluster blob, cylinder surface (cycled for >4 classes)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((num_clouds, num_points, 3), np.float32)
    labels = np.arange(num_clouds) % num_classes

    for i, lab in enumerate(labels):
        kind = lab % 4
        if kind == 0:       # sphere surface
            v = rng.normal(size=(num_points, 3))
            p = v / np.linalg.norm(v, axis=1, keepdims=True)
        elif kind == 1:     # cube surface
            p = rng.uniform(-1, 1, size=(num_points, 3))
            ax = rng.integers(0, 3, num_points)
            sign = rng.choice([-1.0, 1.0], num_points)
            p[np.arange(num_points), ax] = sign
        elif kind == 2:     # two clusters
            c = rng.choice([-0.6, 0.6], num_points)
            p = rng.normal(scale=0.25, size=(num_points, 3))
            p[:, 0] += c
        else:               # cylinder surface
            theta = rng.uniform(0, 2 * np.pi, num_points)
            z = rng.uniform(-1, 1, num_points)
            p = np.stack([np.cos(theta), z, np.sin(theta)], 1)
        pts[i] = p + rng.normal(scale=0.02, size=(num_points, 3))
    return pts, labels.astype(np.int32)


def synthetic_segmentation(num_clouds: int, num_points: int,
                           num_classes: int = 4, seed: int = 0):
    """Per-point labels derivable from geometry (spatial quadrant)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, size=(num_clouds, num_points, 3)).astype(np.float32)
    qx = (pts[..., 0] > 0).astype(np.int32)
    qy = (pts[..., 1] > 0).astype(np.int32)
    labels = (qx * 2 + qy) % num_classes
    return pts, labels.astype(np.int32)


def synthetic_shapes40(num_clouds: int, num_points: int, seed: int = 0):
    """40-class ModelNet40 stand-in for preset-scale convergence gates
    (VERDICT r2 #3): classes are a 5 (base shape) x 4 (aspect ratio) x 2
    (part attached) grid, so discriminating them requires shape AND
    proportion AND part-presence cues — none is decidable from a single
    point statistic. Instances get the ModelNet40 eval protocol's nuisance
    transforms: random rotation about the gravity axis, per-instance scale
    jitter, and point noise. Returns pts [num_clouds, num_points, 3] f32
    (unit-normalized like real ModelNet40) and labels [num_clouds] i32."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((num_clouds, num_points, 3), np.float32)
    labels = (np.arange(num_clouds) % 40).astype(np.int32)
    aspects = (0.4, 0.7, 1.0, 1.6)

    def base_surface(kind, n):
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
            u = np.sqrt(rng.uniform(0, 1, n))   # area-uniform along slant
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

    for i, lab in enumerate(labels):
        kind, aspect, part = lab % 5, aspects[(lab // 5) % 4], lab >= 20
        n_part = int(num_points * 0.15) if part else 0
        p = base_surface(kind, num_points - n_part)
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
        pts[i] = p[rng.permutation(num_points)]
    return pts, labels


def synthetic_scene_surface(num_points: int, seed: int = 0,
                            room: tuple = (6.0, 2.6, 5.0),
                            return_labels: bool = False):
    """Surface-like indoor scene (room scan stand-in) for capacity-honest
    benchmarking (VERDICT r1 weak #4): real scans are SURFACES with heavily
    skewed voxel occupancy, not uniform volumes. Points lie on the floor,
    walls, ceiling patches and a handful of box/cylinder objects, with
    scanner-like density skew (objects and near-floor regions denser) and
    ~2% sensor noise speckle. Returns xyz [num_points, 3] float32 in a
    W×H×D meter room; with return_labels also part labels [num_points]
    int32 (0 floor, 1 ceiling, 2 wall, 3 object — speckle takes the
    nearest-part label 3), giving a semantically meaningful whole-scene
    segmentation stand-in.
    """
    rng = np.random.default_rng(seed)
    W, H, D = room
    quotas = {
        "floor": 0.28, "ceiling": 0.06, "walls": 0.26,
        "objects": 0.38, "speckle": 0.02,
    }
    parts = []

    def plane(n, axis, value, lo0, hi0, lo1, hi1, skew=None):
        """n points on an axis-aligned plane; optional density skew."""
        u = rng.uniform(lo0, hi0, n)
        v = rng.uniform(lo1, hi1, n)
        if skew == "edge":       # scanners over-sample near wall junctions
            u = lo0 + (hi0 - lo0) * rng.beta(0.6, 0.6, n)
        p = np.empty((n, 3), np.float32)
        other = [i for i in range(3) if i != axis]
        p[:, axis] = value
        p[:, other[0]] = u
        p[:, other[1]] = v
        return p

    labels = []
    n_floor = int(num_points * quotas["floor"])
    parts.append(plane(n_floor, 1, 0.0, 0, W, 0, D, skew="edge"))
    labels.append(np.zeros(n_floor, np.int32))
    n_ceil = int(num_points * quotas["ceiling"])
    parts.append(plane(n_ceil, 1, H, 0, W, 0, D))
    labels.append(np.ones(n_ceil, np.int32))

    n_wall = int(num_points * quotas["walls"]) // 4
    parts.append(plane(n_wall, 0, 0.0, 0, H, 0, D))
    parts.append(plane(n_wall, 0, W, 0, H, 0, D))
    parts.append(plane(n_wall, 2, 0.0, 0, W, 0, H))
    parts.append(plane(n_wall, 2, D, 0, W, 0, H))
    labels.append(np.full(4 * n_wall, 2, np.int32))

    # objects: boxes and cylinders standing on the floor, surface-sampled,
    # 2-4x the ambient surface density (the capacity stressor)
    n_obj_total = int(num_points * quotas["objects"])
    n_objs = 8
    sizes = rng.uniform(0.3, 1.2, size=(n_objs, 3))
    centers = np.stack([rng.uniform(0.8, W - 0.8, n_objs),
                        sizes[:, 1] / 2,
                        rng.uniform(0.8, D - 0.8, n_objs)], 1)
    weights = rng.dirichlet(np.full(n_objs, 0.7))   # skewed per-object share
    for j in range(n_objs):
        n = max(int(n_obj_total * weights[j]), 1)
        if j % 2 == 0:   # box surface
            p = rng.uniform(-0.5, 0.5, size=(n, 3))
            ax = rng.integers(0, 3, n)
            p[np.arange(n), ax] = rng.choice([-0.5, 0.5], n)
            p = p * sizes[j] + centers[j]
        else:            # cylinder surface
            theta = rng.uniform(0, 2 * np.pi, n)
            y = rng.uniform(-0.5, 0.5, n) * sizes[j, 1] + centers[j, 1]
            r = sizes[j, 0] / 2
            p = np.stack([centers[j, 0] + r * np.cos(theta), y,
                          centers[j, 2] + r * np.sin(theta)], 1)
        parts.append(p.astype(np.float32))
        labels.append(np.full(len(p), 3, np.int32))

    pts = np.concatenate(parts)[:num_points]
    labs = np.concatenate(labels)[:num_points]
    if len(pts) < num_points:   # speckle tops up to the exact count
        n = num_points - len(pts)
        noise = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n),
                          rng.uniform(0, D, n)], 1).astype(np.float32)
        pts = np.concatenate([pts, noise])
        labs = np.concatenate([labs, np.full(n, 3, np.int32)])
    pts += rng.normal(scale=0.008, size=pts.shape).astype(np.float32)
    perm = rng.permutation(num_points)
    if return_labels:
        return pts[perm].astype(np.float32), labs[perm]
    return pts[perm].astype(np.float32)


def synthetic_feature_field(num_points: int, seed: int = 0,
                            num_feats: int = 6, noise: float = 2.0,
                            field_scale: float = 1.2,
                            room: tuple = (6.0, 2.6, 5.0)):
    """Scene whose labels require NEIGHBORHOOD aggregation of FEATURES —
    the convergence-gate task of VERDICT r4 #4 (SURVEY §4.2 #4).

    Points are UNIFORM in the room (xyz carries zero label signal, unlike
    the density task where geometry alone separates blob classes). Two
    independent smooth hidden fields s0(x), s1(x) ∈ {−1, +1} (signs of
    random Gaussian mixtures at length scale `field_scale`) define the
    4-class label 2·(s0>0) + (s1>0). Per-point features observe the
    fields through heavy noise: f_k = s_k + noise·N(0,1), so

      * a SINGLE point's features are weak evidence — at noise=2.0 the
        per-point Bayes rate is Φ(1/2)² ≈ 0.48 for the joint label;
      * a K≈32 neighborhood mean recovers each sign almost surely away
        from the fields' zero-crossing surfaces, whose measure (set by
        `field_scale`) pins the achievable plateau MID-BAND — the
        sensitivity property the two saturated gates lack
        (accuracy_targets.json: plateaus 1.0 / 0.999 cannot detect a
        bf16-sized regression; this task's can).

    Feature layout matches the s3dis preset convention (SURVEY §2.3
    F-13): channels 0..2 = the two noisy field observations + one pure-
    noise distractor (rgb-like slot), channels 3..5 = normalized xyz
    (feat_geo_channels). Returns (xyz [N,3] f32, feat [N,num_feats] f32,
    labels [N] int32).
    """
    rng = np.random.default_rng(seed)
    W, H, D = room
    xyz = np.stack([rng.uniform(0, W, num_points),
                    rng.uniform(0, H, num_points),
                    rng.uniform(0, D, num_points)], 1).astype(np.float32)

    def field_sign(k):
        frng = np.random.default_rng(seed * 31 + k)
        nc = 8
        centers = np.stack([frng.uniform(0, W, nc), frng.uniform(0, H, nc),
                            frng.uniform(0, D, nc)], 1)
        amps = frng.choice([-1.0, 1.0], nc)
        d2 = ((xyz[:, None, :] - centers[None]) ** 2).sum(-1)
        g = (amps * np.exp(-d2 / (2 * field_scale ** 2))).sum(-1)
        # median-center so both signs have substantial measure in every
        # scene (a lopsided field would let a constant prediction score)
        return np.where(g > np.median(g), 1.0, -1.0)

    s0, s1 = field_sign(0), field_sign(1)
    labels = (2 * (s0 > 0) + (s1 > 0)).astype(np.int32)

    obs = np.stack([s0, s1, np.zeros(num_points)], 1)
    obs = obs + noise * rng.standard_normal((num_points, 3))
    mins, maxs = xyz.min(0, keepdims=True), xyz.max(0, keepdims=True)
    nxyz = (xyz - mins) / np.maximum(maxs - mins, 1e-6)
    feat = np.concatenate([obs, nxyz], 1)[:, :num_feats].astype(np.float32)
    return xyz, feat, labels
