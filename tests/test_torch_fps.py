"""The port's FPS and ball-query baselines (gridgcn_torch.ops.fps) against
the JAX package's on the CPU: indices bit for bit (a masked tail, a masked
head, several slab sizes), and the properties `tests/test_fps.py` holds
for the JAX ones."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.ops import fps as jfps
from gridgcn_torch.ops import fps as tfps

torch.set_num_threads(1)


def _clouds(B, N, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[:, N - 37:] = False
    mask[-1, :10] = False
    return xyz, mask


@pytest.mark.parametrize("B,N,M,seed", [(2, 500, 64, 0), (3, 1000, 128, 1)])
def test_fps_and_ball_query_match_jax(B, N, M, seed):
    xyz, mask = _clouds(B, N, seed)
    key = jax.random.PRNGKey(seed + 3)
    want = np.asarray(jfps.farthest_point_sampling(
        jnp.asarray(xyz), jnp.asarray(mask), M, key))
    got = tfps.farthest_point_sampling(torch.from_numpy(xyz),
                                       torch.from_numpy(mask), M,
                                       np.asarray(key))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    centers = xyz[np.arange(B)[:, None], want]
    for block, radius, K in ((4096, 0.3, 16), (128, 0.3, 16), (96, 0.2, 8)):
        ji, jv = jfps.ball_query(jnp.asarray(xyz), jnp.asarray(mask),
                                 jnp.asarray(centers), radius, K,
                                 block=block)
        ti, tv = tfps.ball_query(torch.from_numpy(xyz),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(centers), radius, K,
                                 block=block)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert 0 < np.asarray(jv).mean() < 1


def test_fps_distinct_valid_and_spread():
    B, N, M = 2, 300, 32
    xyz = torch.rand(B, N, 3, generator=torch.Generator().manual_seed(0))
    mask = torch.ones((B, N), dtype=torch.bool)
    mask[:, 280:] = False
    idx = tfps.farthest_point_sampling(xyz, mask, M,
                                       np.asarray(jax.random.PRNGKey(42)))
    idx = idx.numpy()
    for b in range(B):
        assert len(set(idx[b].tolist())) == M
        assert (idx[b] < 280).all()

    def min_pairwise(pts):
        d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d.min()
    x = xyz.numpy()
    rnd = np.random.default_rng(0).choice(280, M, replace=False)
    assert min_pairwise(x[0][idx[0]]) > min_pairwise(x[0][rnd])


def test_ball_query_correctness():
    B, N, M, K, radius = 1, 500, 16, 8, 0.25
    g = torch.Generator().manual_seed(1)
    xyz = torch.rand(B, N, 3, generator=g)
    mask = torch.ones((B, N), dtype=torch.bool)
    mask[:, 450:] = False
    centers = torch.rand(B, M, 3, generator=g)
    idx, valid = tfps.ball_query(xyz, mask, centers, radius, K, block=128)
    idx, valid = idx.numpy(), valid.numpy()
    x, c = xyz[0].numpy(), centers[0].numpy()
    for m in range(M):
        d = np.linalg.norm(x[:450] - c[m], axis=-1)
        in_ball = np.nonzero(d <= radius)[0]
        got = idx[0, m][valid[0, m]]
        assert len(got) == min(K, len(in_ball))
        assert set(got.tolist()) <= set(in_ball.tolist())
        assert len(set(got.tolist())) == len(got)
        # first-found order: increasing point index
        assert (np.diff(got) > 0).all()
