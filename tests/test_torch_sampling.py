"""The port's center samplers (gridgcn_torch.ops.sampling) against the JAX
package's on the same voxel tables and keys: exact (Gumbel) RVS, threshold
RVS and CAS, center_vids and center_valid bit for bit."""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.ops import sampling as jsamp
from gridgcn_tpu.ops import voxelize as jvox
from gridgcn_torch.ops import sampling as tsamp
from gridgcn_torch.ops import voxelize as tvox

torch.set_num_threads(1)

R = 8


def _tables(seed, n_valid):
    """The packed voxel tables (as CAGQ builds them) of two clouds of 300
    points in [-1, 1)³ of which the first n_valid are valid, in both
    packages. n_valid = 40 leaves fewer occupied voxels than M = 64."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    mask = np.arange(300)[None].repeat(2, 0) < n_valid
    xyz[~mask] = 55.0
    key = jax.random.PRNGKey(seed)
    kw = dict(with_keys=True, with_slots=False, with_coverage=False)
    jt = jvox.build_voxel_table(jnp.asarray(xyz), jnp.asarray(mask), R, 4,
                                key, **kw)
    tt = tvox.build_voxel_table(torch.from_numpy(xyz),
                                torch.from_numpy(mask), R, 4,
                                np.asarray(key), **kw)
    return jt, tt


def _assert_same(want, got):
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("M", [8, 64])
def test_rvs_matches_jax(approx, M):
    """M = 8 takes the exact path even with approx (the threshold margin
    needs M ≥ 11); with 40 valid points fewer than M = 64 voxels are
    occupied, so the exact top-k returns the tie run of unoccupied voxels,
    lower index first."""
    fn = jax.jit(partial(jsamp.sample_centers_rvs, M=M, approx=approx))
    for seed in range(3):
        for n_valid in (300, 40):
            jt, tt = _tables(seed, n_valid)
            key = jax.random.PRNGKey(100 + seed)
            want = fn(jt, key=key)
            got = tsamp.sample_centers_rvs(tt, M, np.asarray(key),
                                           approx=approx)
            _assert_same(want, got)
            if n_valid == 40 and M == 64:
                assert not got[1].all()       # the tie run was exercised


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("cas_iters", [0, 1, 2, 3])
def test_cas_matches_jax(approx, cas_iters):
    fn = jax.jit(partial(jsamp.sample_centers_cas, M=64, context=3,
                         cas_iters=cas_iters, approx=approx))
    for seed in range(3):
        for n_valid in (300, 40):
            jt, tt = _tables(seed, n_valid)
            key = jax.random.PRNGKey(200 + seed)
            want = fn(jt, key=key)
            got = tsamp.sample_centers_cas(tt, 64, np.asarray(key), context=3,
                                           cas_iters=cas_iters, approx=approx)
            _assert_same(want, got)


def test_cas_covers_more_than_rvs():
    """The property CAS exists for (SURVEY §4.2): over several keys its
    centers' contexts cover more voxels than RVS's."""
    _, tt = _tables(0, 300)
    covered = {0: 0, 3: 0}
    for seed in range(4):
        key = np.asarray(jax.random.PRNGKey(seed))
        for it in covered:
            vids, valid = tsamp.sample_centers_cas(tt, 16, key, cas_iters=it)
            C = tsamp._coverage_counts(vids, valid, R, 3)
            covered[it] += int((C > 0).sum())
    assert covered[3] > covered[0]


@pytest.mark.parametrize("context", [1, 3, 5])
def test_box_sum_matches_jax(context):
    rng = np.random.default_rng(context)
    x = rng.integers(-3, 4, (2, 6 ** 3)).astype(np.int32)
    want = np.stack([np.asarray(jsamp._box_sum(jnp.asarray(r), 6, context))
                     for r in x])
    got = tsamp._box_sum(torch.from_numpy(x).long(), 6, context).numpy()
    np.testing.assert_array_equal(want, got)
