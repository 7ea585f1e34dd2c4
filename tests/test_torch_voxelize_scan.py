"""The voxel table's prefix sum (`VoxelTable.coord_csum`) scans each
cloud's residuals over the last dim ([1, 3, N], one scan a cloud,
accumulated in float64 and rounded once): on the CPU that is bit for bit
the earlier float32 scan over dim 1 of [B, N, 3], since torch's CPU
cumsum accumulates in double too; a cloud's sums do not depend on its
batchmates;
the barycenters read from it (`gather.center_positions`) are unchanged.
The JAX reference's f32 `jnp.cumsum(axis=0)` sums in another order, so
it is held at the sum-order bound that `test_torch_cagq.py` states."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridgcn_tpu.data.synthetic import synthetic_scene_surface
from gridgcn_tpu.ops import voxelize as jvox
from gridgcn_torch.ops import voxelize as tvox
from gridgcn_torch.ops.gather import center_positions

torch.set_num_threads(1)


def _clouds(B: int, N: int):
    xyz = np.stack([synthetic_scene_surface(N, seed=3 + b)
                    for b in range(B)])
    mask = np.ones((B, N), bool)
    if B > 1:                       # masked padding set to garbage
        mask[1, N - 300:] = False
        xyz[1, N - 300:] = 77.7
    return xyz, mask


@contextlib.contextmanager
def recorded_scans(calls: list):
    """torch.cumsum, recording each call's input and dim."""
    real = torch.cumsum

    def cumsum(x, dim, *a, **kw):
        calls.append((x.clone(), dim))
        return real(x, dim, *a, **kw)
    torch.cumsum = cumsum
    try:
        yield
    finally:
        torch.cumsum = real


@pytest.mark.parametrize("B,N", [(1, 20000), (3, 4096)])
def test_coord_csum_is_the_old_scan_bit_for_bit(B, N):
    xyz, mask = _clouds(B, N)
    key = np.asarray(jax.random.PRNGKey(5))
    calls = []
    with recorded_scans(calls):
        table = tvox.build_voxel_table(
            torch.from_numpy(xyz), torch.from_numpy(mask), 32, 16, key,
            with_keys=True, with_slots=False, with_coverage=False)
    scans = [(x, d) for x, d in calls if x.shape == (1, 3, N)]
    assert len(scans) == B and all(d == -1 for _, d in scans), [
        (tuple(x.shape), d) for x, d in calls]
    residuals = torch.cat([x for x, _ in scans]).transpose(1, 2)  # [B, N, 3]
    got = table.coord_csum
    assert got.shape == (B, N, 3) and got.dtype == torch.float32
    old = torch.cumsum(residuals.contiguous(), dim=1)
    assert torch.equal(got, old)
    f64 = np.cumsum(residuals.double().numpy(), axis=1).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), f64)

    # the reference's per-cloud f32 scan on the same residuals
    want = np.stack([np.asarray(jnp.cumsum(jnp.asarray(r), axis=0))
                     for r in residuals.numpy()])
    tol = N * 2.0 ** -24 * np.abs(want).max()
    assert np.abs(want - got.numpy()).max() <= tol

    # and the reference's whole build, as test_torch_cagq holds it
    jt = jvox.build_voxel_table(jnp.asarray(xyz), jnp.asarray(mask), 32, 16,
                                jnp.asarray(key), with_keys=True,
                                with_slots=False, with_coverage=False)
    want = np.asarray(jt.coord_csum)
    tol = N * 2.0 ** -24 * np.abs(want).max()
    assert np.abs(want - got.numpy()).max() <= tol


@pytest.mark.parametrize("B,N", [(1, 20000), (3, 4096)])
def test_center_positions_unchanged(B, N):
    xyz, mask = _clouds(B, N)
    key = np.asarray(jax.random.PRNGKey(6))
    calls = []
    with recorded_scans(calls):
        table = tvox.build_voxel_table(
            torch.from_numpy(xyz), torch.from_numpy(mask), 32, 16, key,
            with_keys=True, with_slots=False, with_coverage=False)
    residuals = torch.cat([x for x, _ in calls if x.shape == (1, 3, N)])
    old = torch.cumsum(residuals.transpose(1, 2).contiguous(), dim=1)
    V = table.num_voxels
    occupied = table.occupancy > 0
    vids = torch.where(occupied, torch.arange(V), 0)[:, :512]
    valid = occupied[:, :512]
    assert valid.any()
    args = (table.seg_pos, table.occupancy, vids, valid, table.resolution,
            "barycenter", table.origin, table.vsize)
    new_xyz = center_positions(table.coord_csum, *args)
    old_xyz = center_positions(old, *args)
    assert torch.equal(new_xyz, old_xyz)


def test_a_clouds_sums_do_not_depend_on_its_batchmates():
    """Each cloud of a batch of 3 gets the coord_csum it gets alone (as
    row b of the batch's keys, `row0`)."""
    xyz, mask = _clouds(3, 2048)
    key = np.asarray(jax.random.PRNGKey(7))
    kw = dict(with_keys=True, with_slots=False, with_coverage=False)
    batch = tvox.build_voxel_table(torch.from_numpy(xyz),
                                   torch.from_numpy(mask), 16, 8, key, **kw)
    for b in range(3):
        one = tvox.build_voxel_table(torch.from_numpy(xyz[b:b + 1]),
                                     torch.from_numpy(mask[b:b + 1]), 16, 8,
                                     key, row0=b, **kw)
        assert torch.equal(one.sorted_vid[0], batch.sorted_vid[b])
        assert torch.equal(one.coord_csum[0], batch.coord_csum[b])
