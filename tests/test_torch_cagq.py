"""The port's CAGQ (gridgcn_torch.ops) against the JAX package on the same
inputs and key: every index field bit for bit, float fields to a stated
tolerance."""

import contextlib
import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.configs import base as jcfg
from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.data.synthetic import synthetic_scene_surface
from gridgcn_tpu.ops import voxelize as jvox
from gridgcn_tpu.ops.cagq import cagq as jcagq
from gridgcn_torch.configs import base as tcfg
from gridgcn_torch.configs import presets as tpresets
from gridgcn_torch.ops import voxelize as tvox
from gridgcn_torch.ops.cagq import cagq as tcagq

torch.set_num_threads(1)

N = 4096
N_CENTERS = 512


def _inputs():
    """Two clouds: a surface scene, and a uniform cloud whose last 300
    points are masked padding set to garbage."""
    rng = np.random.default_rng(0)
    xyz = np.stack([synthetic_scene_surface(N, seed=3),
                    rng.uniform(0, 3, (N, 3)).astype(np.float32)])
    mask = np.ones((2, N), bool)
    mask[1, N - 300:] = False
    xyz[1, N - 300:] = 77.7
    return xyz, mask


@pytest.fixture(scope="module")
def layer0_outputs():
    """Layer 0 of scannet_whole_scene (resolution 64, nv 16, K 32,
    threshold RVS, packed keys) at N=4096 with M=512."""
    spec_j = dataclasses.replace(
        jpresets.scannet_whole_scene().model.layers[0], n_centers=N_CENTERS)
    spec_t = dataclasses.replace(
        tpresets.scannet_whole_scene().model.layers[0], n_centers=N_CENTERS)
    xyz, mask = _inputs()
    key = jax.random.PRNGKey(5)
    oj = jax.jit(partial(jcagq, spec=spec_j))(
        jnp.asarray(xyz), jnp.asarray(mask), key=key)
    ot = tcagq(torch.from_numpy(xyz), torch.from_numpy(mask), spec_t,
               np.asarray(key))
    return jax.tree_util.tree_map(np.asarray, oj), ot


@pytest.mark.parametrize("field", ["point_vid", "sorted_vid", "key_table_pad",
                                   "occupancy", "origin", "vsize"])
def test_voxel_table_fields_bit_exact(layer0_outputs, field):
    oj, ot = layer0_outputs
    want = getattr(oj.table, field)
    got = getattr(ot.table, field).numpy()
    assert want.shape == got.shape
    np.testing.assert_array_equal(want, got.astype(want.dtype))


def test_seg_pos_bit_exact(layer0_outputs):
    """Row V of the JAX seg_pos collects every non-start point through a
    scatter declared unique, so its value is unspecified; the port writes
    0 there. Every voxel row must match."""
    oj, ot = layer0_outputs
    np.testing.assert_array_equal(oj.table.seg_pos[:, :-1],
                                  ot.table.seg_pos.numpy()[:, :-1])
    assert (ot.table.seg_pos.numpy()[:, -1] == 0).all()


@pytest.mark.parametrize("field", ["center_vids", "center_valid",
                                   "neighbor_idx", "neighbor_mask",
                                   "node_coverage", "node_xyz"])
def test_group_fields_bit_exact(layer0_outputs, field):
    oj, ot = layer0_outputs
    want = getattr(oj.groups, field)
    got = getattr(ot.groups, field).numpy()
    assert want.shape == got.shape
    np.testing.assert_array_equal(want, got.astype(want.dtype))
    if field == "center_valid":     # the threshold sampler really sampled
        assert (want.sum(-1) > N_CENTERS // 2).all()


def test_float_fields_within_sum_order_tolerance(layer0_outputs):
    """coord_csum is an f32 prefix sum whose order differs between XLA and
    torch: bound by N·2⁻²⁴ of its largest partial sum. center_xyz is a
    difference of two such rows over a count: 1e-6 absolute at scene
    coordinates of a few meters."""
    oj, ot = layer0_outputs
    want, got = oj.table.coord_csum, ot.table.coord_csum.numpy()
    tol = N * 2.0 ** -24 * np.abs(want).max()
    assert np.abs(want - got).max() <= tol
    np.testing.assert_allclose(ot.groups.center_xyz.numpy(),
                               oj.groups.center_xyz, rtol=0, atol=1e-6)


def test_capacity_stats_match(layer0_outputs):
    oj, ot = layer0_outputs
    st = tvox.capacity_stats(ot.table)
    stored = oj.table.occupancy.sum(-1)
    total = (oj.table.point_vid < 64 ** 3).sum(-1)
    np.testing.assert_array_equal(st["stored_points"].numpy(), stored)
    np.testing.assert_array_equal(st["total_points"].numpy(), total)
    np.testing.assert_array_equal(st["total_points"].numpy(), [N, N - 300])


def test_coverage_codec_exhaustive():
    """encode over every count 0..2¹⁷, decode over all 64 codes."""
    counts = np.arange(2 ** 17 + 1, dtype=np.int32)
    np.testing.assert_array_equal(
        np.asarray(jvox.encode_coverage(jnp.asarray(counts))),
        tvox.encode_coverage(torch.from_numpy(counts).long()).numpy())
    codes = np.arange(64, dtype=np.int32)
    np.testing.assert_array_equal(
        np.asarray(jvox.decode_coverage(jnp.asarray(codes))),
        tvox.decode_coverage(torch.from_numpy(codes).long()).numpy())


@pytest.mark.parametrize("flag", ["coord_match", "coord_payload"])
def test_unported_builds_raise(flag):
    """The combined selection table (sel_coords) of the coord_match /
    coord_payload gathers holds at most 32 slot quads a voxel: for nv > 32
    the build and every CAGQ layer that asks for it raise as the JAX
    package's do, and at nv = 32 both build."""
    xyz = np.random.default_rng(0).uniform(-1, 1, (1, 64, 3)).astype(
        np.float32)
    mask = np.ones((1, 64), bool)
    key = jax.random.PRNGKey(0)
    kw = dict(with_keys=True, with_slots=False, sel_coords=True)
    for nv in (33, 32):
        raises = pytest.raises(ValueError, match="nv <= 32") if nv > 32 \
            else contextlib.nullcontext()
        with raises:
            jax.jit(partial(jvox.build_voxel_table, resolution=4, nv=nv,
                            **kw))(jnp.asarray(xyz), jnp.asarray(mask),
                                   key=key)
        with raises:
            tvox.build_voxel_table(torch.from_numpy(xyz),
                                   torch.from_numpy(mask), 4, nv,
                                   np.asarray(key), **kw)
    spec_j = dataclasses.replace(jpresets.synthetic_tiny().model.layers[0],
                                 nv=33, **{flag: True})
    spec_t = dataclasses.replace(tpresets.synthetic_tiny().model.layers[0],
                                 nv=33, **{flag: True})
    with pytest.raises(ValueError, match="nv <= 32"):
        jax.jit(partial(jcagq, spec=spec_j))(jnp.asarray(xyz),
                                             jnp.asarray(mask), key=key)
    with pytest.raises(ValueError, match="nv <= 32"):
        tcagq(torch.from_numpy(xyz), torch.from_numpy(mask), spec_t,
              np.asarray(key))


def _coord_inputs(B):
    """tests/test_gather.py's clouds for the coord paths: B × 400 uniform
    points in [-1, 1), the last 20 masked (the rng_key fixture's key)."""
    xyz = jax.random.uniform(jax.random.PRNGKey(0), (B, 400, 3), minval=-1,
                             maxval=1)
    mask = jnp.ones((B, 400), bool).at[:, 380:].set(False)
    return xyz, mask


_GROUP_FIELDS = ("neighbor_idx", "neighbor_mask", "node_xyz",
                 "node_coverage", "center_xyz", "center_valid")


def _assert_group_field(f, want, got):
    """A GroupedNodes field of the port against JAX's: bit for bit, but
    center_xyz (the barycenters, the same code on every gather path) to
    the 1e-6 of the other center tests here: the two packages' f32 prefix
    sums differ by a few ulps (ROADMAP §3)."""
    if f == "center_xyz":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f)
        return
    if want.dtype == np.float32:
        want, got = want.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(want, got, err_msg=f)


@pytest.mark.parametrize("approx_topk", [False, True])
def test_coord_match_matches_jax(approx_topk):
    """Counterpart of tests/test_gather.py::test_coord_match_is_bit_exact:
    the selection-table build and the coord_match gather on JAX's inputs
    (RVS centers from JAX's sampler), every output bit for bit JAX's for
    each of its z_window lowerings (the barycenters as `_assert_group_field`
    says); the table itself too."""
    from gridgcn_tpu.ops.gather import gather_nodes as jgather
    from gridgcn_tpu.ops.sampling import sample_centers_rvs as jrvs
    from gridgcn_torch.ops.gather import gather_nodes

    xyz, mask = _coord_inputs(2)
    kw = dict(key_pad=(1, 3), with_slots=False, with_keys=True,
              sel_coords=True)
    jt = jax.jit(partial(jvox.build_voxel_table, resolution=8, nv=4, **kw))(
        xyz, mask, key=jax.random.PRNGKey(7))
    tt = tvox.build_voxel_table(torch.from_numpy(np.asarray(xyz)),
                                torch.from_numpy(np.asarray(mask)), 8, 4,
                                np.asarray(jax.random.PRNGKey(7)), **kw)
    np.testing.assert_array_equal(np.asarray(jt.sel_table_pad),
                                  tt.sel_table_pad.numpy())
    np.testing.assert_array_equal(np.asarray(jt.key_table),
                                  tt.key_table.numpy())
    assert tt.key_table_pad is None
    cvid, cvalid = jax.jit(partial(jrvs, M=48))(
        jt, key=jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(11)
    gt = gather_nodes(tt, torch.from_numpy(np.asarray(xyz)),
                      torch.from_numpy(np.asarray(cvid)).long(),
                      torch.from_numpy(np.asarray(cvalid)), 16, 3,
                      np.asarray(key), approx=True, approx_topk=approx_topk)
    for z_window in (False, True):
        gj = jax.jit(partial(jgather, K=16, context=3, approx=True,
                             approx_topk=approx_topk, z_window=z_window))(
            jt, xyz, cvid, cvalid, key=key)
        for f in _GROUP_FIELDS:
            _assert_group_field(f, np.asarray(getattr(gj, f)),
                                getattr(gt, f).numpy())


@pytest.mark.parametrize("B", [1, 2])
def test_coord_payload_matches_jax(B):
    """Counterpart of tests/test_gather.py::test_coord_payload_is_bit_exact:
    CAGQ with coord_payload (B = 1 takes JAX's slice-gather runs, B = 2 its
    z-window) against JAX's, every group field bit for bit (the
    barycenters as `_assert_group_field` says), and bit for bit against
    the port's default packed path."""
    base_j = jcfg.GridLayerSpec(resolution=8, nv=4, n_centers=48,
                                k_neighbors=16, sampler="rvs",
                                coord_payload=True)
    base_t = tcfg.GridLayerSpec(resolution=8, nv=4, n_centers=48,
                                k_neighbors=16, sampler="rvs")
    xyz, mask = _coord_inputs(B)
    key = jax.random.PRNGKey(5)
    gj = jax.jit(partial(jcagq, spec=base_j))(xyz, mask, key=key).groups
    x = torch.from_numpy(np.asarray(xyz))
    m = torch.from_numpy(np.asarray(mask))
    gt = tcagq(x, m, dataclasses.replace(base_t, coord_payload=True),
               np.asarray(key)).groups
    gd = tcagq(x, m, base_t, np.asarray(key)).groups
    for f in _GROUP_FIELDS:
        got = getattr(gt, f).numpy()
        _assert_group_field(f, np.asarray(getattr(gj, f)), got)
        want = getattr(gd, f).numpy()
        if f in ("node_xyz", "center_xyz"):
            want, got = want.view(np.int32), got.view(np.int32)
        np.testing.assert_array_equal(want, got, err_msg=f)


@pytest.mark.parametrize("packed", [True, False])
def test_gather_candidates_match_jax(packed):
    """return_candidates on both gather paths: the [M, P·nv] candidate
    indices and validity, with the selected nodes, bit for bit."""
    from gridgcn_tpu.ops.gather import gather_nodes as jgather
    from gridgcn_tpu.ops.sampling import sample_centers_rvs as jrvs
    from gridgcn_torch.ops.gather import gather_nodes
    from gridgcn_torch.ops.sampling import sample_centers_rvs

    xyz, mask = _inputs()
    xyz, mask = xyz[:, :600], mask[:, :600]
    kw = dict(with_keys=packed, with_slots=not packed,
              with_coverage=not packed, key_pad=(1, 3))
    key = jax.random.PRNGKey(8)
    jt = jvox.build_voxel_table(jnp.asarray(xyz), jnp.asarray(mask), 8, 4,
                                key, **kw)
    tt = tvox.build_voxel_table(torch.from_numpy(xyz),
                                torch.from_numpy(mask), 8, 4,
                                np.asarray(key), **kw)
    jv, jok = jrvs(jt, 40, key)
    tv, tok = sample_centers_rvs(tt, 40, np.asarray(key))
    want = jgather(jt, jnp.asarray(xyz), jv, jok, 16, 3, key, approx=packed,
                   return_candidates=True)
    got = gather_nodes(tt, torch.from_numpy(xyz), tv, tok, 16, 3,
                       np.asarray(key), approx=packed,
                       return_candidates=True)
    for field in ("cand_idx", "cand_valid", "neighbor_idx", "neighbor_mask",
                  "node_coverage"):
        np.testing.assert_array_equal(
            np.asarray(getattr(want, field)),
            getattr(got, field).numpy().astype(
                np.asarray(getattr(want, field)).dtype), err_msg=field)
    assert got.cand_valid.any()
