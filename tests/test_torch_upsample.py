"""The port's decoder 3-NN queries (gridgcn_torch.ops.upsample) against the
JAX package's on the same inputs, and the port against the JAX package's
golden file (tests/golden/golden.npz).

Tolerances: the port repeats XLA:CPU's float32 roundings (its FMA
contractions included), so indices are equal and weights within 1e-6. The
one exception is the approx dense path, whose bf16 distances tie often:
XLA:CPU takes their k smallest with an unstable sort, so among equal bf16
values the indices may differ; the distances chosen, and the weights, may
not."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.ops import cagq as jcagq
from gridgcn_tpu.ops import grid_three_nn as jgrid
from gridgcn_tpu.ops.upsample import dense_three_nn as jdense
from gridgcn_torch.configs.base import GridLayerSpec
from gridgcn_torch.ops.cagq import cagq
from gridgcn_torch.ops.upsample import dense_three_nn, grid_three_nn
from tests.golden.generate import CAS_SPEC, OUT, SPEC, make_inputs

torch.set_num_threads(1)


def _clouds(seed, B=2, nq=700, ns=230, quantum=None):
    """Query and support clouds in [-1, 1)³ with masked tails (the masked
    points set to garbage). quantum rounds the coordinates to its grid,
    which makes exact distance ties."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (B, nq, 3)).astype(np.float32)
    s = rng.uniform(-1, 1, (B, ns, 3)).astype(np.float32)
    if quantum:
        q = (np.round(q / quantum) * quantum).astype(np.float32)
        s = (np.round(s / quantum) * quantum).astype(np.float32)
    qm = np.ones((B, nq), bool)
    qm[1, -50:] = False
    sm = np.ones((B, ns), bool)
    sm[0, -9:] = False
    s[0, -9:] = 40.0
    return q, qm, s, sm


def _sq(q, s, idx):
    """float64 squared distance from each query to its chosen supports."""
    b = np.arange(q.shape[0])[:, None, None]
    d = q[:, :, None, :].astype(np.float64) - s[b, idx].astype(np.float64)
    return (d * d).sum(-1)


def _match_up_to_near_ties(q, s, qm, want, got, rel=1e-5):
    """`found` equal, and indices equal wherever the float64 distances of
    the JAX and port choices at that rank differ by more than `rel`
    (relative); returns the count of indices that differ."""
    want_i, want_w, want_f = want
    got_i, got_w, got_f = got
    np.testing.assert_array_equal(want_f, got_f)
    differ = want_i != got_i
    dw, dg = _sq(q, s, want_i), _sq(q, s, got_i)
    near = np.abs(dw - dg) <= rel * np.maximum(dw, 1e-12)
    assert not (differ & ~near).any()
    return int(differ.sum())


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("quantum", [None, 2.0 ** -5])
def test_dense_three_nn_matches_jax(approx, quantum):
    """Exact: the port repeats XLA:CPU's roundings of |q|² + |s|² − 2q·s,
    so indices and weights match with no near tie. approx: d² is cast to
    bf16, where many distances tie, and XLA:CPU takes the k smallest with
    an unstable sort, so among equal bf16 values it may pick other
    indices than the port's lower-index-first; the chosen bf16 values, and
    so the weights, are the same."""
    q, qm, s, sm = _clouds(3, quantum=quantum)
    want = [np.asarray(a) for a in jdense(
        *map(jnp.asarray, (q, qm, s, sm)), block=64, approx=approx)]
    got = [a.numpy() for a in dense_three_nn(
        *map(torch.from_numpy, (q, qm, s, sm)), block=64, approx=approx)]
    near = _match_up_to_near_ties(q, s, qm, want, got,
                                  rel=2.0 ** -7 if approx else 1e-5)
    if not approx:
        assert near == 0
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_three_nn_matches_jax(seed):
    q, qm, s, sm = _clouds(seed, nq=900, ns=300)
    key = jax.random.PRNGKey(seed + 10)
    want = [np.asarray(a) for a in jax.jit(
        lambda *a: jgrid(*a, 6, 8, key, chunk=256))(
        *map(jnp.asarray, (q, qm, s, sm)))]
    got = [a.numpy() for a in grid_three_nn(
        *map(torch.from_numpy, (q, qm, s, sm)), 6, 8, np.asarray(key),
        chunk=256)]
    assert _match_up_to_near_ties(q, s, qm, want, got) == 0
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    assert got[2].mean() > 0.9          # the grid query really found


@pytest.fixture(scope="module")
def golden():
    return np.load(OUT)


def _port_inputs():
    xyz, mask, key = make_inputs()
    return (torch.from_numpy(np.asarray(xyz)), torch.from_numpy(
        np.asarray(mask)), np.asarray(key))


def _port_spec(spec):
    return GridLayerSpec(**spec.__dict__)


def test_port_reproduces_golden_cagq(golden):
    xyz, mask, key = _port_inputs()
    g = cagq(xyz, mask, _port_spec(SPEC), key).groups
    for field in ("neighbor_idx", "neighbor_mask", "node_coverage",
                  "center_vids"):
        np.testing.assert_array_equal(
            getattr(g, field).numpy().astype(golden[field].dtype),
            golden[field], err_msg=field)
    for field in ("center_xyz", "node_xyz"):
        np.testing.assert_allclose(getattr(g, field).numpy(), golden[field],
                                   rtol=0, atol=1e-6, err_msg=field)


def test_port_reproduces_golden_cas(golden):
    xyz, mask, key = _port_inputs()
    g = cagq(xyz, mask, _port_spec(CAS_SPEC), key).groups
    np.testing.assert_array_equal(g.center_vids.numpy(),
                                  golden["cas_center_vids"])
    np.testing.assert_array_equal(g.center_valid.numpy(),
                                  golden["cas_center_valid"])


def test_port_reproduces_golden_upsample(golden):
    xyz, mask, key = _port_inputs()
    nn_idx, weights, found = grid_three_nn(
        xyz, mask, xyz[:, :64], mask[:, :64], 4, 16, key)
    np.testing.assert_array_equal(nn_idx.numpy(), golden["up_idx"])
    np.testing.assert_allclose(weights.numpy(), golden["up_weights"],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(found.numpy(), golden["up_found"])


def test_golden_inputs_are_what_the_jax_package_reads(golden):
    """The golden file still pins the JAX package's CAGQ (so the port is
    held to the reference, not to a stale file)."""
    xyz, mask, key = make_inputs()
    out = jcagq(xyz, mask, SPEC, key)
    np.testing.assert_array_equal(np.asarray(out.groups.center_vids),
                                  golden["center_vids"])
