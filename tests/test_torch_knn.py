"""The flash-kNN plain versions (gridgcn_torch.kernels.knn) against the JAX
package's Pallas kernels run in interpret mode, with test_pallas.py's shapes
and gates. The CUDA kernels themselves are held against these plain
versions on the card (test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.ops.pallas.knn import flash_knn, flash_knn_mxu
from gridgcn_tpu.ops.pallas.knn import flash_three_nn as jflash_three_nn
from gridgcn_torch.kernels import knn as tknn

torch.set_num_threads(1)


def _cloud(rng, n, lo, hi, quantum=None):
    x = rng.uniform(lo, hi, (n, 3))
    if quantum is not None:
        x = np.round(x / quantum) * quantum
    return x.astype(np.float32)


def _jax(fn, q, qm, s, sm, **kw):
    out = fn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(s),
             jnp.asarray(sm), k=3, interpret=True, **kw)
    return [np.asarray(o) for o in out]


def _port(fn, q, qm, s, sm):
    return [o.numpy() for o in fn(torch.from_numpy(q), torch.from_numpy(qm),
                                  torch.from_numpy(s), torch.from_numpy(sm))]


# test_pallas.py:12-46 shapes — masked queries and supports, Ns=700 across
# blocks — plus a support set with only 2 valid points
EXACT_CASES = [(300, 200, 280, 180), (500, 700, 500, 700),
               (256, 300, 256, 2)]


@pytest.mark.parametrize("nq,ns,nq_valid,ns_valid", EXACT_CASES)
def test_exact_ref_bit_exact_on_exact_arithmetic(nq, ns, nq_valid, ns_valid):
    """Coordinates on a 2⁻⁸ grid in [0, 1): every square and sum is exact
    in f32, so rounding order cannot matter and the comparison covers the
    key packing, the truncated d² and the tie-breaks (many exact ties)
    bit for bit, including the padded-column indices of invalid slots."""
    rng = np.random.default_rng(nq + ns)
    q = _cloud(rng, nq, 0, 1, 2.0 ** -8)
    s = _cloud(rng, ns, 0, 1, 2.0 ** -8)
    qm = np.arange(nq) < nq_valid
    sm = np.arange(ns) < ns_valid
    dj, ij, vj = _jax(flash_knn, q, qm, s, sm)
    dt, it, vt = _port(tknn.knn3_exact, q, qm, s, sm)
    np.testing.assert_array_equal(dj.view(np.int32), dt.view(np.int32))
    np.testing.assert_array_equal(ij, it)
    np.testing.assert_array_equal(vj, vt)
    if ns_valid == 2:
        assert vt[:, :2].all() and not vt[:, 2:].any()


@pytest.mark.parametrize("nq,ns,nq_valid,ns_valid", EXACT_CASES)
def test_exact_ref_matches_interpret_on_float_inputs(nq, ns, nq_valid,
                                                     ns_valid):
    """Random f32 coordinates. The Pallas source and the port round each
    operation of (dx·dx + dy·dy) + dz·dz, but XLA:CPU, which runs the
    interpret mode, contracts them into FMAs; so indices and validity
    must match exactly, and d² to within one truncation step (the low
    idx_bits of the f32 pattern) on valid slots."""
    rng = np.random.default_rng(7 * nq + ns)
    q = _cloud(rng, nq, -4, 9)
    s = _cloud(rng, ns, -4, 9)
    qm = np.arange(nq) < nq_valid
    sm = np.arange(ns) < ns_valid
    dj, ij, vj = _jax(flash_knn, q, qm, s, sm)
    dt, it, vt = _port(tknn.knn3_exact, q, qm, s, sm)
    np.testing.assert_array_equal(ij, it)
    np.testing.assert_array_equal(vj, vt)
    _, idx_bits = tknn.exact_layout(ns)
    step = np.abs(dj.view(np.int32).astype(np.int64)
                  - dt.view(np.int32).astype(np.int64))[vj]
    assert step.max(initial=0) <= 1 << idx_bits


@pytest.mark.parametrize("nq,ns,seed", [(1024, 700, 4), (512, 700, 11),
                                        (300, 129, 2)])
def test_mxu_ref_meets_pallas_gates(nq, ns, seed):
    """test_pallas.py:49-72 and :111-135 gates against the exact kernel —
    recall, top-1 and |Δd²| < 2e-2 on matching neighbors, Ns not a
    multiple of 128, masked supports — tightened to recall ≥ 0.99 because
    the port's top-3 has no lane fold."""
    rng = np.random.default_rng(seed)
    q = _cloud(rng, nq, -4, 9)
    s = _cloud(rng, ns, -4, 9)
    qm = np.ones(nq, bool)
    sm = np.ones(ns, bool)
    sm[ns - 7:] = False
    de, ie, ve = _jax(flash_knn, q, qm, s, sm)
    dm, im, vm = _port(tknn.knn3_mxu, q, qm, s, sm)
    np.testing.assert_array_equal(ve, vm)
    assert np.all(im < ns - 7)                 # masked rows never win
    recall = np.mean([len(set(ie[i]) & set(im[i])) / 3 for i in range(nq)])
    assert recall >= 0.99, recall
    assert (ie[:, 0] == im[:, 0]).mean() >= 0.99
    match = ie == im
    assert np.abs(dm - de)[match].max() < 2e-2
    # the JAX mxu kernel on the same inputs splits the raw coordinates; the
    # port splits them centered on the supports, so its distances are at
    # least as close to the exact kernel's
    dj, ij, vj = _jax(flash_knn_mxu, q, qm, s, sm)
    np.testing.assert_array_equal(vj, vm)
    assert (ij[:, 0] == im[:, 0]).mean() >= 0.99
    same = (ij == im) & match
    assert np.abs(dm - de)[same].max() <= np.abs(dj - de)[same].max()


def test_mxu_ref_masked_supports_never_win():
    """test_pallas.py:95-108: only 2 valid supports."""
    rng = np.random.default_rng(5)
    q = _cloud(rng, 256, 0, 1)
    s = _cloud(rng, 300, 0, 1)
    sm = np.zeros(300, bool)
    sm[:2] = True
    _, idx, valid = _port(tknn.knn3_mxu, q, np.ones(256, bool), s, sm)
    assert valid[:, :2].all() and not valid[:, 2:].any()
    assert (idx[valid] < 2).all()


def _three_nn_inputs():
    rng = np.random.default_rng(1)
    B, nq, ns = 2, 300, 200
    q = np.stack([_cloud(rng, nq, 0, 1) for _ in range(B)])
    s = np.stack([_cloud(rng, ns, 0, 1) for _ in range(B)])
    qm = np.ones((B, nq), bool)
    qm[:, 280:] = False
    sm = np.ones((B, ns), bool)
    sm[:, 180:] = False
    return q, qm, s, sm


def _three_nn(q, qm, s, sm, jax_variant, port_variant):
    j = [np.asarray(o) for o in jflash_three_nn(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(s), jnp.asarray(sm),
        k=3, interpret=True, variant=jax_variant)]
    t = [o.numpy() for o in tknn.flash_three_nn(
        torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(s),
        torch.from_numpy(sm), k=3, variant=port_variant)]
    return j, t


def test_flash_three_nn_exact_matches_jax():
    """Batched wrapper, exact variant, against the JAX wrapper with the
    exact kernel: indices and found flags exactly; weights to 1e-4
    relative, the size of one d² truncation step (2⁻¹⁵ relative at
    ns_pad=256), by which XLA:CPU's FMA contraction may move d²."""
    q, qm, s, sm = _three_nn_inputs()
    (ij, wj, fj), (it, wt, ft) = _three_nn(q, qm, s, sm, "exact", "exact")
    np.testing.assert_array_equal(fj, ft)
    assert ft[:, :280].all() and not ft[:, 280:].any()
    np.testing.assert_array_equal(ij, it)
    np.testing.assert_allclose(wt, wj, rtol=1e-4, atol=1e-7)


def test_flash_three_nn_mxu_matches_jax():
    """The main path's variant against the JAX wrapper. Against the exact
    kernel: the same neighbors, weights within 0.02 — the split-bf16 d²
    error dominates 1/d² for the nearest pairs, in the JAX mxu kernel
    alike. Against the JAX mxu kernel, which splits the raw coordinates
    where the port splits them centered on the supports: the same
    neighbors almost everywhere, and weights at least as close to the
    exact kernel's."""
    q, qm, s, sm = _three_nn_inputs()
    (ie, we, fe), (it, wt, ft) = _three_nn(q, qm, s, sm, "exact", "mxu")
    np.testing.assert_array_equal(fe, ft)
    assert (ie == it).mean() >= 0.99
    same = (ie == it).all(-1)
    assert np.abs(wt - we)[same].max() < 2e-2
    (im, wm, _), _ = _three_nn(q, qm, s, sm, "mxu", "mxu")
    assert (im == it).all(-1).mean() >= 0.97
    same &= (im == it).all(-1)
    assert np.abs(wt - we)[same].max() <= np.abs(wm - we)[same].max()


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_cloud(rng, 64, 0, 1))
    s = torch.from_numpy(_cloud(rng, 40, 0, 1))
    qm = torch.ones(64, dtype=torch.bool)
    sm = torch.ones(40, dtype=torch.bool)
    before = (tknn.knn3_mxu.launches, tknn.knn3_exact.launches)
    for fn, ref in ((tknn.knn3_mxu, tknn.knn3_mxu_ref),
                    (tknn.knn3_exact, tknn.knn3_exact_ref)):
        for a, b in zip(fn(q, qm, s, sm), ref(q, qm, s, sm)):
            assert torch.equal(a, b)
    assert (tknn.knn3_mxu.launches, tknn.knn3_exact.launches) == before


def _jax_k(fn, q, qm, s, sm, k):
    out = fn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(s),
             jnp.asarray(sm), k=k, interpret=True)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_exact_ref_any_k_is_bit_exact(k):
    """The exact plain version for k ≠ 3 against `flash_knn(k=k)` in
    interpret mode, on the 2⁻⁸ grid (exact arithmetic): distances,
    indices and validity bit for bit, masked rows included."""
    rng = np.random.default_rng(10 + k)
    q = _cloud(rng, 300, 0, 1, 2.0 ** -8)
    s = _cloud(rng, 200, 0, 1, 2.0 ** -8)
    qm, sm = np.arange(300) < 280, np.arange(200) < 180
    dj, ij, vj = _jax_k(flash_knn, q, qm, s, sm, k)
    dt, it, vt = [o.numpy() for o in tknn.knn3_exact(
        torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(s),
        torch.from_numpy(sm), k=k)]
    assert dt.shape == (300, k)
    np.testing.assert_array_equal(dj.view(np.int32), dt.view(np.int32))
    np.testing.assert_array_equal(ij, it)
    np.testing.assert_array_equal(vj, vt)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_mxu_ref_any_k_meets_pallas_gates(k):
    """The mxu plain version for k ≠ 3 against `flash_knn(k=k)` (exact):
    recall ≥ 0.99, top-1 ≥ 0.99, |Δd²| < 2e-2 on matching neighbours, the
    masked supports never winning; and against `flash_knn_mxu(k=k)`
    (whose lane fold can lose a j-th neighbour) the same nearest one."""
    rng = np.random.default_rng(20 + k)
    q = _cloud(rng, 512, -4, 9)
    s = _cloud(rng, 700, -4, 9)
    qm, sm = np.ones(512, bool), np.ones(700, bool)
    sm[-7:] = False
    de, ie, ve = _jax_k(flash_knn, q, qm, s, sm, k)
    dm, im, vm = [o.numpy() for o in tknn.knn3_mxu(
        torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(s),
        torch.from_numpy(sm), k=k)]
    assert dm.shape == (512, k)
    np.testing.assert_array_equal(ve, vm)
    assert np.all(im < 700 - 7)
    recall = np.mean([len(set(ie[i]) & set(im[i])) / k for i in range(512)])
    assert recall >= 0.99, recall
    assert (ie[:, 0] == im[:, 0]).mean() >= 0.99
    assert np.abs(dm - de)[ie == im].max() < 2e-2
    _, ij, _ = _jax_k(flash_knn_mxu, q, qm, s, sm, k)
    assert (ij[:, 0] == im[:, 0]).mean() >= 0.99


def test_k_above_the_kernels_limit_raises():
    """The kernels take k ≤ MAX_K (128), the reference's bound (its
    kernels write or fold their winners into 128-lane rows); a longer
    list is refused with that limit named, on either device; the plain
    versions take it."""
    assert tknn.MAX_K == 128
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_cloud(rng, 40, 0, 1))
    s = torch.from_numpy(_cloud(rng, 200, 0, 1))
    qm, sm = torch.ones(40, dtype=torch.bool), torch.ones(200, dtype=torch.bool)
    for fn in (tknn.knn3_mxu, tknn.knn3_exact):
        with pytest.raises(ValueError, match="k <= 128.*128-lane"):
            fn(q, qm, s, sm, k=129)
        with pytest.raises(ValueError, match="k <= 128"):
            fn(q, qm, s, sm, k=0)
        assert fn(q, qm, s, sm, k=128)[1].shape == (40, 128)
    with pytest.raises(ValueError, match="MAX_K"):
        tknn.flash_three_nn(q[None], qm[None], s[None], sm[None], k=129)
    assert tknn.knn3_exact_ref(q, qm, s, sm, 150)[1].shape == (40, 150)
    assert tknn.knn3_mxu_ref(q, qm, s, sm, 150)[1].shape == (40, 150)


@pytest.fixture(scope="module")
def long_lists():
    """256 × 200 clouds on the 2⁻⁸ grid (exact arithmetic; the last 20
    supports masked) and the JAX kernels' answers at k = 128 in interpret
    mode. Both kernels emit their winners in order, one pass each, so the
    first k columns are their answers for k (the exact kernel's
    exclusion loop costs k² passes: one call serves every k)."""
    rng = np.random.default_rng(17)
    q = _cloud(rng, 256, 0, 1, 2.0 ** -8)
    s = _cloud(rng, 200, 0, 1, 2.0 ** -8)
    qm, sm = np.arange(256) < 240, np.arange(200) < 180
    return ((q, qm, s, sm), _jax_k(flash_knn, q, qm, s, sm, 128),
            _jax_k(flash_knn_mxu, q, qm, s, sm, 128))


def _port_k(fn, args, k):
    return [o.numpy() for o in fn(*map(torch.from_numpy, args), k=k)]


@pytest.mark.parametrize("k", [17, 32, 128])
def test_exact_ref_long_lists_are_bit_exact(long_lists, k):
    """The exact plain version for the list kernels' k (17..128) against
    `flash_knn(k=k)`: distances, indices and validity bit for bit."""
    args, (dj, ij, vj), _ = long_lists
    dt, it, vt = _port_k(tknn.knn3_exact, args, k)
    assert dt.shape == (256, k)
    np.testing.assert_array_equal(dj[:, :k].view(np.int32), dt.view(np.int32))
    np.testing.assert_array_equal(ij[:, :k], it)
    np.testing.assert_array_equal(vj[:, :k], vt)


@pytest.mark.parametrize("k", [17, 32, 128])
def test_mxu_ref_long_lists_meet_pallas_gates(long_lists, k):
    """The mxu plain version for the list kernels' k against
    `flash_knn(k=k)`: validity equal, recall ≥ 0.99, top-1 ≥ 0.99, |Δd²|
    < 2e-2 on matching neighbours, no masked support among the valid
    winners; and against `flash_knn_mxu(k=k)` (whose 128-lane fold loses
    a j-th neighbour to a nearer one in its lane) the same nearest one."""
    args, (de, ie, ve), (_, ij, _) = long_lists
    de, ie, ve, ij = de[:, :k], ie[:, :k], ve[:, :k], ij[:, :k]
    dm, im, vm = _port_k(tknn.knn3_mxu, args, k)
    assert dm.shape == (256, k)
    np.testing.assert_array_equal(ve, vm)
    assert np.all(im[vm] < 180)
    rows = np.flatnonzero(args[1])
    recall = np.mean([len(set(ie[i]) & set(im[i])) / k for i in rows])
    assert recall >= 0.99, recall
    assert (ie[rows, 0] == im[rows, 0]).mean() >= 0.99
    assert np.abs(dm - de)[(ie == im) & vm].max() < 2e-2
    assert (ij[rows, 0] == im[rows, 0]).mean() >= 0.99


def test_k_interp_4_pallas_forward_matches_jax():
    """synthetic_tiny_seg with k_interp=4 and method="pallas" in every
    decoder stage: the port's served forward (`flash_three_nn(k=4)`)
    against JAX's (the Pallas kernel in interpret mode): argmax alike
    everywhere and logits within 1e-3 of their range. Supports of ≤ 128
    points near the origin: the TPU kernel's lane fold cannot collide,
    so both pick the same 4 neighbours; the two split-bf16 products sum
    d² + 1 in another order (an f32 ulp of 1, 1.2e-7), which the weights
    1/(d² + 1e-8) amplify where a query lies near a support (ROADMAP §3,
    "the 3-NN weights amplify d²")."""
    import dataclasses

    import jax

    from gridgcn_tpu.configs import presets as jpresets
    from gridgcn_tpu.models.build import build_model as jbuild
    from gridgcn_torch.api import Predictor
    from gridgcn_torch.utils.convert import convert_flax_variables
    from tests.test_torch_models import _random_variables, to_port

    cfg = jpresets.get("synthetic_tiny_seg")
    ups = tuple(dataclasses.replace(u, method="pallas", k_interp=4)
                for u in cfg.model.up_layers)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, up_layers=ups))
    xyz = np.random.default_rng(2).uniform(-1, 1, (1, 256, 3)).astype(
        np.float32)
    mask = np.ones((1, 256), bool)
    model = jbuild(cfg.model)
    v = _random_variables(model, jnp.asarray(xyz), None, jnp.asarray(mask))
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.jit(lambda x, m: model.apply(
        v, x, None, m, rngs={"cagq": key}))(jnp.asarray(xyz),
                                            jnp.asarray(mask)))[0]
    model_cfg = dataclasses.replace(cfg.model, fold_bn=False)
    got = Predictor(to_port(dataclasses.replace(cfg, model=model_cfg)),
                    convert_flax_variables(v), device="cpu")(
        xyz[0], rng=np.asarray(key))
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.ptp(want))
