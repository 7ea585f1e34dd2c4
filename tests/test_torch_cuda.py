"""The flash-kNN CUDA kernels against their plain versions on the card,
and the plain-PyTorch modules of the port (samplers, dense 3-NN, the
classifier, jaxrng.normal, a training step) on CUDA against the same code
on the CPU.

Needs an NVIDIA GPU with nvcc: every test here is marked `cuda` and skips
without one. This file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels pick their tiling from Nq and the card's SM count: on a
132-SM H100, `knn3_mxu` splits the support axis over 1, 2 or 4 warps
above 67456, 33728 and below that many queries, and `knn3_exact` gives 4
queries 4, 8, 16 or 32 lanes above 134912, 67456, 33728 and below; the
cases below cover each.
"""

import numpy as np
import pytest
import torch

from gridgcn_torch.kernels import knn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, nq, ns, seed, quantum=None, ns_valid=None, lo=-4.0,
            hi=9.0, duplicate=False):
    """Uniform clouds in [lo, hi); the last tenth of the queries and the
    supports from ns_valid on (default ns - 7) are masked. quantum rounds
    the coordinates to its grid; duplicate makes the second half of the
    supports a shuffled copy of the first (exact ties)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(lo, hi, (nq, 3))
    s = rng.uniform(lo, hi, (ns, 3))
    if duplicate:
        s[ns // 2:] = s[rng.integers(0, ns // 2, ns - ns // 2)]
    if quantum:
        q = np.minimum(np.floor(q / quantum) * quantum, hi - quantum)
        s = np.minimum(np.floor(s / quantum) * quantum, hi - quantum)
    qm = np.ones(nq, bool)
    qm[nq - nq // 10:] = False
    sm = np.arange(ns) < (ns - 7 if ns_valid is None else ns_valid)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    return (t(q, torch.float32), t(qm, torch.bool), t(s, torch.float32),
            t(sm, torch.bool))


def _bit_equal(out, ref):
    d, i, v = out
    dr, ir, vr = ref
    assert torch.equal(d.view(torch.int32), dr.view(torch.int32))
    assert torch.equal(i, ir.int()) and torch.equal(v, vr)


# the grid case: on 2^-6 in [0, 1) with every support valid, every sum of
# either kernel is exact, so both equal their plain versions bit for bit
GRID = dict(quantum=2.0 ** -6, lo=0.0, hi=1.0, ns_valid=10 ** 9)


@pytest.mark.parametrize("nq,ns,kw", [
    (1000, 700, {}), (4096, 2048, dict(quantum=2.0 ** -6)),
    (300, 200, dict(ns_valid=2)), (37, 5, {}), (5000, 1300, {}),
    (4096, 2048, GRID), (3000, 900, dict(GRID, duplicate=True)),
    (40000, 300, {}), (70000, 300, {}), (140000, 200, {}),
    (2500, 4500, {})])
def test_exact_kernel_bit_exact(cuda, nq, ns, kw):
    args = _inputs(cuda, nq, ns, nq + ns, **kw)
    n0 = knn.knn3_exact.launches
    out = knn.knn3_exact(*args)
    torch.cuda.synchronize()
    assert knn.knn3_exact.launches == n0 + 1
    _bit_equal(out, knn.knn3_exact_ref(*args))


@pytest.mark.parametrize("nq,ns,kw", [
    (4096, 2048, GRID), (3000, 900, dict(GRID, duplicate=True)),
    (1001, 5, GRID)])
def test_mxu_kernel_bit_exact_on_exact_arithmetic(cuda, nq, ns, kw):
    """Centered on the supports, every coordinate is a multiple of 2⁻⁷
    below 1 in magnitude, so its bf16 split is exact, and every product
    and partial sum of the 16 terms is a multiple of 2⁻¹⁴ below 16, which
    f32 holds exactly: the tensor cores' summation order cannot matter,
    and the many exact ties are resolved by the merge alone."""
    args = _inputs(cuda, nq, ns, 3 * nq + ns, **kw)
    n0 = (knn.knn3_mxu.launches, knn.mxu_pack_support.launches)
    out = knn.knn3_mxu(*args)
    torch.cuda.synchronize()
    assert (knn.knn3_mxu.launches, knn.mxu_pack_support.launches) == \
        (n0[0] + 1, n0[1] + 1)
    _bit_equal(out, knn.knn3_mxu_ref(*args))


@pytest.mark.parametrize("nq,ns,kw", [
    (1000, 700, {}), (8192, 2048, {}), (37, 5, dict(ns_valid=3)),
    (5000, 1300, {}),
    (300, 200, dict(ns_valid=2)), (3000, 900, dict(duplicate=True)),
    (40000, 300, {}), (70000, 300, {}), (140000, 200, {})])
def test_mxu_kernel_matches_plain_version(cuda, nq, ns, kw):
    """Same packing; only the f32 summation of the 16 products differs
    (tensor cores against the plain version's matmul)."""
    args = _inputs(cuda, nq, ns, nq - ns, **kw)
    d, i, v = knn.knn3_mxu(*args)
    torch.cuda.synchronize()
    dr, ir, vr = knn.knn3_mxu_ref(*args)
    assert torch.equal(v, vr)
    same = (i == ir.int()) & v
    assert same.float().sum() >= 0.999 * v.float().sum()
    assert (d - dr).abs()[same].max() <= 1e-3
    if kw.get("ns_valid") == 2:
        assert v[:, :2].any() and not v[:, 2:].any()


@pytest.mark.parametrize("ns,ns_valid", [(1, 1), (129, 100), (700, 693),
                                         (8192, 8000), (300, 0)])
def test_pack_kernel_bit_exact(cuda, ns, ns_valid):
    _, _, s, sm = _inputs(cuda, 1, ns, ns, ns_valid=ns_valid)
    n0 = knn.mxu_pack_support.launches
    buf = knn.mxu_pack_support(s, sm)
    torch.cuda.synchronize()
    assert knn.mxu_pack_support.launches == n0 + 1
    assert torch.equal(buf, knn.mxu_pack_support_ref(s, sm))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, qm, s, sm = _inputs(cuda, 64, 64, 0)
    with pytest.raises(ValueError):
        knn.knn3_mxu(q.double(), qm, s, sm)
    with pytest.raises(ValueError):
        knn.knn3_exact(q.t().contiguous().t(), qm, s, sm)
    with pytest.raises(ValueError):
        knn.knn3_mxu(q, qm, s.cpu(), sm)
    with pytest.raises(ValueError):
        knn.knn3_exact(q, qm, s[:0], sm[:0])
    with pytest.raises(ValueError):
        knn.mxu_pack_support(s, sm.int())


# ---- plain-PyTorch modules: CUDA against the CPU ----

def _cloud_table(dev, seed, n_valid=1500):
    """The packed voxel table (resolution 16, nv 8) of two clouds of 2000
    points of which the first n_valid are valid, on `dev`."""
    from gridgcn_torch.ops import voxelize
    from gridgcn_torch.utils import jaxrng

    rng = np.random.default_rng(seed)
    xyz = torch.as_tensor(rng.uniform(-1, 1, (2, 2000, 3)),
                          dtype=torch.float32)
    mask = torch.arange(2000)[None].repeat(2, 1) < n_valid
    return voxelize.build_voxel_table(
        xyz.to(dev), mask.to(dev), 16, 8, jaxrng.PRNGKey(seed),
        with_keys=True, with_slots=False, with_coverage=False)


@pytest.mark.parametrize("sampler,approx,iters", [
    ("rvs", False, 0), ("cas", False, 3), ("cas", True, 2)])
def test_samplers_on_cuda_equal_the_cpu(cuda, sampler, approx, iters):
    """Exact RVS and CAS indices on CUDA equal the CPU's for the same key:
    every draw (threefry, the Cephes log of the Gumbel draws) and every
    comparison is the same sequence of IEEE operations on both."""
    from gridgcn_torch.ops import sampling
    from gridgcn_torch.utils import jaxrng

    for seed, n_valid in ((0, 1500), (1, 60)):
        out = []
        for dev in ("cpu", cuda):
            table = _cloud_table(dev, seed, n_valid)
            key = jaxrng.PRNGKey(100 + seed)
            if sampler == "rvs":
                out.append(sampling.sample_centers_rvs(table, 512, key))
            else:
                out.append(sampling.sample_centers_cas(
                    table, 512, key, cas_iters=iters, approx=approx))
        assert torch.equal(out[0][0], out[1][0].cpu())
        assert torch.equal(out[0][1], out[1][1].cpu())


@pytest.mark.parametrize("approx", [False, True])
def test_dense_three_nn_on_cuda_matches_the_cpu(cuda, approx):
    """Indices equal except where the two devices' matmuls round a near tie
    the other way (compared by float64 distance); weights within 1e-5, or
    the bf16 spacing for approx."""
    from gridgcn_torch.ops.upsample import dense_three_nn

    rng = np.random.default_rng(2)
    q = torch.as_tensor(rng.uniform(-1, 1, (2, 3000, 3)), dtype=torch.float32)
    s = torch.as_tensor(rng.uniform(-1, 1, (2, 700, 3)), dtype=torch.float32)
    qm = torch.ones((2, 3000), dtype=torch.bool)
    sm = torch.arange(700)[None].repeat(2, 1) < 690
    want = dense_three_nn(q, qm, s, sm, block=256, approx=approx)
    got = [t.cpu() for t in dense_three_nn(q.to(cuda), qm.to(cuda),
                                           s.to(cuda), sm.to(cuda),
                                           block=256, approx=approx)]
    assert torch.equal(want[2], got[2])
    b = torch.arange(2)[:, None, None]

    def dist(idx):
        return ((q[:, :, None].double() - s[b, idx].double()) ** 2).sum(-1)

    differ = want[0] != got[0]
    rel = 2.0 ** -7 if approx else 1e-5
    near = (dist(want[0]) - dist(got[0])).abs() <= rel * dist(want[0])
    assert not (differ & ~near).any()
    assert differ.float().mean() <= 0.01
    same_row = ~differ.any(-1, keepdim=True)
    tol = 1e-2 if approx else 1e-5
    assert ((want[1] - got[1]).abs() * same_row).max() <= tol


def test_classifier_on_cuda_matches_the_cpu(cuda):
    """synthetic_tiny and a narrow modelnet40_cas served in f32: logits
    within 1e-4 of the logit range, every cloud's class the same."""
    import dataclasses

    from gridgcn_torch.api import Predictor
    from gridgcn_torch.configs import presets
    from gridgcn_torch.models.build import init_model
    from gridgcn_torch.utils import jaxrng

    for name in ("synthetic_tiny", "modelnet40_cas"):
        cfg = presets.get(name)
        layers = tuple(dataclasses.replace(l, mlp=(16, 32)) for l in
                       cfg.model.layers)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, layers=layers, eval_dtype=""))
        _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
        N = cfg.data.num_points
        xyz = np.random.default_rng(3).uniform(-1, 1, (4, N, 3))
        key = jaxrng.PRNGKey(4)
        a = Predictor(cfg, sd, device="cpu")(xyz, rng=key)
        b = Predictor(cfg, sd, device="cuda")(xyz, rng=key)
        assert b.shape == (4, cfg.model.num_classes)
        assert (a.argmax(-1) == b.argmax(-1)).all()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-4 * np.abs(a).max())


def test_normal_draws_on_cuda_equal_the_cpu(cuda):
    """jaxrng.normal (XLA's erf⁻¹, log1p and Cephes log repeated op by op)
    gives the same bits on the card as on the CPU."""
    from gridgcn_torch.utils import jaxrng, xla_math

    key = jaxrng.fold_in(jaxrng.PRNGKey(3), 5)
    a = jaxrng.normal(key, (1_000_000,))
    b = jaxrng.normal(key, (1_000_000,), cuda).cpu()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    x = torch.linspace(-1, 1, 200_001)
    assert torch.equal(xla_math.erf_inv(x).view(torch.int32),
                       xla_math.erf_inv(x.to(cuda)).cpu().view(torch.int32))


def test_seg_train_step_on_cuda_matches_the_cpu(cuda):
    """One synthetic_tiny_seg step with method="pallas" (knn3_mxu on the
    card, its plain version on the CPU), f32, from the same weights and
    key, measured as chip_smoke.train_gaps measures it. With the CPU's
    CAGQ groups and decoder 3-NN outputs pinned, the card's step against
    the same step in float64 (chip_smoke.float64_gradients): loss and
    gradient norm within 1e-5 relative, gradients 1e-4; its statistics
    and determined parameters within 1e-5 of the CPU's. As trained,
    knn3_mxu's distances differ from its plain version's by a few ulps of
    1, which the weights 1/(d² + 1e-8) of a query that coincides with a
    support amplify (H100: gradient norm 7.95e-4 relative, gradients
    1.29e-2): gated at 3e-3 and 3e-2, at most 70% of the elements
    undetermined."""
    import dataclasses

    import chip_smoke
    from gridgcn_torch.configs import presets
    from gridgcn_torch.models.build import build_model, init_model
    from gridgcn_torch.train import steps
    from gridgcn_torch.utils import jaxrng

    cfg = presets.get("synthetic_tiny_seg")
    ups = tuple(dataclasses.replace(u, method="pallas")
                for u in cfg.model.up_layers)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, up_layers=ups))
    rng = np.random.default_rng(0)
    batch = {"xyz": rng.uniform(-1, 1, (4, 256, 3)).astype(np.float32),
             "mask": np.ones((4, 256), bool),
             "label": rng.integers(0, 4, (4, 256))}
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    key = jaxrng.PRNGKey(1)

    def run(dev, **pins):
        return chip_smoke.one_train_step(
            torch, steps, cfg, build_model(cfg.model), sd, batch, key, dev,
            **pins)

    cpu = run("cpu")
    exact = chip_smoke.float64_gradients(
        torch, steps, jaxrng, cfg, build_model(cfg.model), sd, batch, key,
        cpu)
    n0 = knn.knn3_mxu.launches
    card = run("cuda")
    assert knn.knn3_mxu.launches - n0 == 4 * 2
    pinned = run("cuda", pin_cagq=cpu["cagq"], pin_three_nn=cpu["three_nn"])
    assert card["metrics"]["acc"] == pytest.approx(cpu["metrics"]["acc"],
                                                   rel=1e-5)
    ge = chip_smoke.train_gaps(torch, steps, cfg, pinned, cpu, exact)
    ga = chip_smoke.train_gaps(torch, steps, cfg, card, cpu)
    print(chip_smoke.train_gap_line(ge))
    print(chip_smoke.train_gap_line(ga))
    for g in (ge, ga):
        assert g["loss"] <= 1e-5 and g["noise"] <= 2e-4, g
        assert g["param"] <= 1e-5 and g["stat"] <= 1e-5, g
        assert g["lr_moves"] <= 2, g
    assert ge["grad_norm"] <= 1e-5 and ge["grad"] <= 1e-4, ge
    assert ga["grad_norm"] <= 3e-3 and ga["grad"] <= 3e-2, ga
    assert ga["undetermined"] <= 0.7, ga


@pytest.mark.parametrize("k", [1, 2, 5, 8, 16])
@pytest.mark.parametrize("nq", [1000, 70000])
def test_kernels_at_other_list_lengths(cuda, k, nq):
    """Each list length has a build of its own (`-DKNN_K=k`): knn3_exact
    bit for bit its plain version, knn3_mxu the same validity and, where
    its neighbours agree with the plain version's, d² within 1e-3; both
    tilings of each kernel (few and many queries)."""
    args = _inputs(cuda, nq, 3000, 40 + k)
    _bit_equal(knn.knn3_exact(*args, k=k), knn.knn3_exact_ref(*args, k=k))
    dm, im, vm = knn.knn3_mxu(*args, k=k)
    dr, ir, vr = knn.knn3_mxu_ref(*args, k=k)
    assert dm.shape == (nq, k) and torch.equal(vm, vr)
    same = (im == ir) & vm
    assert same.sum() >= 0.999 * vm.sum()
    assert (dm - dr).abs()[same].max() <= 1e-3


@pytest.mark.parametrize("k", [17, 32, 100, 128])
@pytest.mark.parametrize("nq,ns,kw", [
    (300, 3000, {}), (1000, 3000, {}), (70000, 3000, {}),
    (300, 2048, GRID), (70000, 2048, GRID), (300, 200, dict(ns_valid=2))])
def test_list_kernels_for_long_lists(cuda, k, nq, ns, kw):
    """17 ≤ k ≤ 128 take the list kernels (one build, `-DKNN_K=0`, each
    list a warp queue in registers): knn3_exact bit for bit its plain
    version, knn3_mxu the same validity and, where its neighbours agree
    with the plain version's, d² within 1e-3; on the grid (exact sums,
    ties everywhere) knn3_mxu bit for bit its plain version too. k = 17
    and 100 are not multiples of 32; 2 valid supports of 200 leave k - 2
    masked or padded entries that only the column orders; 300 and 70000
    queries give a few blocks and many; k = 129 refused."""
    args = _inputs(cuda, nq, ns, 60 + k + nq, **kw)
    n0 = (knn.knn3_exact.launches, knn.knn3_mxu.launches)
    _bit_equal(knn.knn3_exact(*args, k=k), knn.knn3_exact_ref(*args, k=k))
    dm, im, vm = knn.knn3_mxu(*args, k=k)
    dr, ir, vr = knn.knn3_mxu_ref(*args, k=k)
    torch.cuda.synchronize()
    assert (knn.knn3_exact.launches, knn.knn3_mxu.launches) == \
        (n0[0] + 1, n0[1] + 1)
    assert dm.shape == (nq, k) and torch.equal(vm, vr)
    if kw is GRID:
        _bit_equal((dm, im, vm), (dr, ir, vr))
    same = (im == ir) & vm
    assert same.sum() >= 0.999 * vm.sum()
    assert (dm - dr).abs()[same].max() <= 1e-3
    with pytest.raises(ValueError, match="128-lane"):
        knn.knn3_exact(*args, k=129)


@pytest.mark.parametrize("flag", ["coord_match", "coord_payload"])
def test_coord_gathers_on_cuda_equal_the_packed_path(cuda, flag):
    """CAGQ with the combined selection table (coord_match, coord_payload)
    on the card: every GroupedNodes field bit for bit the default packed
    path's on the card, and every index field and node_xyz bit for bit
    the CPU's (the barycenters within 1e-5: f32 prefix sums in another
    order)."""
    import dataclasses

    from gridgcn_torch.configs import presets
    from gridgcn_torch.data.synthetic import synthetic_scene_surface
    from gridgcn_torch.ops.cagq import cagq
    from gridgcn_torch.utils import jaxrng

    spec = presets.scannet_whole_scene().model.layers[0]
    flagged = dataclasses.replace(spec, **{flag: True})
    xyz = torch.as_tensor(synthetic_scene_surface(16384, seed=5))[None]
    mask = torch.ones((1, 16384), dtype=torch.bool)
    key = jaxrng.PRNGKey(3)
    base = cagq(xyz.to(cuda), mask.to(cuda), spec, key).groups
    got = cagq(xyz.to(cuda), mask.to(cuda), flagged, key).groups
    cpu = cagq(xyz, mask, flagged, key).groups
    for f in dataclasses.fields(got):
        a, b, c = (getattr(g, f.name) for g in (got, base, cpu))
        if not torch.is_tensor(a):
            continue
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f.name
        if f.name == "center_xyz":
            assert (getattr(got, f.name).cpu() - c).abs().max() <= 1e-5
        else:
            assert torch.equal(a.cpu(), c.view(torch.int32)
                               if c.dtype == torch.float32 else c), f.name
