"""The flash-kNN CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU with nvcc: every test here is marked `cuda` and skips
without one. This file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
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


def _inputs(dev, nq, ns, seed, quantum=None, ns_valid=None):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-4, 9, (nq, 3))
    s = rng.uniform(-4, 9, (ns, 3))
    if quantum:
        q, s = np.round(q / quantum) * quantum, np.round(s / quantum) * quantum
    qm = np.ones(nq, bool)
    qm[nq - nq // 10:] = False
    sm = np.arange(ns) < (ns - 7 if ns_valid is None else ns_valid)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    return (t(q, torch.float32), t(qm, torch.bool), t(s, torch.float32),
            t(sm, torch.bool))


@pytest.mark.parametrize("nq,ns,quantum,ns_valid", [
    (1000, 700, None, None), (4096, 2048, 2.0 ** -6, None),
    (300, 200, None, 2)])
def test_exact_kernel_bit_exact(cuda, nq, ns, quantum, ns_valid):
    args = _inputs(cuda, nq, ns, nq + ns, quantum, ns_valid)
    n0 = knn.knn3_exact.launches
    d, i, v = knn.knn3_exact(*args)
    torch.cuda.synchronize()
    assert knn.knn3_exact.launches == n0 + 1
    dr, ir, vr = knn.knn3_exact_ref(*args)
    assert torch.equal(d.view(torch.int32), dr.view(torch.int32))
    assert torch.equal(i, ir) and torch.equal(v, vr)


@pytest.mark.parametrize("nq,ns", [(1000, 700), (8192, 2048)])
def test_mxu_kernel_matches_plain_version(cuda, nq, ns):
    """Same packing; only the f32 order of the 16-term sum differs."""
    args = _inputs(cuda, nq, ns, nq - ns)
    d, i, v = knn.knn3_mxu(*args)
    torch.cuda.synchronize()
    dr, ir, vr = knn.knn3_mxu_ref(*args)
    assert torch.equal(v, vr)
    same = (i == ir.int()) & v
    assert same.float().sum() >= 0.999 * v.float().sum()
    assert (d - dr).abs()[same].max() <= 1e-3


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, qm, s, sm = _inputs(cuda, 64, 64, 0)
    with pytest.raises(ValueError):
        knn.knn3_mxu(q.double(), qm, s, sm)
    with pytest.raises(ValueError):
        knn.knn3_exact(q.t().contiguous().t(), qm, s, sm)
    with pytest.raises(ValueError):
        knn.knn3_mxu(q, qm, s.cpu(), sm)
