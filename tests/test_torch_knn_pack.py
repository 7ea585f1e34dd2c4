"""The layouts `csrc/knn.cu` shares with its wrappers, on the CPU: the
support operand that `knn3_mxu`'s pack kernel writes (its plain version
against `mxu_pack` and `mxu_center`) and the one buffer that holds a call's
outputs. The kernels themselves are held against these on the card
(test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from gridgcn_torch.kernels import knn

torch.set_num_threads(1)


def _supports(ns, n_masked, seed):
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.uniform(-4, 9, (ns, 3)).astype(np.float32))
    sm = torch.ones(ns, dtype=torch.bool)
    sm[rng.permutation(ns)[:n_masked]] = False
    return s, sm


@pytest.mark.parametrize("ns,n_masked", [(1, 0), (1, 1), (129, 9),
                                         (700, 7)])
def test_pack_ref_is_mxu_pack_in_visit_and_fragment_order(ns, n_masked):
    """Put back in column order and un-permuted, the packed columns are
    `mxu_pack`'s support operand for the supports moved by `mxu_center`
    (padded columns included), and the 16 bytes after them hold that
    center, bit for bit."""
    s, sm = _supports(ns, n_masked, ns + n_masked)
    buf = knn.mxu_pack_support_ref(s, sm)
    ns_pad = -(-ns // 128) * 128
    n = ns_pad // 8
    assert buf.dtype == torch.uint8 and buf.shape == (ns_pad * 32 + 16,)
    packed = buf[:ns_pad * 32].view(torch.bfloat16).view(n, 8, 16)
    cols = torch.empty_like(packed)
    cols[torch.arange(n) * knn.visit_step(n) % n] = packed
    unpermuted = torch.empty_like(cols)
    unpermuted[..., list(knn.PACK_ORDER)] = cols
    c = knn.mxu_center(s, sm)
    _, sb, pad = knn.mxu_pack(torch.zeros((0, 3)), s - c, sm)
    assert pad == ns_pad
    assert torch.equal(unpermuted.reshape(ns_pad, 16).T.view(torch.int16),
                       sb.view(torch.int16))
    center = buf[ns_pad * 32:].view(torch.float32)
    assert torch.equal(center[:3].view(torch.int32), c.view(torch.int32))
    assert center[3].item() == 0.0
    if n_masked == ns:
        assert torch.equal(c, torch.zeros(3))


@pytest.mark.parametrize("n", [16, 32, 48, 96, 176, 1024, 8 * 1024])
def test_visit_order_is_a_bijection_that_spreads(n):
    """p -> p * visit_step(n) mod n visits every column (or tile) once,
    and consecutive visits land at least n/4 apart (for n >= 16)."""
    step = knn.visit_step(n)
    order = np.arange(n) * step % n
    assert step % 2 == 1 and sorted(order) == list(range(n))
    gap = np.abs(np.diff(order))
    assert np.minimum(gap, n - gap).min() >= n // 4


def test_pack_order_is_the_mma_b_fragment():
    """Lane t of an mma.m16n8k16 quad holds K = 2t, 2t+1 (b0) and 2t+8,
    2t+9 (b1): positions 4t..4t+3 of the packed column."""
    assert sorted(knn.PACK_ORDER) == list(range(16))
    for t in range(4):
        assert knn.PACK_ORDER[4 * t:4 * t + 4] == (2 * t, 2 * t + 1,
                                                   2 * t + 8, 2 * t + 9)


def test_pack_wrapper_takes_the_plain_version_on_cpu():
    s, sm = _supports(300, 5, 1)
    n0 = knn.mxu_pack_support.launches
    assert torch.equal(knn.mxu_pack_support(s, sm),
                       knn.mxu_pack_support_ref(s, sm))
    assert knn.mxu_pack_support.launches == n0


@pytest.mark.parametrize("scratch,nq", [(0, 0), (0, 5), (128 * 32 + 16, 7),
                                        (256 * 32 + 16, 1000)])
def test_outputs_lay_out_as_the_kernels_write_them(scratch, nq):
    """d2 f32 [nq, 3], idx int32 [nq, 3] and valid bool [nq, 3] are each a
    contiguous tensor of its own (a custom op's outputs may not share
    storage); the mxu call's packed supports (`scratch` bytes: 32 per
    padded column, then the center) are a fourth, 16-byte aligned."""
    d, i, v = knn._outputs(nq, torch.zeros(2))
    assert (d.dtype, i.dtype, v.dtype) == (
        torch.float32, torch.int32, torch.bool)
    assert d.shape == i.shape == v.shape == (nq, 3)
    assert d.is_contiguous() and i.is_contiguous() and v.is_contiguous()
    storages = {t.untyped_storage().data_ptr() for t in (d, i, v)}
    assert len(storages) == 3 or nq == 0
    if scratch:
        assert knn._pack_bytes((scratch - 16) // 32) == scratch
        assert scratch % 16 == 0
    d.fill_(1.5)
    i.fill_(-2)
    v.fill_(True)
    assert (d == 1.5).all() and (i == -2).all() and v.all()
