"""The draws' CUDA kernel (`csrc/rng.cu` through `kernels.rng`) against its
plain version, the same draw on the CPU, bit for bit: `bits`, `uniform`
(default and three ranges), `gumbel`, `normal`, `bernoulli` and
`permutation`, under one numpy key, [B, 2] numpy keys (B = 1, 8 and 17,
copied to the card at each draw), tensor keys on the card and `row0`, at
1 to 2^20 + 3 values a row; and one launch a draw.

Needs an NVIDIA GPU with nvcc: every test here is marked `cuda` and skips
without one. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_rng_cuda.py
"""

import numpy as np
import pytest
import torch

from gridgcn_torch.utils import jaxrng

pytestmark = pytest.mark.cuda

BIG = 2 ** 20 + 3
# (key kind, values a row): kinds "one" (a numpy key [2]), "b<B>" (numpy
# [B, 2] keys), "tensor" (a key [2] on the card), "tensor_b3" ([3, 2] on
# the card)
CASES = [("one", 1), ("one", 7), ("one", 81920), ("one", BIG),
         ("b1", 1), ("b1", 7), ("b1", 81920), ("b1", BIG),
         ("b8", 7), ("b8", 81920), ("b8", BIG),
         ("b17", 1), ("b17", 7), ("b17", 81920),
         ("tensor", 7), ("tensor", 81920), ("tensor", BIG),
         ("tensor_b3", 7), ("tensor_b3", 81920)]
DRAWS = {"bits": jaxrng.bits, "uniform": jaxrng.uniform,
         "gumbel": jaxrng.gumbel}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _key(kind: str, dev):
    """(the key as the card's draw takes it, the same key for the CPU)."""
    base = jaxrng.fold_in(jaxrng.PRNGKey(2 ** 31 + 12345), 77)
    if kind == "one":
        return base, base
    if kind.startswith("b"):
        k = jaxrng.split(base, int(kind[1:]))
        return k, k
    k = base if kind == "tensor" else jaxrng.split(base, 3)
    return jaxrng.key_tensor(k, dev), k


def _same(got: torch.Tensor, want: torch.Tensor):
    assert got.is_cuda and got.dtype == want.dtype
    assert got.shape == want.shape
    got = got.cpu()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert int((got != want).sum()) == 0


def _launched(fn):
    """fn()'s result and the kernel launches it made, by epilogue."""
    before = dict(jaxrng.launches)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in jaxrng.launches.items()
                 if v != before[k]}


@pytest.mark.parametrize("kind,n", CASES)
@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draw_bit_exact(cuda, name, kind, n):
    fn = DRAWS[name]
    key, host = _key(kind, cuda)
    got, launched = _launched(lambda: fn(key, (n,), cuda))
    assert launched == {name: 1}
    _same(got, fn(host, (n,)))


@pytest.mark.parametrize("kind", ["one", "b8", "b17", "tensor"])
@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (0.3, 1.7), (-5.0, 2.5)])
def test_uniform_range_bit_exact(cuda, kind, lo, hi):
    key, host = _key(kind, cuda)
    got, launched = _launched(
        lambda: jaxrng.uniform(key, (3, 5000), cuda, lo, hi))
    assert launched == {"uniform": 1}
    _same(got, jaxrng.uniform(host, (3, 5000), "cpu", lo, hi))


@pytest.mark.parametrize("kind", ["one", "b8", "tensor"])
def test_normal_and_bernoulli_bit_exact(cuda, kind):
    """Both finish a `uniform` launch in torch (erf⁻¹, a compare)."""
    key, host = _key(kind, cuda)
    got, launched = _launched(lambda: jaxrng.normal(key, (81920,), cuda))
    assert launched == {"uniform": 1}
    _same(got, jaxrng.normal(host, (81920,)))
    got, launched = _launched(
        lambda: jaxrng.bernoulli(key, 0.3, (3, 777), cuda))
    assert launched == {"uniform": 1}
    _same(got, jaxrng.bernoulli(host, 0.3, (3, 777)))


@pytest.mark.parametrize("kind", ["one", "b8", "b17", "tensor_b3"])
@pytest.mark.parametrize("n", [1, 7, 2048, 5000])
def test_permutation_bit_exact(cuda, kind, n):
    """One `bits` launch a round: none for n = 1, one round up to
    n = 1625, two above."""
    key, host = _key(kind, cuda)
    got, launched = _launched(lambda: jaxrng.permutation(key, n, cuda))
    assert launched == ({} if n == 1 else {"bits": 1 if n <= 1625 else 2})
    _same(got, jaxrng.permutation(host, n))


@pytest.mark.parametrize("kind", ["one", "tensor"])
def test_row0_bit_exact(cuda, kind):
    """Rows [row0, row0 + 3) of a larger draw: the counters' offset."""
    key, host = _key(kind, cuda)
    for fn in (jaxrng.bits, jaxrng.uniform, jaxrng.normal):
        got = fn(key, (3, 81920), cuda, row0=5)
        _same(got, fn(host, (3, 81920), row0=5))
        _same(got, fn(host, (8, 81920))[5:])
    _same(jaxrng.bernoulli(key, 0.5, (3, 100), cuda, row0=2),
          jaxrng.bernoulli(host, 0.5, (5, 100))[2:])


def test_draw_on_the_current_stream(cuda):
    """The kernel runs on the caller's stream: a draw enqueued on a side
    stream behind a long kernel reads right once that stream is done."""
    key = jaxrng.PRNGKey(5)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        big = torch.randn(4096, 4096, device=cuda)
        for _ in range(4):
            big = big @ big.T / 4096.0
        got = jaxrng.gumbel(key, (BIG,), cuda)
    side.synchronize()
    _same(got, jaxrng.gumbel(key, (BIG,)))


def test_numpy_keys_copied_while_the_card_is_busy(cuda):
    """A numpy key's page-locked copy is not reused before the card has
    read it: 64 draws under distinct keys (one key, and strided [B, 2]
    views) enqueued behind a ~0.5 s spin each read their own key."""
    keys = jaxrng.split(jaxrng.PRNGKey(9), 128)
    torch.cuda._sleep(1_000_000_000)
    got = [jaxrng.uniform(keys[i], (1000,), cuda) if i % 2 else
           jaxrng.bits(keys[i:i + 6:2], (1000,), cuda) for i in range(64)]
    for i, g in enumerate(got):
        _same(g, jaxrng.uniform(keys[i], (1000,)) if i % 2 else
              jaxrng.bits(keys[i:i + 6:2], (1000,)))


def test_launch_refuses_bad_keys(cuda):
    with pytest.raises(ValueError):
        torch.ops.gridgcn.rng_draw_keys(
            torch.zeros((2, 3), dtype=torch.int64, device=cuda), [2, 4], 0,
            "bits", 0.0, 1.0)
