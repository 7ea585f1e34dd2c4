"""JAX's threefry2x32 PRNG in numpy and torch, bit for bit.

CAGQ's outputs are indices drawn from randomness that the JAX functions make
inside themselves (`jax.random.bits`, `uniform`, `split`, `fold_in`). The
port reproduces JAX's generator exactly (`threefry2x32` in its partitionable
mode, `jax_threefry_partitionable=True`), so the same key gives the same
indices in both packages.

A key is what JAX calls its raw key data: a numpy uint32 array of shape
(2,), or the same two words in an int64 tensor. Key derivation (`PRNGKey`,
`split`, `fold_in`, `flax_make_rng`) runs on the host in numpy for a numpy
key and on the key's device in torch for a tensor key, so that a traced
program (`torch.export`) takes its key as an input instead of freezing the
tracing key into a constant; the two paths give the same words. Draws
(`bits`, `uniform`, `normal`, `bernoulli`, `gumbel`, `permutation`) run on
the tensor's device in torch int64 arithmetic masked to 32 bits (uint32 ops
are only partly supported on CUDA). A draw also takes a [B, 2] array of
keys and makes the B draws in one pass, [B, *shape]: the hash is
elementwise, so each row equals the draw under its own key.

Every draw is a hash of its flat row-major counter (the partitionable
mode), so the rows [row0, row0 + B) of a draw at a larger batch are the
hash of their own counters: `bits(..., row0=)` and `split(..., start=)`
make one data-parallel rank's rows of the global batch's draws exactly,
as the JAX package's GSPMD program draws them once for the whole batch.

`gumbel`, `normal` and `uniform` need XLA:CPU's float32 log, erf⁻¹ and
fused multiply-adds bit for bit: `utils.xla_math` repeats them.

Each draw on a device, and each key derivation from a tensor key, is
one span `jaxrng` in a profiler's trace (`utils.profiling.annotate`);
the numpy path runs on the host and has none.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from gridgcn_torch.utils import xla_math
from gridgcn_torch.utils.profiling import annotate

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counter pairs (x0, x1) under key (k0, k1):
    20 rounds, key injection every 4. Works on numpy uint32 arrays and on
    torch int64 tensors holding values below 2³² (every add and left shift
    is masked back to 32 bits). The key words are ints, or int64 tensors
    that broadcast against the counters."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & _M32)) & _M32
    return x0, x1


def _key_hash(key, lo):
    """The hash of counters (0, lo) under one key [2] or under each of
    [B, 2] keys (→ a leading B axis), stacked into key pairs [..., n, 2]:
    numpy uint32 for a numpy key, int64 on the key's device for a tensor
    key. `lo` is a sequence of ints."""
    if isinstance(key, torch.Tensor):
        with annotate("jaxrng"):
            k = key.long()
            x1 = torch.tensor(lo, dtype=torch.int64, device=k.device)
            b0, b1 = _threefry2x32(k[..., 0:1], k[..., 1:2],
                                   torch.zeros_like(x1), x1)
            return torch.stack([b0, b1], dim=-1)
    key = np.asarray(key, np.uint32)
    x1 = np.asarray(lo, np.uint32)
    b0, b1 = _threefry2x32(key[..., 0:1], key[..., 1:2],
                           np.zeros_like(x1), x1)
    return np.stack([b0, b1], axis=-1).astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: key data [0, seed]."""
    return np.array([0, int(seed) & _M32], np.uint32)


def key_tensor(key, device="cpu") -> torch.Tensor:
    """A numpy key (or [B, 2] keys) as the int64 tensor the tensor path
    takes, on `device`."""
    return torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64),
                           device=device)


def split(key, num: int = 2, start: int = 0):
    """`jax.random.split(key, start + num)[start:]` → [num, 2] keys; [B, 2]
    keys → [B, num, 2], each row the split of its key, in one pass. The
    split of a key is the hash of the counters 0, 1, ..., so `start`
    selects the keys of rows [start, start + num) of a larger split."""
    return _key_hash(key, range(start, start + num))


def fold_in(key, data: int):
    """`jax.random.fold_in(key, data)` for a uint32 `data`."""
    return _key_hash(key, [int(data) & _M32])[..., 0, :]


def flax_make_rng(key, path: tuple, counter: int):
    """The key that flax's `self.make_rng(name)` returns in the module at
    `path` (its names from the root, e.g. ("gridconv0",)) on its
    `counter`-th call, when `apply` was given `key` for that name: a
    `fold_in` of the first 4 bytes of SHA-1 over the names and the counter
    (flax 0.12 `core/scope.py` `_fold_in_static` and `make_rng`). The
    digest is static: a tensor key stays a tensor."""
    m = hashlib.sha1()
    for x in (*path, counter):
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def _key_words(key, device):
    """(k0, k1) of one key as ints (a numpy key) or 0-d int64 tensors (a
    tensor key), or of [B, 2] keys as int64 tensors [B, 1], on `device`;
    and the batch prefix of the draw shape."""
    if isinstance(key, torch.Tensor):
        k = key.long().to(device)
    else:
        key = np.asarray(key)
        if key.ndim == 1:
            return int(key[0]), int(key[1]), ()
        k = torch.as_tensor(key.astype(np.int64), device=device)
    if k.dim() == 1:
        return k[0], k[1], ()
    return k[:, 0:1], k[:, 1:2], (k.shape[0],)


def bits(key, shape, device="cpu", row0: int = 0) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32) as an int64 tensor on
    `device`: the hash of the flat row-major index, halves XOR-ed. A [B, 2]
    key array gives [B, *shape], row b drawn under key b. `row0`: the
    draw is rows [row0, row0 + shape[0]) of the same draw at a larger
    leading extent (one key only). One draw is one span `jaxrng`."""
    shape = tuple(shape)
    n = math.prod(shape)
    with annotate("jaxrng"):
        k0, k1, batch = _key_words(key, device)
        off = row0 * (n // shape[0]) if row0 else 0
        if batch and off:
            raise ValueError("row0 offsets a single key's draw")
        if off + n > 2 ** 32:
            raise NotImplementedError("more than 2^32 draws per key")
        lo = torch.arange(off, off + n, dtype=torch.int64, device=device)
        if batch:
            lo = lo[None]
        b0, b1 = _threefry2x32(k0, k1, torch.zeros_like(lo), lo)
        return (b0 ^ b1).reshape(batch + shape)


def _floats(key, shape, device, row0: int = 0) -> torch.Tensor:
    """The [0, 1) float32 of JAX's uniform: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1."""
    b = bits(key, shape, device, row0)
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, device="cpu", minval: float = 0.0,
            maxval: float = 1.0, row0: int = 0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, minval=, maxval=)`, float32:
    max(minval, floats·(maxval − minval) + minval), the multiply-add fused
    as XLA:CPU fuses it."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = _floats(key, shape, device, row0)
    if lo == 0 and hi == 1:                 # f·1 + 0 = f, and f ≥ 0
        return f
    return torch.clamp_min(xla_math.fma32(f, float(hi - lo), float(lo)),
                           float(lo))


def gumbel(key, shape, device="cpu") -> torch.Tensor:
    """`jax.random.gumbel(key, shape)` in JAX's default "low" mode,
    float32: −log(−log(u)) with u = uniform(minval=tiny, maxval=1)."""
    u = uniform(key, shape, device, minval=xla_math.TINY)
    return -xla_math.log(-xla_math.log(u))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key, shape, device="cpu", row0: int = 0) -> torch.Tensor:
    """`jax.random.normal(key, shape)`, float32 (JAX's `_normal_real`):
    √2·erf⁻¹(u) with u = uniform(minval=nextafter(−1, 0), maxval=1)."""
    u = uniform(key, shape, device, minval=_NORMAL_LO, row0=row0)
    return _SQRT2 * xla_math.erf_inv(u)


def bernoulli(key, p: float, shape, device="cpu",
              row0: int = 0) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)`: uniform(key, shape) < p, with
    p rounded to float32 as JAX rounds it."""
    return uniform(key, shape, device, row0=row0) < float(np.float32(p))


def permutation(key, n: int, device="cpu") -> torch.Tensor:
    """`jax.random.permutation(key, n)` as int64 (JAX's `_shuffle`):
    ⌈3·ln n / ln(2³²−1)⌉ rounds, each a split, 32 random bits per element
    and a stable sort by them. A [B, 2] key array gives [B, n]."""
    keys = key if isinstance(key, torch.Tensor) else np.asarray(key)
    batched = keys.ndim == 2
    keys = keys if batched else keys[None]
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2 ** 32 - 1)))
    x = torch.arange(n, device=device).expand(keys.shape[0], n)
    for _ in range(rounds):
        pairs = split(keys)                              # [B, 2, 2]
        keys = pairs[:, 0]
        order = torch.sort(bits(pairs[:, 1], (n,), device), dim=-1,
                           stable=True).indices
        x = torch.gather(x, 1, order)
    return x if batched else x[0]
