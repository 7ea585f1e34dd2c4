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
the draw's device through `kernels.rng`'s custom op: on the CPU in torch
int64 arithmetic masked to 32 bits (the op's plain version), on CUDA as
one kernel a draw (`csrc/rng.cu`: the hash and the `bits`, `uniform` or
`gumbel` epilogue; `normal` and `bernoulli` finish a `uniform` in torch,
`permutation` sorts `bits`); the kernel reads its keys on the device, a
numpy key copied there without blocking. `launches` counts the kernel's
launches by epilogue ({"bits", "uniform", "gumbel"}: 0 on the CPU). A
draw also takes a [B, 2] array of keys and makes the B draws in one pass,
[B, *shape]: the hash is elementwise, so each row equals the draw under
its own key.

Every draw is a hash of its flat row-major counter (the partitionable
mode), so the rows [row0, row0 + B) of a draw at a larger batch are the
hash of their own counters: `bits(..., row0=)` and `split(..., start=)`
make one data-parallel rank's rows of the global batch's draws exactly,
as the JAX package's GSPMD program draws them once for the whole batch.

`gumbel`, `normal` and `uniform` need XLA:CPU's float32 log, erf⁻¹ and
fused multiply-adds bit for bit: `utils.xla_math` repeats them in torch,
and `csrc/rng.cu` repeats the log and the multiply-add in its epilogues.

Each draw, its float epilogue included, is one span `jaxrng` in a
profiler's trace (`utils.profiling.annotate`). A key derivation has no
span of its own: a tensor key's runs on the key's device inside the span
of the layer that derives it, a numpy key's on the host.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from gridgcn_torch.kernels import rng as rng_kernel
from gridgcn_torch.utils import xla_math
from gridgcn_torch.utils.profiling import annotate

_M32 = 0xFFFFFFFF
launches = rng_kernel.launches      # kernel launches by epilogue


def _key_hash(key, start: int, num: int):
    """The hash of counters (0, start + i), i < num, under one key [2] or
    under each of [B, 2] keys (→ a leading B axis), stacked into key pairs
    [..., num, 2]: numpy uint32 for a numpy key, int64 on the key's device
    for a tensor key (the counters made there: a CUDA graph cannot capture
    a host array's copy). A tensor key's hash is no span of its own: its
    ops belong to the span that derives the key, and a captured forward is
    cut at no hash."""
    if isinstance(key, torch.Tensor):
        k = key.long()
        x1 = torch.arange(start, start + num, dtype=torch.int64,
                          device=k.device)
        b0, b1 = rng_kernel.threefry2x32(k[..., 0:1], k[..., 1:2],
                                         torch.zeros_like(x1), x1)
        return torch.stack([b0, b1], dim=-1)
    key = np.asarray(key, np.uint32)
    x1 = np.arange(start, start + num, dtype=np.int64).astype(np.uint32)
    b0, b1 = rng_kernel.threefry2x32(key[..., 0:1], key[..., 1:2],
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
    return _key_hash(key, start, num)


def fold_in(key, data: int):
    """`jax.random.fold_in(key, data)` for a uint32 `data`."""
    return _key_hash(key, int(data) & _M32, 1)[..., 0, :]


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


def _draw(key, shape, device, row0: int, epilogue: str, lo: float = 0.0,
          scale: float = 1.0) -> torch.Tensor:
    """One draw through `kernels.rng.draw` (the op's CPU implementation is
    the int64 torch path, a CUDA device launches one kernel), as one span
    `jaxrng`: `row0` becomes the counters' offset."""
    shape = tuple(shape)
    n = math.prod(shape)
    with annotate("jaxrng"):
        off = row0 * (n // shape[0]) if row0 else 0
        if off and np.ndim(key) == 2:
            raise ValueError("row0 offsets a single key's draw")
        if off + n > 2 ** 32:
            raise NotImplementedError("more than 2^32 draws per key")
        return rng_kernel.draw(key, shape, device, off, epilogue, lo, scale)


def bits(key, shape, device="cpu", row0: int = 0) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32) as an int64 tensor on
    `device`: the hash of the flat row-major index, halves XOR-ed. A [B, 2]
    key array gives [B, *shape], row b drawn under key b. `row0`: the
    draw is rows [row0, row0 + shape[0]) of the same draw at a larger
    leading extent (one key only). One draw is one span `jaxrng`."""
    return _draw(key, shape, device, row0, "bits")


def uniform(key, shape, device="cpu", minval: float = 0.0,
            maxval: float = 1.0, row0: int = 0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, minval=, maxval=)`, float32: the
    top 23 bits as the mantissa of a float in [1, 2), minus 1; then
    max(minval, floats·(maxval − minval) + minval), the multiply-add fused
    as XLA:CPU fuses it (unless the range is [0, 1))."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return _draw(key, shape, device, row0, "uniform", float(lo),
                 float(hi - lo))


def gumbel(key, shape, device="cpu") -> torch.Tensor:
    """`jax.random.gumbel(key, shape)` in JAX's default "low" mode,
    float32: −log(−log(u)) with u = uniform(minval=tiny, maxval=1), inside
    the draw's span (on the card, inside its one kernel)."""
    lo = np.float32(xla_math.TINY)
    return _draw(key, shape, device, 0, "gumbel", float(lo),
                 float(np.float32(1.0) - lo))


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
