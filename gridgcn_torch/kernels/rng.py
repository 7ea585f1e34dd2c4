"""jaxrng's draws as one hand-written CUDA kernel a draw.

`utils.jaxrng` hashes flat counters with JAX's threefry2x32 (its
partitionable mode). On the CPU, and in the plain version kept here
(`draw_ref`), the hash is masked int64 torch arithmetic (uint32 ops are
only partly supported on CUDA), ~170-180 kernels a draw on the card. The
kernel in `csrc/rng.cu` makes the same values in one launch: the hash and
its epilogue,

* "bits": the two halves XOR-ed, int64 (`jaxrng.bits`);
* "uniform": the [0, 1) float32 of the top 23 bits, then, unless
  (lo, scale) is (0, 1), floats·scale + lo with XLA:CPU's one rounding,
  clamped below at lo (`jaxrng.uniform`);
* "gumbel": −log(−log(u)) of that uniform, with XLA:CPU's float32 log
  (`utils.xla_math.log`) (`jaxrng.gumbel`);

bit for bit the plain version's. One `torch.library` custom op,
`gridgcn::rng_draw_keys(Tensor keys, SymInt[] shape, ...)`, registered when
this module is imported, with a CUDA implementation (the launch), a CPU
implementation (the plain version) and a fake one (the output's shape and
type), so that `torch.export` traces through a draw. The keys are an int64
tensor [2] or [B, 2] on the draw's device, which the kernel reads: `draw`
copies a numpy key there from page-locked memory without blocking (a
traced or tensor key is there already).

`shape` is the whole output's, [B, ...] for B key rows; row b hashes
counters off .. off + n − 1 (n the row's size) under key b. A CUDA draw
launches the kernel or raises; nothing falls back. `csrc/rng.cu` is
compiled with `nvcc` at the first CUDA draw, one library for every
epilogue, and kept in `knn.BUILD_DIR` under a hash of its source and
flags. `launches` counts the kernel's launches by epilogue, also inside an
exported program.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import torch

from gridgcn_torch.kernels import knn
from gridgcn_torch.utils import xla_math

EPILOGUES = ("bits", "uniform", "gumbel")
SOURCE = knn._CSRC / "rng.cu"
NVCC_EXTRA = ("-fmad=false",)      # nothing contracted (rng.cu)
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

launches = dict.fromkeys(EPILOGUES, 0)
_lib_cache: list[ctypes.CDLL] = []


def threefry2x32(k0, k1, x0, x1):
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


def _dtype(epilogue: str) -> torch.dtype:
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {EPILOGUES}")
    return torch.int64 if epilogue == "bits" else torch.float32


def draw_ref(k0, k1, shape, off: int, epilogue: str, lo: float,
             scale: float, device) -> torch.Tensor:
    """Plain version of the kernel: k0, k1 the key words as ints (one key)
    or int64 tensors [B, 1] (B keys), `shape` the whole output's."""
    rows = k0.shape[0] if isinstance(k0, torch.Tensor) and k0.dim() else 1
    n = int(np.prod(shape, dtype=np.int64)) // rows if rows else 0
    lo_ = torch.arange(off, off + n, dtype=torch.int64, device=device)
    if isinstance(k0, torch.Tensor) and k0.dim():
        lo_ = lo_[None]
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo_), lo_)
    b = (b0 ^ b1).reshape(shape)
    if _dtype(epilogue) == torch.int64:
        return b
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if not (lo == 0 and scale == 1):        # f·1 + 0 = f, and f ≥ 0
        f = torch.clamp_min(xla_math.fma32(f, scale, lo), lo)
    if epilogue == "gumbel":
        f = -xla_math.log(-xla_math.log(f))
    return f


# ---------------------------------------------------------------- build --

def _lib_path():
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(
        knn.NVCC_FLAGS + NVCC_EXTRA).encode()).hexdigest()[:16]
    return knn.BUILD_DIR / f"librng-{digest}.so"


def build_kernel() -> str:
    """Compile `csrc/rng.cu` unless its library is built
    (`knn.compile_libraries`); returns the compiler's log (`-Xptxas -v`:
    registers, spills) with the build's own seconds last."""
    return knn.compile_libraries(
        {"rng.cu": (_lib_path(), SOURCE, NVCC_EXTRA)})["rng.cu"]


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        build_kernel()
        lib = ctypes.CDLL(str(_lib_path()))
        p = ctypes.c_void_p
        lib.rng_draw_launch.argtypes = [
            ctypes.c_int, p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_uint, ctypes.c_float, ctypes.c_float, p, p]
        lib.rng_draw_launch.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


def _launch(epilogue, keys, off, lo, scale, out):
    """One kernel launch into `out` ([rows, ...]) on the current stream."""
    if out.numel() == 0:
        return out
    rows = keys.shape[0] if keys.dim() == 2 else 1
    err = _lib().rng_draw_launch(
        EPILOGUES.index(epilogue), keys.data_ptr(), rows, out.numel() // rows,
        off, lo, scale, out.data_ptr(), knn._stream(out.device))
    if err != 0:
        raise RuntimeError(f"rng_draw launch failed: CUDA error {err}")
    launches[epilogue] += 1
    return out


# --------------------------------------------------------------- the op --

@torch.library.custom_op(
    "gridgcn::rng_draw_keys", mutates_args=(), device_types="cpu",
    schema="(Tensor keys, SymInt[] shape, int off, str epilogue, float lo, "
           "float scale) -> Tensor")
def _draw_keys_op(keys, shape, off, epilogue, lo, scale):
    k = keys.long()
    k0, k1 = (k[0], k[1]) if k.dim() == 1 else (k[:, 0:1], k[:, 1:2])
    return draw_ref(k0, k1, tuple(shape), off, epilogue, lo, scale,
                    keys.device)


@_draw_keys_op.register_fake
def _draw_keys_fake(keys, shape, off, epilogue, lo, scale):
    return keys.new_empty(shape, dtype=_dtype(epilogue))


@_draw_keys_op.register_kernel("cuda")
def _draw_keys_cuda(keys, shape, off, epilogue, lo, scale):
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,) or \
            keys.dim() > 2 or not keys.is_contiguous():
        raise ValueError(f"keys must be contiguous int64 [2] or [B, 2], got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    out = keys.new_empty(shape, dtype=_dtype(epilogue))
    return _launch(epilogue, keys, off, lo, scale, out)


def draw(key, shape, device, off: int = 0, epilogue: str = "bits",
         lo: float = 0.0, scale: float = 1.0) -> torch.Tensor:
    """One draw of `shape` values a key row on `device` under a key [2] or
    keys [B, 2], numpy or a tensor (`rng_draw_keys`); → [*shape] or
    [B, *shape]. A numpy key reaches a CUDA device by a copy from
    page-locked memory that does not wait for the device."""
    shape = tuple(shape)
    device = torch.device(device)
    if isinstance(key, torch.Tensor):
        k = key.long().to(device).contiguous()
    else:
        k = torch.from_numpy(np.ascontiguousarray(key, dtype=np.int64))
        if device.type == "cuda":
            k = k.pin_memory().to(device, non_blocking=True)
    lead = () if k.dim() == 1 else (k.shape[0],)
    return torch.ops.gridgcn.rng_draw_keys(k, lead + shape, off, epilogue,
                                           lo, scale)
