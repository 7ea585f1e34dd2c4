"""Host-side helpers of the repo's native runtime (`native/batcher.cpp`):
label histograms and the seeded per-cloud point subsample. Its row gather
is `np.take`, which `Dataset.batches` calls directly (the same bytes).

`label_histogram` is `np.bincount`, the same counts. `sample_points` draws
its subsets with the runtime's `std::mt19937_64` and libstdc++'s
`uniform_int_distribution`, which numpy cannot reproduce, so the source
is compiled with `g++` into `build/gridgcn_native/` at first use and bound
with ctypes. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "batcher.cpp"
BUILD_DIR = _REPO / "build" / "gridgcn_native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lib: ctypes.CDLL | None = None


def _lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgridgcn_native-{digest}.so"


def build() -> Path:
    """Compile native/batcher.cpp unless it is built; raises if g++ fails.
    Concurrent processes each write a temporary file and rename it into
    place, so a reader never sees a partial library."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gg_sample_points_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.gg_sample_points_f32.restype = None
        _lib = lib
    return _lib


def sample_points(src: np.ndarray, idx: np.ndarray, n_out: int,
                  seed: int = 0, threads: int = 8) -> np.ndarray:
    """out[i] = a seeded random n_out-point subset of cloud src[idx[i]]:
    src [S, N, C] float32, idx [B] → [B, n_out, C]; without replacement
    when n_out ≤ N (the ModelNet40 2048 → 1024 subsample)."""
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    B, (S, N, C) = idx.shape[0], src.shape
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= S):
        raise IndexError(f"index out of range for {S} rows: "
                         f"[{int(idx.min())}, {int(idx.max())}]")
    out = np.empty((B, n_out, C), np.float32)
    _load().gg_sample_points_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        B, N, n_out, C, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
    return out


def label_histogram(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Counts [num_classes] int64 of the labels in [0, num_classes)."""
    labels = np.asarray(labels).reshape(-1)
    valid = (labels >= 0) & (labels < num_classes)
    return np.bincount(labels[valid], minlength=num_classes).astype(np.int64)
