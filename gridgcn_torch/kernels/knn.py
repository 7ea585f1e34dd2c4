"""Flash-kNN: the decoder's 3-NN query, as hand-written CUDA kernels.

Two kernels in `csrc/knn.cu`, each with a plain PyTorch version of the same
function beside its wrapper:

* `knn3_mxu` — replaces the JAX package's `ops/pallas/knn.py`
  `_knn_kernel_mxu` (via `flash_knn_mxu`), the main path's query: d² + 1
  from one K=16 split-bf16 product (f32-grade distances), exact top-3.
  The kernel centers and packs the operands itself, value for value as
  `mxu_center` and `mxu_pack` do for the plain version.
* `knn3_exact` — replaces `_knn_kernel` (via `flash_knn`): fp32 (q−s)²,
  bit for bit the TPU kernel's packed keys and truncated d².

Dispatch is by the device of the tensors passed in: a CUDA tensor launches
the kernel or raises, a CPU tensor runs the plain version. Nothing falls
back. The kernels are compiled from the package's sources with `nvcc` on
first CUDA use (`build_kernels`), never at import. Each wrapper counts its
kernel launches in a plain integer attribute, `knn3_mxu.launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

_BIG = 1e30
_VALID_MAX = _BIG * 0.5
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("knn.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "gridgcn_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# 4096 queries × 8192 supports × 4 B = 128 MB per temporary in the plain
# versions' query chunks
_REF_CHUNK_ELEMS = 1 << 25

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(source: str) -> Path:
    digest = hashlib.sha1((_CSRC / source).read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def build_kernels() -> dict[str, str]:
    """Compile every CUDA source of the package that is not built yet, one
    `nvcc` per source, all started together. Returns {source: compiler
    log} (the `-Xptxas -v` register and shared-memory report) for the
    sources built by this call; raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in SOURCES:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for src, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)
        logs[src] = log
    return logs


def _lib(source: str) -> ctypes.CDLL:
    if source not in _libs:
        build_kernels()
        lib = ctypes.CDLL(str(_lib_path(source)))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.knn3_exact_launch.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p]
        lib.knn3_exact_launch.restype = i
        lib.knn3_mxu_launch.argtypes = [p, p, p, p, i, i, i, p, p, p, p]
        lib.knn3_mxu_launch.restype = i
        _libs[source] = lib
    return _libs[source]


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_kind(*ts: torch.Tensor) -> str:
    kinds = {t.device.type for t in ts}
    if len(kinds) != 1 or {t.device for t in ts} != {ts[0].device}:
        raise ValueError(f"inputs on different devices: "
                         f"{[str(t.device) for t in ts]}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ts[0].device}")
    return kind


def _outputs(nq: int, device) -> tuple:
    return (torch.empty((nq, 3), dtype=torch.float32, device=device),
            torch.empty((nq, 3), dtype=torch.int32, device=device),
            torch.empty((nq, 3), dtype=torch.bool, device=device))


# ---------------------------------------------------------------- exact --

def exact_layout(ns: int) -> tuple[int, int]:
    """(ns_pad, idx_bits) of the exact kernel's packed keys: columns padded
    to a multiple of 128, the index in the low bits of the f32 distance."""
    ns_pad = -(-ns // 128) * 128
    return ns_pad, max(1, int(ns_pad - 1).bit_length())


def knn3_exact_ref(q_xyz, q_mask, s_xyz, s_mask):
    """Plain version of `knn3_exact`: the same packed keys over the
    [Nq, ns_pad] matrix, in query chunks, and the 3 smallest."""
    nq, ns = q_xyz.shape[0], s_xyz.shape[0]
    ns_pad, idx_bits = exact_layout(ns)
    low = (1 << idx_bits) - 1
    dev = q_xyz.device
    s = torch.zeros((ns_pad, 3), dtype=torch.float32, device=dev)
    s[:ns] = s_xyz.float()
    sm = torch.zeros((ns_pad,), dtype=torch.bool, device=dev)
    sm[:ns] = s_mask
    col = torch.arange(ns_pad, dtype=torch.int32, device=dev)
    q = q_xyz.float()
    tops = []
    chunk = max(1, _REF_CHUNK_ELEMS // ns_pad)
    for c0 in range(0, nq, chunk):
        qc = q[c0:c0 + chunk]
        dx = qc[:, 0:1] - s[None, :, 0]
        dy = qc[:, 1:2] - s[None, :, 1]
        dz = qc[:, 2:3] - s[None, :, 2]
        d2 = (dx * dx + dy * dy) + dz * dz
        d2 = torch.where(sm[None], d2, _BIG)
        keys = (d2.view(torch.int32) & ~low) | col
        tops.append(torch.topk(keys, 3, dim=-1, largest=False,
                               sorted=True).values)
    top = torch.cat(tops) if tops else torch.empty(
        (0, 3), dtype=torch.int32, device=dev)
    d2 = (top & ~low).view(torch.float32)
    return d2, top & low, (d2 < _VALID_MAX) & q_mask[:, None]


def knn3_exact(q_xyz, q_mask, s_xyz, s_mask):
    """Exact 3-NN: q_xyz [Nq, 3] f32, q_mask [Nq] bool, s_xyz [Ns, 3] f32,
    s_mask [Ns] bool → (d2 [Nq, 3] f32 truncated, idx [Nq, 3] int32,
    valid [Nq, 3] bool)."""
    if _device_kind(q_xyz, q_mask, s_xyz, s_mask) == "cpu":
        return knn3_exact_ref(q_xyz, q_mask, s_xyz, s_mask)
    nq, ns = q_xyz.shape[0], s_xyz.shape[0]
    _check(q_xyz, "q_xyz", torch.float32, (nq, 3))
    _check(q_mask, "q_mask", torch.bool, (nq,))
    _check(s_xyz, "s_xyz", torch.float32, (ns, 3))
    _check(s_mask, "s_mask", torch.bool, (ns,))
    if ns < 1:
        raise ValueError("knn3_exact needs at least one support point")
    out_d, out_i, out_v = _outputs(nq, q_xyz.device)
    if nq == 0:
        return out_d, out_i, out_v
    ns_pad, idx_bits = exact_layout(ns)
    lib = _lib("knn.cu")
    err = lib.knn3_exact_launch(
        q_xyz.data_ptr(), q_mask.data_ptr(), s_xyz.data_ptr(),
        s_mask.data_ptr(), nq, ns, ns_pad, idx_bits, out_d.data_ptr(),
        out_i.data_ptr(), out_v.data_ptr(),
        torch.cuda.current_stream(q_xyz.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn3_exact launch failed: CUDA error {err}")
    knn3_exact.launches += 1
    return out_d, out_i, out_v


knn3_exact.launches = 0


# ------------------------------------------------------------------ mxu --

def _split_bf16(x: torch.Tensor):
    """x ≈ hi + lo in bf16 (~2⁻¹⁶ relative): hi is x rounded to bf16
    (JAX's `reduce_precision(x, 8, 7)`), lo the rounded residual."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    return (x2[:, 0:1] + x2[:, 1:2]) + x2[:, 2:3]


def mxu_center(s_xyz, s_mask):
    """Center of the valid supports' bounding box, (min + max) / 2 per axis
    (0 when none is valid). Both packings move q and s by it first: the
    distances do not change, and the split-bf16 error, which grows with
    |x|², then depends on the scene's extent, not on its offset from the
    origin. (The TPU kernel splits the raw coordinates.)"""
    s = s_xyz.float()
    m = s_mask[:, None]
    lo = torch.where(m, s, float("inf")).amin(dim=0)
    hi = torch.where(m, s, float("-inf")).amax(dim=0)
    return torch.where(s_mask.any(), (lo + hi) * 0.5, 0.0)


def mxu_pack(q_xyz, s_xyz, s_mask):
    """The split-bf16 operands whose K=16 product is d² + 1:

      q cols: [q_hi | q_lo | q_hi | qn_hi qn_lo | 1 1 | 0 0 0]   [Nq, 16]
      s rows: [-2s_hi; -2s_hi; -2s_lo; 1 1; sn_hi sn_lo; 0 0 0]  [16, ns_pad]

    with qn = |q|² + 1 and sn = |s|² (1e30 for masked supports); the padded
    columns (Ns ≤ col < ns_pad, ns_pad a multiple of 128) carry only
    sn_hi = 1e30."""
    nq, ns = q_xyz.shape[0], s_xyz.shape[0]
    ns_pad = -(-ns // 128) * 128
    dev = q_xyz.device
    bf = torch.bfloat16
    q = q_xyz.float()
    q_hi, q_lo = _split_bf16(q)
    qn_hi, qn_lo = _split_bf16(_sq_norm(q) + 1.0)
    qb = torch.cat([q_hi, q_lo, q_hi, qn_hi, qn_lo,
                    torch.ones((nq, 2), dtype=bf, device=dev),
                    torch.zeros((nq, 3), dtype=bf, device=dev)], dim=1)
    s = s_xyz.float()
    s_hi, s_lo = _split_bf16(s)
    sn_hi, sn_lo = _split_bf16(torch.where(s_mask[:, None], _sq_norm(s),
                                           _BIG))
    cols = torch.cat([-2.0 * s_hi, -2.0 * s_hi, -2.0 * s_lo,
                      torch.ones((ns, 2), dtype=bf, device=dev),
                      sn_hi, sn_lo], dim=1)                      # [Ns, 13]
    sb = torch.zeros((16, ns_pad), dtype=bf, device=dev)
    sb[:13, :ns] = cols.T
    sb[11, ns:] = _BIG
    return qb.contiguous(), sb, ns_pad


def knn3_mxu_ref(q_xyz, q_mask, s_xyz, s_mask):
    """Plain version of `knn3_mxu`: the same centering and packing, an f32
    product of the upcast bf16 operands, and an exact top-3 (ties to the
    lower column, three first-occurrence argmin passes), in query chunks."""
    nq, ns = q_xyz.shape[0], s_xyz.shape[0]
    c = mxu_center(s_xyz, s_mask)
    qb, sb, ns_pad = mxu_pack(q_xyz.float() - c, s_xyz.float() - c, s_mask)
    sf = sb.float()
    ds, idxs = [], []
    chunk = max(1, _REF_CHUNK_ELEMS // ns_pad)
    for c0 in range(0, nq, chunk):
        v = qb[c0:c0 + chunk].float() @ sf                   # d² + 1
        cd, ci = [], []
        for _ in range(3):
            i = torch.argmin(v, dim=-1, keepdim=True)
            cd.append(torch.gather(v, 1, i))
            ci.append(i)
            v.scatter_(1, i, float("inf"))
        ds.append(torch.cat(cd, 1))
        idxs.append(torch.cat(ci, 1))
    dev = q_xyz.device
    dp1 = torch.cat(ds) if ds else torch.empty((0, 3), device=dev)
    idx = torch.cat(idxs) if idxs else torch.empty(
        (0, 3), dtype=torch.int64, device=dev)
    d2 = torch.clamp_min(dp1 - 1.0, 0.0)
    idx = torch.clamp_max(idx, ns - 1).int()
    return d2, idx, (d2 < _VALID_MAX) & q_mask[:, None]


def knn3_mxu(q_xyz, q_mask, s_xyz, s_mask):
    """Near-exact 3-NN from split-bf16 distances: q_xyz [Nq, 3] f32,
    q_mask [Nq] bool, s_xyz [Ns, 3] f32, s_mask [Ns] bool → (d2 [Nq, 3]
    f32, idx [Nq, 3] int32, valid [Nq, 3] bool)."""
    if _device_kind(q_xyz, q_mask, s_xyz, s_mask) == "cpu":
        return knn3_mxu_ref(q_xyz, q_mask, s_xyz, s_mask)
    nq, ns = q_xyz.shape[0], s_xyz.shape[0]
    _check(q_xyz, "q_xyz", torch.float32, (nq, 3))
    _check(q_mask, "q_mask", torch.bool, (nq,))
    _check(s_xyz, "s_xyz", torch.float32, (ns, 3))
    _check(s_mask, "s_mask", torch.bool, (ns,))
    if ns < 1:
        raise ValueError("knn3_mxu needs at least one support point")
    out_d, out_i, out_v = _outputs(nq, q_xyz.device)
    if nq == 0:
        return out_d, out_i, out_v
    lib = _lib("knn.cu")
    err = lib.knn3_mxu_launch(
        q_xyz.data_ptr(), q_mask.data_ptr(), s_xyz.data_ptr(),
        s_mask.data_ptr(), nq, ns, -(-ns // 128) * 128, out_d.data_ptr(),
        out_i.data_ptr(), out_v.data_ptr(),
        torch.cuda.current_stream(q_xyz.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn3_mxu launch failed: CUDA error {err}")
    knn3_mxu.launches += 1
    return out_d, out_i, out_v


knn3_mxu.launches = 0


# ------------------------------------------------------- 3-NN wrapper --

def flash_three_nn(query_xyz, query_mask, support_xyz, support_mask,
                   k: int = 3, variant: str = "mxu"):
    """Batched 3-NN with inverse-distance weights: query [B, Nq, 3] /
    [B, Nq], support [B, Ns, 3] / [B, Ns] → (idx [B, Nq, 3] int64,
    weights [B, Nq, 3] f32, found [B, Nq] bool).

    variant="mxu" (the decoder's) or "exact". Indices and distances carry
    no gradient, like the reference's zero-backward gridify_up."""
    if k != 3:
        raise NotImplementedError("the flash-kNN kernels are k=3 only")
    if variant == "mxu":
        knn = knn3_mxu
    elif variant == "exact":
        knn = knn3_exact
    else:
        raise ValueError(f"unknown variant {variant!r}")
    outs = [knn(query_xyz[b], query_mask[b], support_xyz[b], support_mask[b])
            for b in range(query_xyz.shape[0])]
    d2 = torch.stack([o[0] for o in outs]).detach()
    idx = torch.stack([o[1] for o in outs]).long()
    valid = torch.stack([o[2] for o in outs])
    d2 = torch.clamp_min(d2, 0.0)
    w = torch.where(valid, 1.0 / (d2 + 1e-8), 0.0)
    w_sum = w.sum(dim=-1, keepdim=True)
    weights = torch.where(w_sum > 0, w / torch.clamp_min(w_sum, 1e-12), 0.0)
    return torch.where(valid, idx, 0), weights, valid.any(dim=-1)
