"""Flash-kNN: the decoder's k-NN query, as hand-written CUDA kernels.

Two kernels in `csrc/knn.cu`, each with a plain PyTorch version of the same
function beside its wrapper:

* `knn3_mxu` — replaces the JAX package's `ops/pallas/knn.py`
  `_knn_kernel_mxu` (via `flash_knn_mxu`), the main path's query: d² + 1
  from one K=16 split-bf16 product on the tensor cores (f32-grade
  distances), exact top-3. Each call launches two kernels: the support
  pack (`mxu_pack_support`: value for value `mxu_center` and `mxu_pack`,
  each column in the B-fragment order `PACK_ORDER`) and the product with
  its top-3.
* `knn3_exact` — replaces `_knn_kernel` (via `flash_knn`): fp32 (q−s)²,
  bit for bit the TPU kernel's packed keys and truncated d².

Each kernel is a `torch.library` custom op (`gridgcn::knn3_mxu`,
`gridgcn::mxu_pack_support`, `gridgcn::knn3_exact`), registered when this
module is imported: a CUDA implementation (the launch), a CPU
implementation (the plain version) and a fake one (the output shapes and
types), so that `torch.export` traces through the call and an exported
program runs the kernel; a loader imports this module first. Dispatch is by
the device of the tensors passed in: a CUDA tensor launches the kernel or
raises, a CPU tensor runs the plain version. Nothing falls back. The
kernels are compiled from the package's sources with `nvcc` on first CUDA
use (`build_kernels`), never at import: one library per list length k,
built when a call first asks for that k. The CUDA implementation counts the
calls in which it launches its kernels in a plain integer attribute of the
public wrapper, `knn3_mxu.launches` (and by list length in
`knn3_mxu.launches_by_k`), also inside an exported program;
`knn3_mxu` also adds its pack to `mxu_pack_support.launches`. Every output
is a tensor of its own (a custom op's outputs may not alias), and the mxu
call's packed supports a fourth.

Both kernels take the list length k (default 3, the decoder's) for
1 ≤ k ≤ MAX_K = 128, the reference's bound (its kernels write or fold
their winners into 128-lane rows). For k ≤ REG_MAX_K = 16 `knn.cu` is
built once for each k that is used (`-DKNN_K=k`: the lists in
registers); the longer lists share one build (`-DKNN_K=0`, k a runtime
argument: each list a warp queue over the registers of a warp's 32 lanes,
WarpSelect). A longer list raises. The plain versions take any k.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import time
from pathlib import Path

import torch

_BIG = 1e30
_VALID_MAX = _BIG * 0.5
MAX_K = 128         # the longest list: the reference's 128-lane rows
REG_MAX_K = 16      # the longest list built with its lists in registers
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("knn.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "gridgcn_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# 4096 queries × 8192 supports × 4 B = 128 MB per temporary in the plain
# versions' query chunks
_REF_CHUNK_ELEMS = 1 << 25
# the packed support column's 16 values in mma.m16n8k16 B-fragment order:
# positions 4t..4t+3 hold K = 2t, 2t+1, 2t+8, 2t+9 (the b0, b1 registers
# of the lane with threadID_in_group t)
PACK_ORDER = (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15)

_libs: dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build_k(k: int) -> int:
    """The `-DKNN_K` of the build that serves list length k: k itself up
    to REG_MAX_K, 0 (the list kernels) above."""
    return k if k <= REG_MAX_K else 0


def _lib_path(source: str, build: int) -> Path:
    digest = hashlib.sha1((_CSRC / source).read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_k{build}-{digest}.so"


def _build_name(source: str, build: int) -> str:
    return f"{source} k={build if build else f'{REG_MAX_K + 1}..{MAX_K}'}"


def compile_libraries(jobs: dict) -> dict[str, str]:
    """Compile each {name: (library path, source path, extra nvcc
    arguments)} whose library is not built yet with `NVCC_FLAGS`, all
    started together; raises if a build fails. Returns {name: compiler
    log} for every job: the `-Xptxas -v` register, shared-memory and spill
    report, kept beside the library, and last the build's own seconds
    (`nvcc: <s> s`)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, (out, src, extra) in jobs.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        # the compiler's report goes to a file: a pipe that nobody reads
        # while it runs could fill and stop it
        with open(tmp.with_suffix(".log"), "w") as f:
            procs[name] = (out, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)],
                stdout=f, stderr=subprocess.STDOUT))
    try:
        while procs:
            for name, (out, tmp, proc) in list(procs.items()):
                if proc.poll() is None:
                    continue
                seconds = time.perf_counter() - t0
                log = tmp.with_suffix(".log").read_text()
                tmp.with_suffix(".log").unlink()
                del procs[name]
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {name}:\n{log}")
                out.with_suffix(".log").write_text(
                    f"{log}nvcc: {seconds:.2f} s\n")
                os.replace(tmp, out)
            time.sleep(0.05)
    finally:
        for _, _, proc in procs.values():   # after a failure: the others
            proc.kill()
            proc.wait()
    return {name: out.with_suffix(".log").read_text()
            for name, (out, _, _) in jobs.items()}


def build_kernels(ks=(3,)) -> dict[str, str]:
    """Compile the kNN sources (`SOURCES`) for each list length in `ks`
    that is not built yet, one `nvcc` per source and build (one per
    k ≤ REG_MAX_K, one for every longer k), all started together
    (`compile_libraries`). Returns {"<source> k=<k>" (or "k=17..128"):
    compiler log} for those builds."""
    builds = dict.fromkeys((src, _build_k(check_k(k)))
                           for src in SOURCES for k in ks)
    return compile_libraries({
        _build_name(src, k): (_lib_path(src, k), _CSRC / src,
                              (f"-DKNN_K={k}",)) for src, k in builds})


def _lib(source: str, k: int) -> ctypes.CDLL:
    """The library that serves list length k (built on first use)."""
    k = _build_k(k)
    if (source, k) not in _libs:
        build_kernels((k or MAX_K,))
        lib = ctypes.CDLL(str(_lib_path(source, k)))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.knn3_exact_launch.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p,
                                          p]
        lib.knn3_exact_launch.restype = i
        lib.knn3_mxu_launch.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p,
                                        p]
        lib.knn3_mxu_launch.restype = i
        lib.mxu_pack_launch.argtypes = [p, p, i, i, p, p]
        lib.mxu_pack_launch.restype = i
        _libs[source, k] = lib
    return _libs[source, k]


def _device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"inputs on different devices: "
                             f"{[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_supports(s_xyz, s_mask) -> int:
    """Ns, after cheap checks of what the kernels take."""
    ns = s_xyz.shape[0]
    if s_xyz.dtype != torch.float32 or s_mask.dtype != torch.bool:
        raise ValueError(f"s_xyz must be float32 and s_mask bool, got "
                         f"{s_xyz.dtype} and {s_mask.dtype}")
    if s_xyz.shape != (ns, 3) or s_mask.shape != (ns,):
        raise ValueError(f"s_xyz must be [Ns, 3] and s_mask [Ns], got "
                         f"{tuple(s_xyz.shape)} and {tuple(s_mask.shape)}")
    if not (s_xyz.is_contiguous() and s_mask.is_contiguous()):
        raise ValueError("s_xyz and s_mask must be contiguous")
    if ns < 1:
        raise ValueError("the kernels need at least one support point")
    return ns


def _check(q_xyz, q_mask, s_xyz, s_mask) -> tuple[int, int]:
    """(Nq, Ns), after cheap checks of what the kernels take."""
    nq = q_xyz.shape[0]
    if q_xyz.dtype != torch.float32 or q_mask.dtype != torch.bool:
        raise ValueError(f"q_xyz must be float32 and q_mask bool, got "
                         f"{q_xyz.dtype} and {q_mask.dtype}")
    if q_xyz.shape != (nq, 3) or q_mask.shape != (nq,):
        raise ValueError(f"q_xyz must be [Nq, 3] and q_mask [Nq], got "
                         f"{tuple(q_xyz.shape)} and {tuple(q_mask.shape)}")
    if not (q_xyz.is_contiguous() and q_mask.is_contiguous()):
        raise ValueError("q_xyz and q_mask must be contiguous")
    return nq, _check_supports(s_xyz, s_mask)


def _stream(dev: torch.device) -> int:
    """The raw handle of the current stream on `dev`, without building a
    `torch.cuda.Stream`."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _pack_bytes(ns: int) -> int:
    """Bytes of `knn3_mxu`'s packed supports: 32 per padded column, then
    the center (16)."""
    return -(-ns // 128) * 128 * 32 + 16


def _outputs(nq: int, like: torch.Tensor, k: int = 3) -> tuple:
    """d2 f32 [nq, k], idx int32 [nq, k] and valid bool [nq, k] on
    `like`'s device, each a tensor of its own."""
    return (like.new_empty((nq, k)),
            like.new_empty((nq, k), dtype=torch.int32),
            like.new_empty((nq, k), dtype=torch.bool))


def check_k(k: int) -> int:
    """k, if the kernels take it: 1 ≤ k ≤ MAX_K (128), the bound of the
    reference's kernels, which write or fold their winners into 128-lane
    rows."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the flash-kNN kernels take 1 <= k <= {MAX_K} "
                         f"(MAX_K: the reference's 128-lane limit), got "
                         f"k={k}")
    return k


_KNN_SCHEMA = ("(Tensor q_xyz, Tensor q_mask, Tensor s_xyz, Tensor s_mask,"
               " int k=3) -> (Tensor, Tensor, Tensor)")


def _knn_fake(q_xyz, q_mask, s_xyz, s_mask, k=3):
    return _outputs(q_xyz.shape[0], q_xyz, k)


def visit_step(n: int) -> int:
    """The step of the kernels' visit order p -> p * step mod n over n
    columns (or n8 tiles): an odd number near 5n/8, coprime to n, so
    consecutive visits land far apart. `knn.cu` visit_step is the same."""
    a = (n * 5) // 8 | 1
    while math.gcd(a, n) != 1:
        a += 2
    return a


# ---------------------------------------------------------------- exact --

def exact_layout(ns: int) -> tuple[int, int]:
    """(ns_pad, idx_bits) of the exact kernel's packed keys: columns padded
    to a multiple of 128, the index in the low bits of the f32 distance."""
    ns_pad = -(-ns // 128) * 128
    return ns_pad, max(1, int(ns_pad - 1).bit_length())


def knn3_exact_ref(q_xyz, q_mask, s_xyz, s_mask, k: int = 3):
    """Plain version of `knn3_exact`: the same packed keys over the
    [Nq, ns_pad] matrix, in query chunks, and the k smallest."""
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
        tops.append(torch.topk(keys, k, dim=-1, largest=False,
                               sorted=True).values)
    top = torch.cat(tops) if tops else torch.empty(
        (0, k), dtype=torch.int32, device=dev)
    d2 = (top & ~low).view(torch.float32)
    return d2, top & low, (d2 < _VALID_MAX) & q_mask[:, None]


@torch.library.custom_op("gridgcn::knn3_exact", mutates_args=(),
                         device_types="cpu", schema=_KNN_SCHEMA)
def _knn3_exact_op(q_xyz, q_mask, s_xyz, s_mask, k=3):
    return knn3_exact_ref(q_xyz, q_mask, s_xyz, s_mask, k)


_knn3_exact_op.register_fake(_knn_fake)


@_knn3_exact_op.register_kernel("cuda")
def _knn3_exact_cuda(q_xyz, q_mask, s_xyz, s_mask, k=3):
    nq, ns = _check(q_xyz, q_mask, s_xyz, s_mask)
    out_d, out_i, out_v = _outputs(nq, q_xyz, check_k(k))
    if nq == 0:
        return out_d, out_i, out_v
    ns_pad, idx_bits = exact_layout(ns)
    err = _lib("knn.cu", k).knn3_exact_launch(
        q_xyz.data_ptr(), q_mask.data_ptr(), s_xyz.data_ptr(),
        s_mask.data_ptr(), nq, ns, ns_pad, idx_bits, k, out_d.data_ptr(),
        out_i.data_ptr(), out_v.data_ptr(), _stream(q_xyz.device))
    if err != 0:
        raise RuntimeError(f"knn3_exact launch failed: CUDA error {err}")
    knn3_exact.launches += 1
    knn3_exact.launches_by_k[k] = knn3_exact.launches_by_k.get(k, 0) + 1
    return out_d, out_i, out_v


def knn3_exact(q_xyz, q_mask, s_xyz, s_mask, k: int = 3):
    """Exact k-NN (1 ≤ k ≤ MAX_K): q_xyz [Nq, 3] f32, q_mask [Nq] bool,
    s_xyz [Ns, 3] f32, s_mask [Ns] bool → (d2 [Nq, k] f32 truncated,
    idx [Nq, k] int32, valid [Nq, k] bool). The custom op
    `gridgcn::knn3_exact`."""
    _device(q_xyz, q_mask, s_xyz, s_mask)
    return torch.ops.gridgcn.knn3_exact(q_xyz, q_mask, s_xyz, s_mask,
                                        check_k(k))


knn3_exact.launches = 0
knn3_exact.launches_by_k = {}     # the same calls, by list length


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


def knn3_mxu_ref(q_xyz, q_mask, s_xyz, s_mask, k: int = 3):
    """Plain version of `knn3_mxu`: the same centering and packing, an f32
    product of the upcast bf16 operands, and an exact top-k (ties to the
    lower column, k first-occurrence argmin passes), in query chunks."""
    nq, ns = q_xyz.shape[0], s_xyz.shape[0]
    c = mxu_center(s_xyz, s_mask)
    qb, sb, ns_pad = mxu_pack(q_xyz.float() - c, s_xyz.float() - c, s_mask)
    sf = sb.float()
    ds, idxs = [], []
    chunk = max(1, _REF_CHUNK_ELEMS // ns_pad)
    for c0 in range(0, nq, chunk):
        v = qb[c0:c0 + chunk].float() @ sf                   # d² + 1
        cd, ci = [], []
        for _ in range(k):
            i = torch.argmin(v, dim=-1, keepdim=True)
            cd.append(torch.gather(v, 1, i))
            ci.append(i)
            v.scatter_(1, i, float("inf"))
        ds.append(torch.cat(cd, 1))
        idxs.append(torch.cat(ci, 1))
    dev = q_xyz.device
    dp1 = torch.cat(ds) if ds else torch.empty((0, k), device=dev)
    idx = torch.cat(idxs) if idxs else torch.empty(
        (0, k), dtype=torch.int64, device=dev)
    d2 = torch.clamp_min(dp1 - 1.0, 0.0)
    idx = torch.clamp_max(idx, ns - 1).int()
    return d2, idx, (d2 < _VALID_MAX) & q_mask[:, None]


@torch.library.custom_op("gridgcn::knn3_mxu", mutates_args=(),
                         device_types="cpu", schema=_KNN_SCHEMA)
def _knn3_mxu_op(q_xyz, q_mask, s_xyz, s_mask, k=3):
    return knn3_mxu_ref(q_xyz, q_mask, s_xyz, s_mask, k)


_knn3_mxu_op.register_fake(_knn_fake)


@_knn3_mxu_op.register_kernel("cuda")
def _knn3_mxu_cuda(q_xyz, q_mask, s_xyz, s_mask, k=3):
    nq, ns = _check(q_xyz, q_mask, s_xyz, s_mask)
    out_d, out_i, out_v = _outputs(nq, q_xyz, check_k(k))
    if nq == 0:
        return out_d, out_i, out_v
    pack = torch.empty(_pack_bytes(ns), dtype=torch.uint8,
                       device=q_xyz.device)
    err = _lib("knn.cu", k).knn3_mxu_launch(
        q_xyz.data_ptr(), q_mask.data_ptr(), s_xyz.data_ptr(),
        s_mask.data_ptr(), nq, ns, -(-ns // 128) * 128, k, pack.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), out_v.data_ptr(),
        _stream(q_xyz.device))
    if err != 0:
        raise RuntimeError(f"knn3_mxu launch failed: CUDA error {err}")
    knn3_mxu.launches += 1
    knn3_mxu.launches_by_k[k] = knn3_mxu.launches_by_k.get(k, 0) + 1
    mxu_pack_support.launches += 1
    return out_d, out_i, out_v


def knn3_mxu(q_xyz, q_mask, s_xyz, s_mask, k: int = 3):
    """Near-exact k-NN from split-bf16 distances (1 ≤ k ≤ MAX_K): q_xyz
    [Nq, 3] f32, q_mask [Nq] bool, s_xyz [Ns, 3] f32, s_mask [Ns] bool →
    (d2 [Nq, k] f32, idx [Nq, k] int32, valid [Nq, k] bool). The custom op
    `gridgcn::knn3_mxu`."""
    _device(q_xyz, q_mask, s_xyz, s_mask)
    return torch.ops.gridgcn.knn3_mxu(q_xyz, q_mask, s_xyz, s_mask,
                                      check_k(k))


knn3_mxu.launches = 0
knn3_mxu.launches_by_k = {}


def mxu_pack_support_ref(s_xyz, s_mask):
    """Plain version of `mxu_pack_support`: `mxu_pack`'s support operand
    for the supports moved by `mxu_center`, in the kernel's visit order
    (packed n8 tile p holds tile `p * visit_step(n) mod n` of the n =
    ns_pad / 8), each column's 16 bf16 in `PACK_ORDER`; then the center as
    4 f32 (the last 0). uint8 bytes."""
    c = mxu_center(s_xyz, s_mask)
    _, sb, ns_pad = mxu_pack(s_xyz.new_zeros((0, 3)), s_xyz.float() - c,
                             s_mask)
    n = ns_pad // 8
    tiles = torch.arange(n, device=sb.device) * visit_step(n) % n
    cols = sb.T[:, list(PACK_ORDER)].reshape(n, 8, 16)[tiles]
    return torch.cat([cols.contiguous().view(torch.uint8).reshape(-1),
                      torch.cat([c, c.new_zeros(1)]).view(torch.uint8)])


@torch.library.custom_op(
    "gridgcn::mxu_pack_support", mutates_args=(), device_types="cpu",
    schema="(Tensor s_xyz, Tensor s_mask) -> Tensor")
def _mxu_pack_op(s_xyz, s_mask):
    return mxu_pack_support_ref(s_xyz, s_mask)


@_mxu_pack_op.register_fake
def _mxu_pack_fake(s_xyz, s_mask):
    return s_xyz.new_empty((_pack_bytes(s_xyz.shape[0]),), dtype=torch.uint8)


@_mxu_pack_op.register_kernel("cuda")
def _mxu_pack_cuda(s_xyz, s_mask):
    ns = _check_supports(s_xyz, s_mask)
    buf = torch.empty(_pack_bytes(ns), dtype=torch.uint8,
                      device=s_xyz.device)
    err = _lib("knn.cu", 3).mxu_pack_launch(
        s_xyz.data_ptr(), s_mask.data_ptr(), ns, -(-ns // 128) * 128,
        buf.data_ptr(), _stream(s_xyz.device))
    if err != 0:
        raise RuntimeError(f"mxu_pack launch failed: CUDA error {err}")
    mxu_pack_support.launches += 1
    return buf


def mxu_pack_support(s_xyz, s_mask):
    """The support operand of `knn3_mxu` as its kernel reads it: s_xyz
    [Ns, 3] f32, s_mask [Ns] bool → uint8 [ns_pad·32 + 16]. `knn3_mxu`
    launches the same pack kernel itself; this wrapper holds it against
    its plain version. The custom op `gridgcn::mxu_pack_support`."""
    _device(s_xyz, s_mask)
    return torch.ops.gridgcn.mxu_pack_support(s_xyz, s_mask)


mxu_pack_support.launches = 0


# ------------------------------------------------------- 3-NN wrapper --

def flash_three_nn(query_xyz, query_mask, support_xyz, support_mask,
                   k: int = 3, variant: str = "mxu"):
    """Batched k-NN with inverse-distance weights: query [B, Nq, 3] /
    [B, Nq], support [B, Ns, 3] / [B, Ns] → (idx [B, Nq, k] int64,
    weights [B, Nq, k] f32, found [B, Nq] bool), 1 ≤ k ≤ MAX_K.

    variant="mxu" (the decoder's) or "exact". Indices and distances carry
    no gradient, like the reference's zero-backward gridify_up."""
    check_k(k)
    if variant == "mxu":
        knn = knn3_mxu
    elif variant == "exact":
        knn = knn3_exact
    else:
        raise ValueError(f"unknown variant {variant!r}")
    outs = [knn(query_xyz[b], query_mask[b], support_xyz[b], support_mask[b],
                k) for b in range(query_xyz.shape[0])]
    d2 = torch.stack([o[0] for o in outs]).detach()
    idx = torch.stack([o[1] for o in outs]).long()
    valid = torch.stack([o[2] for o in outs])
    d2 = torch.clamp_min(d2, 0.0)
    w = torch.where(valid, 1.0 / (d2 + 1e-8), 0.0)
    w_sum = w.sum(dim=-1, keepdim=True)
    weights = torch.where(w_sum > 0, w / torch.clamp_min(w_sum, 1e-12), 0.0)
    return torch.where(valid, idx, 0), weights, valid.any(dim=-1)
