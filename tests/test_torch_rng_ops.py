"""The draws' custom ops (`kernels.rng`) on the CPU: their fake
implementations against the plain version's shapes and types, a
`torch.export` that traces a draw with a tensor key through
`gridgcn::rng_draw_keys`, numpy and tensor keys against each other, the CUDA
source's constants against `utils.xla_math`, and the number of draws a
served forward makes (what the kernel's launch counter reads on the card)."""

import re

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from gridgcn_torch.kernels import rng
from gridgcn_torch.utils import jaxrng, xla_math

torch.set_num_threads(1)

KEY = jaxrng.fold_in(jaxrng.PRNGKey(2 ** 31 + 7), 5)


@pytest.mark.parametrize("epilogue", rng.EPILOGUES)
@pytest.mark.parametrize("rows", [0, 1, 3])
def test_fake_implementations_match_the_plain_version(epilogue, rows):
    """rows 0: one key [2] → [4, 5]; else [rows, 2] keys → [rows, 4, 5]."""
    keys = KEY if rows == 0 else jaxrng.split(KEY, rows)
    lead = () if rows == 0 else (rows,)
    args = (lead + (4, 5), 3, epilogue, 0.0, 1.0)
    want = torch.ops.gridgcn.rng_draw_keys(jaxrng.key_tensor(keys), *args)
    with FakeTensorMode() as mode:
        got = torch.ops.gridgcn.rng_draw_keys(
            mode.from_tensor(jaxrng.key_tensor(keys)), *args)
    assert (got.shape, got.dtype, got.device) == \
        (want.shape, want.dtype, want.device)
    assert want.shape == lead + (4, 5)
    assert want.dtype == (torch.int64 if epilogue == "bits"
                          else torch.float32)


class _Draws(torch.nn.Module):
    def forward(self, key):
        keys = jaxrng.split(key, 3)
        return (jaxrng.bits(key, (3, 50)),
                jaxrng.uniform(keys[0], (70,), key.device, -5.0, 2.5),
                jaxrng.gumbel(keys, (40,), key.device),
                jaxrng.bernoulli(keys[1], 0.3, (2, 9), key.device, row0=1),
                jaxrng.permutation(keys[2], 300, key.device))


def test_export_traces_the_draw_op():
    """A tensor key is an input of the program, every draw one
    `gridgcn::rng_draw_keys` node and no threefry round: the program run
    under another key gives that key's draws."""
    program = torch.export.export(
        _Draws(), (jaxrng.key_tensor(KEY),), strict=False)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("gridgcn.rng_draw_keys.default") == 5
    assert not any("bitwise_xor" in t for t in targets
                   if "rng_draw" not in t)
    other = jaxrng.fold_in(KEY, 1)
    got = program.module()(jaxrng.key_tensor(other))
    keys = jaxrng.split(other, 3)
    want = (jaxrng.bits(other, (3, 50)),
            jaxrng.uniform(keys[0], (70,), "cpu", -5.0, 2.5),
            jaxrng.gumbel(keys, (40,)),
            jaxrng.bernoulli(keys[1], 0.3, (3, 9))[1:],
            jaxrng.permutation(keys[2], 300))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("epilogue", rng.EPILOGUES)
def test_numpy_and_tensor_keys_agree_on_the_cpu(epilogue):
    """numpy keys and the same keys as a tensor give the same draw, row for
    row, and each row is the draw under its own key, also from a strided
    view of the keys. The CPU launches nothing."""
    keys = jaxrng.split(KEY, 17)
    before = dict(jaxrng.launches)
    numpy = rng.draw(keys, (33,), "cpu", epilogue=epilogue)
    assert torch.equal(numpy, rng.draw(jaxrng.key_tensor(keys), (33,),
                                       "cpu", epilogue=epilogue))
    assert torch.equal(numpy[16], rng.draw(keys[16], (33,), "cpu",
                                           epilogue=epilogue))
    assert torch.equal(numpy[::2], rng.draw(keys[::2], (33,), "cpu",
                                            epilogue=epilogue))
    assert jaxrng.launches == before


def test_kernel_source_constants():
    """`csrc/rng.cu` cannot run here: its rotations, key-schedule constant
    and the log's float32 constants are held against the plain version's,
    and its build against contraction (-fmad=false)."""
    src = rng.SOURCE.read_text()
    rot = [tuple(int(r) for r in re.findall(r"ROUND\((\d+)\)", line))
           for line in src.splitlines() if line.startswith("#define ROUNDS_")]
    assert rot == [tuple(r) for r in rng._ROTATIONS]
    assert "0x1BD11BDAu" in src and "-fmad=false" in rng.NVCC_EXTRA
    body = src[src.index("__device__ float xla_log"):]
    body = body[:body.index("\n}\n")]
    hexes = [float.fromhex(h[:-1]) for h in
             re.findall(r"-?0x1(?:\.[0-9a-f]+)?p-?\d+f", body)]
    tiny = float.fromhex(re.search(r"kTiny = (0x1p-126)f", src)[1])
    assert tiny == xla_math.TINY
    sqrt_half = xla_math._f32(0.707106781186547524)
    assert hexes == [sqrt_half, *xla_math._LOG_P,
                     xla_math._f32(-2.12194440e-4), 0.693359375]


@pytest.mark.parametrize("preset,batch,points,want", [
    ("scannet_whole_scene", 1, 4096, {"bits": 4, "uniform": 4}),
    ("scannet_seg", 2, 2048, {"bits": 13, "gumbel": 10})])
def test_served_forward_draws(monkeypatch, preset, batch, points, want):
    """The draws of one served forward, by epilogue: on the card each is
    one kernel launch (8 a whole scene, 23 a batch of crops: what the
    launch counter and `rng_launches_per_request.serve` read there)."""
    from gridgcn_torch.api import Predictor
    from gridgcn_torch.configs import presets
    from gridgcn_torch.models.build import init_model

    seen = {}
    real = rng.draw

    def counting(key, shape, device, off=0, epilogue="bits", lo=0.0,
                 scale=1.0):
        seen[epilogue] = seen.get(epilogue, 0) + 1
        return real(key, shape, device, off, epilogue, lo, scale)

    cfg = presets.get(preset)
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    pred = Predictor(cfg, sd, device="cpu")
    xyz = np.random.default_rng(0).uniform(
        0.0, 4.0, (batch, points, 3)).astype(np.float32)
    monkeypatch.setattr(rng, "draw", counting)
    pred(xyz)
    assert seen == want


def test_build_runs_nvcc_once(monkeypatch, tmp_path):
    """`rng.build_kernel` through `knn.compile_libraries`, with a stand-in
    for nvcc: the library and its log (the compiler's report, then the
    seconds) land in the build directory under the source's hash, a
    second call finds them and starts no compiler, and a failing compiler
    raises with its report."""
    from gridgcn_torch.kernels import knn

    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo "ptxas info    : Used 16 registers"\n'
        'echo built > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(knn, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(knn, "BUILD_DIR", tmp_path / "build")
    log = rng.build_kernel()
    assert "Used 16 registers" in log and log.splitlines()[-1].startswith(
        "nvcc: ")
    assert rng._lib_path().read_text() == "built\n"
    assert rng.build_kernel() == log
    assert calls.read_text() == "x\n"
    nvcc.write_text("#!/bin/sh\necho 'rng.cu(1): error'\nexit 2\n")
    monkeypatch.setattr(rng, "SOURCE", tmp_path / "rng.cu")
    rng.SOURCE.write_text("// another source, another hash")
    with pytest.raises(RuntimeError, match="nvcc failed on rng.cu"):
        rng.build_kernel()
