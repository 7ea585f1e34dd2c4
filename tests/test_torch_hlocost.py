"""The port's byte/row/flop attribution of `torch.export` programs
(gridgcn_torch.utils.hlocost), on the CPU: the JAX package's four
accounting invariants (tests/test_hlocost.py) on exported graphs.

Eager PyTorch launches one kernel per ATen node where XLA fuses several,
so the dense program's bound holds per launched kernel; the gather
program is also run through the JAX package's attribution of its
compiled HLO, which counts the same 1000 rows; a scatter's rows are
counted in its updates' elements whatever their width (the JAX package
divides the updates' bytes by 4); and the tiny segmentation forward,
exported as `export.py` writes it and loaded back, prices its decoder's
`gridgcn::knn3_mxu` calls at 32 operations per (query, support) pair.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridgcn_tpu.utils import hlocost as jhlocost
from gridgcn_torch import export
from gridgcn_torch.configs import presets
from gridgcn_torch.kernels import knn  # noqa: F401  (the custom ops)
from gridgcn_torch.models.build import build_model, numpy_state_dict
from gridgcn_torch.train import steps
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.checkpoint import CheckpointManager
from gridgcn_torch.utils.hlocost import attribute, class_totals, floor_ms
from gridgcn_torch.utils.hw import BF16_OPS_PER_S, FP32_OPS_PER_S

torch.set_num_threads(1)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _rows(fn, *args):
    return attribute(torch.export.export(_Fn(fn), args, strict=False))


def test_dense_program_charges_operands_and_output():
    x = torch.zeros((1024, 256), dtype=torch.float32)     # 1 MB

    rows = _rows(lambda a: a * 2.0 + 1.0, x)
    # two kernels (mul, add), each reading 1 MB and writing 1 MB
    assert sorted(r["opcode"] for r in rows) == ["aten.add", "aten.mul"]
    for r in rows:
        assert 1.9e6 < r["touched"] < 2.4e6, r
        assert r["class"] == "fusion" and r["flops"] == 0
    # dense programs: touched == dense accounting
    assert sum(r["touched"] for r in rows) == sum(r["bytes"] for r in rows)


def test_gather_discounted_to_touched_rows():
    table = np.zeros((1_000_000,), np.float32)            # 4 MB
    idx = np.zeros((1000,), np.int32)                     # 1k rows = 4 KB

    rows = _rows(lambda t, i: (t * 2.0)[i].sum(), torch.from_numpy(table),
                 torch.from_numpy(idx))
    dense = sum(r["bytes"] for r in rows)
    touched = sum(r["touched"] for r in rows)
    # the multiply reads+writes the 4 MB table (8 MB); the gather touches
    # 1000 sectors + indices + output — dense accounting additionally
    # bills the full 4 MB operand
    assert touched < dense, (touched, dense)
    assert touched < 9.5e6, touched
    cls = class_totals(rows)
    assert cls["gather"]["rows"] == 1000
    assert cls["gather"]["touched"] == 1000 * 32 + 4000 + 4000
    fl = floor_ms(rows)
    assert fl["rows"] == 1000 and fl["row_ms"] == 0.0
    assert fl["floor_ms"] == fl["bw_ms"] > 0
    assert fl["touched_bytes"] == touched

    # the JAX package's attribution of the same program counts the same
    # gathered rows
    text = jax.jit(lambda t, i: (t * 2.0)[i].sum()).lower(
        jnp.asarray(table), jnp.asarray(idx)).compile().as_text()
    assert jhlocost.class_totals(jhlocost.attribute(text))["gather"][
        "rows"] == 1000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int16], ids=str)
def test_scatter_charges_updates_not_base(dtype):
    base = torch.zeros((1_000_000,), dtype=dtype)
    idx = torch.arange(1000)
    upd = torch.ones((1000,), dtype=dtype)

    rows = _rows(lambda b, i, u: b.index_put((i,), u).sum(), base, idx, upd)
    sc = [r for r in rows if r["class"] == "scatter"]
    assert len(sc) == 1
    # the scatter row itself is not billed the base twice: indices and
    # updates read, 1000 rows of one sector written
    assert sc[0]["touched"] <= sc[0]["bytes"]
    assert sc[0]["touched"] == 8000 + 1000 * upd.element_size() + 1000 * 32
    # rows are the updates' elements, at any element width
    assert sc[0]["rows"] == 1000 == class_totals(rows)["scatter"]["rows"]
    # the total stays near the real traffic: the sum's read of the result
    # plus the scatter's rows, not a base double-bill
    assert sum(r["touched"] for r in rows) < 1.35e7


def test_views_launch_nothing_copies_do():
    """Views, broadcasts and in-place metadata ops get no row; a
    `contiguous` of a permuted view, a `reshape` that cannot be a view and
    a `to` that changes the dtype do, and a broadcast operand is read
    once."""
    x = torch.zeros((64, 32))

    def fn(a):
        v = a.view(32, 64).permute(1, 0)                  # views
        w = a.to(torch.float32).reshape(2048)             # views
        c = v.contiguous()                                # copies
        r = v.reshape(2048)                               # copies
        h = a.to(torch.bfloat16)                          # copies
        d = a.clone().detach_()                           # clone only
        e = a[:1].expand(64, 32) + 1.0                    # reads one row
        return v, w, c, r, h, d, e

    rows = {r["name"]: r for r in _rows(fn, x)}
    assert sorted(rows) == ["add", "clone", "contiguous", "reshape_1",
                            "to_1"], sorted(rows)
    assert rows["contiguous"]["touched"] == rows["reshape_1"]["touched"] \
        == 2 * 8192
    assert rows["to_1"]["touched"] == 8192 + 4096
    assert rows["add"]["touched"] == 128 + 8192


def test_dot_flops_and_peaks():
    """2·(output elements)·(contracted length) for every dot form, priced
    at the bf16 tensor-core peak for 16-bit operands and at the fp32 one
    otherwise."""
    a = torch.zeros((8, 16, 32))
    b = torch.zeros((8, 32, 24))
    w = torch.zeros((24, 32))
    m = torch.zeros((16, 32), dtype=torch.bfloat16)
    n = torch.zeros((32, 24), dtype=torch.bfloat16)
    c = torch.zeros(24)

    def fn(a, b, w, m, n, c):
        return (torch.bmm(a, b), a @ b, torch.nn.functional.linear(a, w),
                torch.mm(m, n), torch.addmm(c, a[0], b[0]),
                torch.einsum("bij,bjk->bik", a, b),
                torch.einsum("...ij,...jk", a, b))

    rows = sorted(_rows(fn, a, b, w, m, n, c), key=lambda r: r["name"])
    assert all(r["class"] == "dot" for r in rows)
    want = {"bmm": 2 * 8 * 16 * 24 * 32, "matmul": 2 * 8 * 16 * 24 * 32,
            "linear": 2 * 8 * 16 * 24 * 32, "mm": 2 * 16 * 24 * 32,
            "addmm": 2 * 16 * 24 * 32, "einsum": 2 * 8 * 16 * 24 * 32,
            "einsum_1": 2 * 8 * 16 * 24 * 32}
    assert {r["name"]: r["flops"] for r in rows} == want
    assert {r["name"] for r in rows if r["peak"] == "bf16"} == {"mm"}
    fl = floor_ms(rows)
    assert fl["flops_ms"] == pytest.approx(
        (sum(want.values()) - want["mm"]) / FP32_OPS_PER_S * 1e3
        + want["mm"] / BF16_OPS_PER_S * 1e3)


@pytest.fixture(scope="module")
def tiny_program(tmp_path_factory):
    """synthetic_tiny_seg (knn3_mxu decoder) exported at [2, 256] from a
    step-0 checkpoint of numpy-seeded weights, loaded back."""
    tmp = tmp_path_factory.mktemp("hlocost")
    cfg = presets.get("synthetic_tiny_seg")
    ups = tuple(dataclasses.replace(u, method="pallas")
                for u in cfg.model.up_layers)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, up_layers=ups))
    state = steps.create_train_state(
        cfg, build_model(cfg.model), numpy_state_dict(cfg.model, 0), 1,
        device="cpu")
    CheckpointManager(str(tmp / "ck"), cfg).save(0, state,
                                                 jaxrng.PRNGKey(0))
    path = str(tmp / "seg.pt2")
    export.export_predictor(str(tmp / "ck"), path, batch_size=2,
                            num_points=256, device="cpu")
    return cfg, torch.export.load(path)


def test_attribution_covers_a_model_forward(tiny_program):
    """End-to-end on the real model graph (tiny config, CPU): the JAX
    package's classes, every class total non-negative, gathers counted,
    and the decoder's 4 knn3_mxu calls (2 clouds x 2 stages) priced at 32
    operations per pair on the tensor cores."""
    cfg, program = tiny_program
    rows = attribute(program)
    assert len(rows) > 50
    cls = class_totals(rows)
    assert set(cls) <= {"fusion", "gather", "scatter", "sort", "dot",
                        "custom-call"}
    assert cls.get("gather", {}).get("rows", 0) > 0
    assert all(v["touched"] >= 0 and v["flops"] >= 0 for v in cls.values())
    assert sum(v["touched"] for v in cls.values()) > 0
    assert cls["dot"]["flops"] > 0

    # each decoder stage: the finer level's points query the coarser's
    levels = [cfg.data.num_points] + [s.n_centers for s in cfg.model.layers]
    pairs = [levels[i] * levels[i + 1] for i in range(len(levels) - 1)]
    mxu = [r for r in rows if r["opcode"] == "gridgcn.knn3_mxu"]
    assert all(r["class"] == "custom-call" and r["peak"] == "bf16"
               for r in mxu)
    assert sorted(r["flops"] for r in mxu) == sorted(32 * p for p in pairs
                                                     for _ in range(2))
    fl = floor_ms(rows)
    assert fl["flops"] == sum(r["flops"] for r in rows)
    assert fl["flops_ms"] > 0 and fl["floor_ms"] > 0
