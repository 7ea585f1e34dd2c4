"""The comm audit's ghost-tax model and training projection, the mesh-1
study that feeds them (`scripts/study_mesh1_overhead_torch.py`) and the
profiling helpers the port's studies time with, on the CPU.

`ghost_compute_tax` is held to the JAX package's formula at the same
(fixed, coeff): JAX's measured constants are patched in this process
only. The study runs end to end with `--device cpu` at a tiny preset in
a one-rank gloo group: its busy values and fit are null there, and its
host-clock fit has one point per ghost cap."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from gridgcn_tpu.configs import presets as jpresets  # noqa: E402
from gridgcn_tpu.parallel import comm_audit as jaudit  # noqa: E402
from gridgcn_torch.configs import presets as tpresets  # noqa: E402
from gridgcn_torch.parallel import comm_audit as audit  # noqa: E402
from gridgcn_torch.utils import hw, profiling  # noqa: E402
from scripts import study_mesh1_overhead_torch as mesh1  # noqa: E402

torch.set_num_threads(1)

FIT = (0.0123, 0.0456)
TRAIN_FIT = (0.0311, 0.0207)
PRESETS = ("scannet_seg", "scannet_whole_scene", "s3dis_seg",
           "synthetic_tiny_seg")


def _caps(cfg, kind):
    n = len(cfg.model.layers)
    return {"zero": 0, "scalar": 24,
            "levels": tuple(8 * (i + 1) for i in range(n))}[kind]


@pytest.fixture
def jax_fit(monkeypatch):
    """Set the JAX audit's module-level fit (and drop its per-preset
    table, so every config takes it) in this process."""
    def use(fixed, coeff):
        monkeypatch.setattr(jaudit, "GHOST_TAX_FIXED", fixed)
        monkeypatch.setattr(jaudit, "GHOST_TAX_COEFF", coeff)
        monkeypatch.setattr(jaudit, "MEASURED_GHOST_TAX", {})
    return use


@pytest.mark.parametrize("caps", ["zero", "scalar", "levels"])
@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("name", PRESETS)
def test_ghost_tax_is_the_references_formula(jax_fit, name, D, caps):
    """fixed + coeff · Σ 2H / Σ (M/D), the same float at the same
    constants, at every rank count and cap form."""
    jax_fit(*FIT)
    cj, ct = jpresets.get(name), tpresets.get(name)
    c = _caps(ct, caps)
    got = audit.ghost_compute_tax(ct, D, c, *FIT)
    assert got == jaudit.ghost_compute_tax(cj, D, c)
    jax_fit(*TRAIN_FIT)
    assert audit.ghost_compute_tax(ct, D, c, *TRAIN_FIT) == \
        jaudit.ghost_compute_tax(cj, D, c, train=True)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_report_taxes_at_d_and_caps(jax_fit, D):
    """The report carries the eval and train taxes at its D and caps (JAX's
    `report["tier3"]` keys), and the projection uses them: the tier-3
    efficiencies follow compute / (compute · (1 + tax) + transfer) with
    the train row on the train time, the train tax and the counted
    training bytes."""
    cfg = tpresets.scannet_whole_scene()
    caps = tuple(max(8, layer.n_centers // D // 4)
                 for layer in cfg.model.layers)
    fit = {"eval": FIT, "train": TRAIN_FIT}
    rep = audit.comm_report(cfg, D, ghost_cap=caps, compute_ms_per_step=4.0,
                            train_ms_per_step=20.0, tax_fit=fit,
                            tier2_frac=0.5)
    t3, p = rep["tier3"], rep["projection"]
    jax_fit(*FIT)
    assert t3["ghost_compute_tax"] == jaudit.ghost_compute_tax(
        jpresets.get("scannet_whole_scene"), D, caps)
    assert t3["ghost_compute_tax_train"] == audit.ghost_compute_tax(
        cfg, D, caps, *TRAIN_FIT)
    assert t3["tax_fit"] == {"eval": list(FIT), "train": list(TRAIN_FIT)}
    t_train = (t3["train_bytes_per_dir_per_chip"] + 2 * (D - 1) / D
               * t3["train_allreduce_payload_bytes"]) \
        / hw.NVLINK_BYTES_PER_S * 1e3
    assert p["tier3_inference_efficiency"] == pytest.approx(
        4.0 / (4.0 * (1 + t3["ghost_compute_tax"]) + t3["time_ms"]))
    assert p["tier3_train_efficiency"] == pytest.approx(
        20.0 / (20.0 * (1 + t3["ghost_compute_tax_train"]) + t_train))
    assert p["train_ms_per_shard"] == 20.0
    # a larger cap costs more at the same D
    full = audit.comm_report(cfg, D, tax_fit=fit)["tier3"]
    assert full["ghost_compute_tax"] > t3["ghost_compute_tax"]


def test_report_refuses_a_projection_without_the_fits():
    """No fit, no projection; a train time without the train fit is
    refused; without a train time the train row is null, not priced from
    the forward."""
    cfg = tpresets.scannet_whole_scene()
    kw = dict(compute_ms_per_step=4.0, tier2_frac=0.5)
    with pytest.raises(ValueError, match="eval fit"):
        audit.comm_report(cfg, 4, **kw)
    with pytest.raises(ValueError, match="eval fit"):
        audit.comm_report(cfg, 4, tax_fit={"train": TRAIN_FIT}, **kw)
    with pytest.raises(ValueError, match="train fit"):
        audit.comm_report(cfg, 4, tax_fit={"eval": FIT},
                          train_ms_per_step=20.0, **kw)
    rep = audit.comm_report(cfg, 4, tax_fit={"eval": FIT}, **kw)
    assert rep["projection"]["tier3_train_efficiency"] is None
    assert rep["projection"]["train_ms_per_shard"] is None
    assert rep["tier3"]["ghost_compute_tax_train"] is None
    bare = audit.comm_report(cfg, 4)["tier3"]
    assert bare["ghost_compute_tax"] is None and bare["tax_fit"] is None


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_affine_fit_recovers_known_constants(noise):
    """Four points on fixed + coeff · ratio (the sweep's ratios) give the
    constants back, exactly without noise and within the noise with it;
    the residual is the noise's RMS about the fitted line."""
    ratios = [2.0, 1.0, 0.5, 0.25]
    eps = noise * np.array([1.0, -1.0, -1.0, 1.0])
    over = [0.02 + 0.15 * r + e for r, e in zip(ratios, eps)]
    fit = mesh1.affine_fit(ratios, over)
    assert fit["fixed"] == pytest.approx(0.02, abs=2 * noise + 1e-12)
    assert fit["coeff"] == pytest.approx(0.15, abs=2 * noise + 1e-12)
    res = np.asarray(over) - (fit["fixed"] + fit["coeff"] *
                              np.asarray(ratios))
    assert fit["rms_residual"] == pytest.approx(np.sqrt(np.mean(res ** 2)),
                                                abs=1e-15)
    assert (fit["rms_residual"] > 1e-12) == (noise > 0)


def test_sweep_caps_and_ratios():
    """The full share is ratio 2; share/div caps at max(8, M // div)."""
    cfg = tpresets.scannet_whole_scene()
    assert mesh1.share_caps(cfg, 0) == (8192, 2048, 512, 128)
    assert mesh1.share_caps(cfg, 8) == (1024, 256, 64, 16)
    assert mesh1.ghost_ratio(cfg, mesh1.share_caps(cfg, 0)) == 2.0
    assert mesh1.ghost_ratio(cfg, mesh1.share_caps(cfg, 8)) == 0.25
    assert mesh1.scene_config("scannet_seg", True).data.num_points == 65536
    assert mesh1.scene_config("scannet_whole_scene", False).name == \
        "scannet_whole_scene"


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_study_runs_on_the_cpu(tmp_path, mode):
    """The study end to end with --device cpu --ghost-sweep at
    synthetic_tiny_seg, one call a timing: one-rank gloo, busy values
    and the busy fit null (a CPU trace reads None), the host-clock fit
    over 4 points, no ghost overflow, tier 2 in eval mode only; the
    script's own process imports nothing of JAX."""
    script = REPO / "scripts" / "study_mesh1_overhead_torch.py"
    argv = ["--device", "cpu", "--iters", "1", "--ghost-sweep", "--preset",
            "synthetic_tiny_seg", "--trace-dir", str(tmp_path)]
    argv += ["--train"] if mode == "train" else []
    code = ("import runpy, sys\n"
            f"sys.argv = [{str(script)!r}] + {argv!r}\n"
            "try:\n"
            f"    runpy.run_path({str(script)!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'gridgcn_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads([line for line in res.stdout.splitlines()
                      if line.startswith("MESH1_OVERHEAD ")][-1]
                     .split(" ", 1)[1])
    assert out["mode"] == mode and out["backend"] == "cpu"
    assert out["plain"]["busy_ms"] is None and out["plain"]["wall_ms"] > 0
    pts = out["tier3"]
    assert [p["div"] for p in pts] == [0, 2, 4, 8]
    assert [p["ratio"] for p in pts] == pytest.approx([2.0, 1.0, 0.6, 0.4])
    assert all(p["busy_ms"] is None and p["overhead"] is None
               and p["wall_ms"] > 0 and p["ghost_overflow"] == 0
               for p in pts)
    assert out["fit"] is None
    assert set(out["fit_wall"]) == {"fixed", "coeff", "rms_residual"}
    assert (out["tier2"] is not None) == (mode == "eval")
    assert out["retaken"] == 0


def _busy_after(refusals):
    """A fake run: one timed_trace record per call, refused the first
    `refusals` times."""
    calls = []

    def run():
        calls.append(1)
        rec = {"wall_ms": 1.0, "busy_ms": None}
        if len(calls) <= refusals:
            rec["refused"] = "lost the kernel records of 1 of its 2"
        else:
            rec["busy_ms"] = 0.5
        return [rec]
    return run, calls


def test_retaking_reruns_refused_traces(capsys):
    """A refused record is never returned: the run is taken again while
    any record was refused, up to the retake budget, then it raises."""
    run, calls = _busy_after(2)
    recs, n = profiling.retaking(run, retakes=2)
    assert n == 2 and len(calls) == 3 and recs[0]["busy_ms"] == 0.5
    assert capsys.readouterr().out.count("taken again") == 2
    run, calls = _busy_after(5)
    with pytest.raises(RuntimeError, match="3 times"):
        profiling.retaking(run, retakes=2)
    assert len(calls) == 3


def test_timed_trace_and_fresh_process_on_the_cpu(tmp_path):
    """timed_trace on the CPU: a host-clock time, busy None (a CPU trace),
    the counter's growth per traced call; in_fresh_process runs in
    another process and returns its result."""
    count = [0]

    def fn():
        count[0] += 3
        return torch.ones(4).sum()
    rec = profiling.timed_trace(fn, 2, str(tmp_path / "tr"), "cpu",
                                counter=lambda: count[0])
    assert rec["wall_ms"] > 0 and rec["busy_ms"] is None
    assert rec["per_call"] == 3.0 and "refused" not in rec
    assert (tmp_path / "tr" / "trace.json").exists()
    assert profiling.in_fresh_process(pow, 7, 2) == 49
    assert profiling.in_fresh_process(os.getpid) != os.getpid()
