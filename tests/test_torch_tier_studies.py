"""The tier studies of the port (`scripts/study_tier2_compute_torch.py`,
`scripts/study_tier3_fixed_overhead_torch.py`) on the CPU: the tier-2
stage split composes exactly into the full forward, the tier-3 diff ranks
kernels by |Δ|, both scripts run with `--device cpu` in a process that
imports nothing of JAX, and the communication audit takes the measured
tier-2 share beside its byte model."""

import dataclasses
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

from gridgcn_torch.configs import presets  # noqa: E402
from gridgcn_torch.data.synthetic import synthetic_scene_surface  # noqa: E402
from gridgcn_torch.models.build import build_model, init_model  # noqa: E402
from gridgcn_torch.models.fold import fold_inference  # noqa: E402
from gridgcn_torch.parallel import comm_audit  # noqa: E402
from gridgcn_torch.utils import jaxrng, traceview  # noqa: E402
from scripts import study_tier2_compute_torch as t2  # noqa: E402
from scripts import study_tier3_fixed_overhead_torch as t3  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("method", ["pallas", "grid"])
def test_stage_split_composes_into_the_forward(method):
    """E0, then R, then the last stage and the head: the full forward's
    logits bit for bit, with the keys the forward draws (grid decoder
    stages included)."""
    cfg = presets.get("synthetic_tiny_seg")
    ups = tuple(dataclasses.replace(u, method=method)
                for u in cfg.model.up_layers)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, up_layers=ups))
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(1))
    cfg, folded = fold_inference(cfg, sd)
    model = build_model(cfg.model)
    model.load_state_dict(folded)
    model.eval()
    xyz = torch.as_tensor(np.stack([synthetic_scene_surface(300, seed=s)
                                    for s in (1, 2)]))
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool)
    mask[1, -40:] = False
    key = jaxrng.PRNGKey(4)
    with torch.no_grad():
        want = model(xyz, None, mask, key)
        lvl0 = t2.level0(model, xyz, None, mask)
        lvl1 = t2.encode0(model, lvl0, key)
        feat1 = t2.replicated(model, lvl1, key)
        got = t2.final(model, lvl0, lvl1, feat1, key)
    assert got.shape == want.shape == (2, 300, cfg.model.num_classes)
    assert torch.equal(got, want)
    keys = t2.decoder_keys(model, key)
    assert (all(k is not None for k in keys) if method == "grid"
            else keys == [None, None])


def _trace(dirpath: Path, events) -> str:
    dirpath.mkdir()
    (dirpath / "trace.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": dur,
         "args": {"device": 0, "stream": 7}} for n, ts, dur in events]}))
    return str(dirpath)


def test_tier3_diff_ranks_kernels_by_delta(tmp_path):
    """Two synthetic traces of 2 calls: per-kernel exclusive ms per call,
    the rows largest |Δ| first (a kernel only in one trace included), and
    the reference study's table."""
    plain = traceview.exclusive_ms(_trace(tmp_path / "p", [
        ("gather", 0.0, 10.0), ("scan", 20.0, 4.0), ("gemm", 30.0, 6.0),
        ("gather", 100.0, 10.0), ("scan", 120.0, 4.0),
        ("gemm", 130.0, 6.0)]), iters=2)
    tier3 = traceview.exclusive_ms(_trace(tmp_path / "t", [
        ("gather", 0.0, 16.0), ("scan", 20.0, 4.0), ("gemm", 30.0, 5.0),
        ("ghost_pack", 40.0, 3.0), ("gather", 100.0, 16.0),
        ("scan", 120.0, 4.0), ("gemm", 130.0, 5.0),
        ("ghost_pack", 140.0, 3.0)]), iters=2)
    assert plain == pytest.approx({"gather": 0.01, "scan": 0.004,
                                   "gemm": 0.006})
    rows = t3.diff_rows(plain, tier3)
    assert [r[3] for r in rows] == ["gather", "ghost_pack", "gemm", "scan"]
    assert [round(r[0], 6) for r in rows] == [0.006, 0.003, -0.001, 0.0]
    assert rows[1][1:3] == (pytest.approx(0.003), 0.0)
    lines = t3.report(plain, tier3, 2, "tier-3@1")
    assert lines[0] == ("busy/iter: plain 0.020 ms, tier-3@1 0.028 ms, "
                        "diff +0.008 (+40.0%)")
    assert lines[3].split() == ["+0.0060", "0.0160", "0.0100", "gather"]
    assert len(lines) == 5


def test_studies_run_on_the_cpu_without_jax(tmp_path):
    """Both scripts end to end with --device cpu (a tiny preset, 1 call
    each) in one fresh process, which imports nothing of JAX or the JAX
    package: busy values null, host wall times measured."""
    runs = [("study_tier2_compute_torch.py", "t2"),
            ("study_tier3_fixed_overhead_torch.py", "t3")]
    code = "import runpy, sys\n"
    for script, tag in runs:
        code += (
            f"sys.argv = ['{script}', '--device', 'cpu', '--iters', '1', "
            f"'--preset', 'synthetic_tiny_seg', '--trace-dir', "
            f"{str(tmp_path / tag)!r}]\n"
            "try:\n"
            f"    runpy.run_path({str(REPO / 'scripts' / script)!r}, "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n")
    code += ("bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'gridgcn_tpu'))\n"
             "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = {line.split(" ", 1)[0]: json.loads(line.split(" ", 1)[1])
             for line in res.stdout.splitlines()
             if line.startswith(("TIER2_COMPUTE ", "TIER3_OVERHEAD "))}
    a, b = lines["TIER2_COMPUTE"], lines["TIER3_OVERHEAD"]
    assert a["backend"] == b["backend"] == "cpu"
    for k in ("full_busy_ms", "replicated_busy_ms", "enc0_busy_ms",
              "measured_replicated_frac", "model_replicated_frac"):
        assert a[k] is None, k
    assert all(a["wall_ms"][k] > 0 for k in ("full", "replicated", "enc0"))
    assert b["plain_busy_ms"] is None and b["top"] is None
    assert b["plain_wall_ms"] > 0 and b["tier3_wall_ms"] > 0
    assert b["caps"] == [8, 8] and b["ghost_overflow"] == 0


def test_audit_projects_tier2_from_the_measured_share():
    """With the card's R/C the tier-2 projection uses it and the report
    carries the byte model beside it; the byte model stays the fallback;
    a share outside (0, 1) is refused."""
    cfg = presets.scannet_whole_scene()
    knn_ms = [0.01, 0.02, 0.05, 0.3]
    kw = dict(compute_ms_per_step=10.0, tax_fit={"eval": (0.1, 0.2)})
    model = comm_audit.comm_report(cfg, 4, knn_ms=knn_ms, **kw)
    both = comm_audit.comm_report(cfg, 4, knn_ms=knn_ms, tier2_frac=0.25,
                                  **kw)
    only = comm_audit.comm_report(cfg, 4, tier2_frac=0.25, **kw)
    frac = comm_audit.tier2_replicated_fraction(cfg, knn_ms)
    assert model["tier2"]["replicated_frac"] == frac
    assert both["tier2"]["replicated_frac"] == 0.25
    assert both["tier2"]["replicated_frac_measured"] == 0.25
    assert both["tier2"]["replicated_frac_model"] == frac
    assert only["tier2"]["replicated_frac_model"] is None
    D, t = 4, both["tier2"]["time_ms"]
    assert both["projection"]["tier2_inference_efficiency"] == \
        pytest.approx(10.0 / (0.75 * 10.0 + 0.25 * 10.0 * D + t))
    assert only["projection"] == both["projection"]
    assert comm_audit.tier2_replicated_fraction(cfg, None, 0.3) == 0.3
    assert comm_audit.tier2_replicated_fraction(cfg) is None
    for bad in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError, match="share"):
            comm_audit.comm_report(cfg, 4, tier2_frac=bad)
