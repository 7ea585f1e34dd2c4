"""Package-level properties of the port: it stands alone (no JAX, nothing
of the JAX package), builds nothing at import, runs on CUDA unless asked
for the CPU, and carries its own copies of configs and data."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gridgcn_torch
from gridgcn_torch.configs import base as tbase
from gridgcn_torch.configs import presets as tpresets

torch.set_num_threads(1)

PKG = Path(gridgcn_torch.__file__).resolve().parent
REPO = PKG.parent
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gridgcn_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 15


def test_training_modules_are_part_of_the_standalone_check():
    """The training slice's modules, and the CLIs' with their data,
    checkpoint, logging, debug and profiling modules and the trace and
    cost tools, are among those the check above imports without JAX."""
    for m in ("gridgcn_torch.train.steps", "gridgcn_torch.train.metrics",
              "gridgcn_torch.data.augment", "gridgcn_torch.data.pipeline",
              "gridgcn_torch.train.train", "gridgcn_torch.train.evaluate",
              "gridgcn_torch.data.native", "gridgcn_torch.data.synthetic",
              "gridgcn_torch.data.modelnet40", "gridgcn_torch.data.s3dis",
              "gridgcn_torch.data.scannet", "gridgcn_torch.utils.checkpoint",
              "gridgcn_torch.utils.logging", "gridgcn_torch.utils.debug",
              "gridgcn_torch.utils.profiling",
              "gridgcn_torch.utils.traceview",
              "gridgcn_torch.utils.hlocost"):
        assert m in MODULES, m


def test_sources_never_name_the_jax_package():
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu")]
    assert any(p.suffix == ".cu" for p in files)
    for p in files:
        text = p.read_text()
        assert "gridgcn_tpu" not in text, p
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax)\b",
                             text, re.M), p


def test_kernels_import_calls_no_nvcc():
    """Importing the kernel module (in a fresh interpreter) starts no
    process and builds nothing; the launch counters start at 0."""
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'process started at import: {a}')\n"
        "subprocess.Popen = subprocess.run = refuse\n"
        "import gridgcn_torch.kernels.knn as knn\n"
        "import gridgcn_torch.kernels.rng as rng\n"
        "assert knn.knn3_mxu.launches == 0 == knn.knn3_exact.launches\n"
        "assert not knn._libs and not rng._lib_cache\n"
        "assert not any(rng.launches.values())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_predictor_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from gridgcn_torch.api import Predictor
    from gridgcn_torch.models.build import init_model

    cfg = tpresets.get("synthetic_tiny_seg")
    ups = tuple(dataclasses.replace(u, method="pallas")
                for u in cfg.model.up_layers)
    layers = tuple(dataclasses.replace(l, approx_select=True)
                   for l in cfg.model.layers)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, up_layers=ups, layers=layers))
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(cfg, sd)
    pred = Predictor(cfg, sd, device="cpu")
    xyz = np.random.default_rng(0).uniform(-1, 1, (256, 3))
    out = pred(xyz)
    assert out.shape == (256, cfg.model.num_classes)
    assert np.isfinite(out).all()


def test_unported_entry_points_raise():
    """The resident tiers' misuses raise: `predict_scenes` without a mesh,
    an unknown tier, a 2-D mesh outside a process group. Mesh serving runs
    inside a process group (`tests/test_torch_dp.py`); outside one it says
    how to start one. A one-rank mesh needs no group: predict_scene
    shards the scene over it with tier 3 (`tests/test_torch_resident.py`
    holds the tiers against JAX's)."""
    from gridgcn_torch import api
    from gridgcn_torch.models.build import init_model
    from gridgcn_torch.parallel.mesh import Mesh

    cfg = tpresets.get("synthetic_tiny_seg")
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="parallel.launch or torchrun"):
        api.Predictor(cfg, sd, device="cpu", mesh=2)
    pred = api.Predictor(cfg, sd, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh Predictor"):
        pred.predict_scenes(np.zeros((2, 256, 3), np.float32))
    with pytest.raises(ValueError, match="spatial tier"):
        pred.predict_scene(np.zeros((256, 3), np.float32), spatial="ring")
    one = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"))
    meshed = api.Predictor(cfg, sd, device="cpu", mesh=one)
    xyz = np.random.default_rng(0).uniform(0, 4, (256, 3)).astype(np.float32)
    out = meshed.predict_scene(xyz)
    assert out.shape == (256, cfg.model.num_classes)
    assert np.isfinite(out).all() and (np.abs(out).sum(-1) > 0).all()
    with pytest.raises(RuntimeError, match="no process group"):
        meshed.predict_scenes(xyz[None])


def test_parallel_export_and_fps_modules_are_in_the_standalone_check():
    """The data-parallel, export and baseline modules are among those the
    standalone check imports without JAX."""
    for m in ("gridgcn_torch.parallel.mesh", "gridgcn_torch.parallel.dp",
              "gridgcn_torch.parallel.launch",
              "gridgcn_torch.parallel.spatial", "gridgcn_torch.export",
              "gridgcn_torch.parallel.resident",
              "gridgcn_torch.parallel.resident_ml",
              "gridgcn_torch.parallel.spatial_train",
              "gridgcn_torch.ops.fps", "gridgcn_torch.utils.precision"):
        assert m in MODULES, m


def test_audit_dryrun_and_convergence_stand_alone():
    """The communication audit, the card's figures and the dry run are
    among the modules the standalone check imports; the convergence
    script and chip_smoke.py import no JAX and nothing of the JAX
    package either (chip_smoke.py names the TPU kernels its kernels
    replace, as its kernels line must)."""
    for m in ("gridgcn_torch.parallel.comm_audit", "gridgcn_torch.utils.hw",
              "gridgcn_torch.dryrun"):
        assert m in MODULES, m
    files = [REPO / "scripts" / "convergence_torch.py", REPO / "chip_smoke.py"]
    code = (
        "import importlib.util, sys\n"
        f"for i, f in enumerate({[str(f) for f in files]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'm{i}', f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gridgcn_tpu'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for f in files:
        text = f.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                             r"gridgcn_tpu)\b", text, re.M), f


def test_configs_are_a_copy_of_the_jax_presets():
    from gridgcn_tpu.configs import base as jbase
    from gridgcn_tpu.configs import presets as jpresets

    assert sorted(tpresets.PRESETS) == sorted(jpresets.PRESETS)
    for name in jpresets.PRESETS:
        assert tbase.to_dict(tpresets.get(name)) == \
            jbase.to_dict(jpresets.get(name)), name
    cfg = tbase.apply_overrides(tpresets.get("scannet_whole_scene"),
                                {"data.batch_size": 2})
    assert cfg.data.batch_size == 2
    assert tbase.from_json(tbase.to_json(cfg)) == cfg


def test_synthetic_scene_is_a_copy():
    from gridgcn_tpu.data.synthetic import synthetic_scene_surface as jscene
    from gridgcn_torch.data.synthetic import synthetic_scene_surface

    for seed in (0, 7):
        np.testing.assert_array_equal(synthetic_scene_surface(4096, seed),
                                      jscene(4096, seed))
    a, la = synthetic_scene_surface(1000, 3, return_labels=True)
    b, lb = jscene(1000, 3, return_labels=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
