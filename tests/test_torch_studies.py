"""The port's counterparts of the JAX package's remaining study scripts:
`scripts/{study_mesh1_overhead,study_cas_premium,study_train_leads,
study_selective_precision,capacity_sweep,cas_study}_torch.py`. Each
takes the JAX script's arguments (the same flags and defaults) plus
`--device` (and `--trace-dir` where it traces), imports nothing of JAX,
the JAX package or the tests' oracle, and `cas_study_torch` gives the JAX
study's coverage counts bit for bit (the port's samplers draw the
reference's centers)."""

import argparse
import ast
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from scripts import capacity_sweep as jcapacity  # noqa: E402
from scripts import capacity_sweep_torch as tcapacity  # noqa: E402
from scripts import cas_study as jcas  # noqa: E402
from scripts import cas_study_torch as tcas  # noqa: E402
from scripts import study_cas_premium as jpremium  # noqa: E402
from scripts import study_cas_premium_torch as tpremium  # noqa: E402
from scripts import study_mesh1_overhead as jmesh1  # noqa: E402
from scripts import study_mesh1_overhead_torch as tmesh1  # noqa: E402
from scripts import study_selective_precision as jselprec  # noqa: E402
from scripts import study_selective_precision_torch as tselprec  # noqa: E402
from scripts import study_train_leads as jleads  # noqa: E402
from scripts import study_train_leads_torch as tleads  # noqa: E402

torch.set_num_threads(1)

TRACED = {"--device", "--trace-dir"}
PAIRS = [(jmesh1, tmesh1, TRACED), (jpremium, tpremium, TRACED),
         (jleads, tleads, TRACED), (jselprec, tselprec, TRACED),
         (jcapacity, tcapacity, {"--device"})]


class _Parsed(Exception):
    pass


def _options(monkeypatch, main) -> dict:
    """{flag: (default, type, nargs, action)} of the parser `main` builds
    (stopped where it would parse)."""
    def stop(self, args=None, namespace=None):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as e:
        main()
    return {a.option_strings[-1]: (a.default, a.type, a.nargs,
                                   type(a).__name__)
            for a in e.value.args[0]._actions if a.dest != "help"}


@pytest.mark.parametrize("jmod,tmod,extra", PAIRS,
                         ids=[p[1].__name__.split(".")[-1] for p in PAIRS])
def test_arguments_are_the_jax_scripts(monkeypatch, jmod, tmod, extra):
    """The same flags, defaults, types and actions as the JAX script, and
    only `--device` (default cuda) and `--trace-dir` besides."""
    j, t = _options(monkeypatch, jmod.main), _options(monkeypatch, tmod.main)
    assert set(t) - set(j) == extra
    assert {k: t[k] for k in j} == j
    assert t["--device"][0] == "cuda"


def test_cas_study_arguments(monkeypatch):
    """The JAX study takes no arguments; the port's takes `--device`,
    default the CPU, as the JAX study runs."""
    assert set(_options(monkeypatch, tcas.main)) == {"--device"}
    assert _options(monkeypatch, tcas.main)["--device"][0] == "cpu"
    assert not hasattr(jcas, "main")


@pytest.mark.parametrize("script", sorted(
    p.name for p in (REPO / "scripts").glob("*_torch.py")))
def test_scripts_import_no_jax(script):
    """No port script imports JAX, the JAX package or the tests."""
    tree = ast.parse((REPO / "scripts" / script).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    bad = [m for m in names if m.split(".")[0] in
           ("jax", "jaxlib", "flax", "gridgcn_tpu", "tests")]
    assert not bad, bad


def test_cas_study_counts_are_the_jax_studys():
    """Both studies on two small surface scenes: every sampler's mean
    covered voxels equal (RVS, batched-Jacobi CAS at 1/2/4/8 rounds,
    sequential CAS at 1/2)."""
    args = (512, 8, 64)
    want = jcas.run_setting("jax", *args, seeds=(0, 1))
    got = tcas.run_setting("port", *args, seeds=(0, 1))
    assert got == want
    assert got["j8"] > got["rvs"]


def test_gauss_seidel_and_coverage_are_the_oracles():
    """The script's own copies of the oracle's sequential CAS and
    coverage count give the oracle's answers."""
    import numpy as np

    from tests.oracle import oracle_np

    rng = np.random.default_rng(3)
    occ = np.unique(rng.integers(0, 10 ** 3, 400))
    for it in (1, 2):
        a = tcas.cas_gauss_seidel(occ, 60, 10, 3, np.random.default_rng(it),
                                  iters=it)
        b = oracle_np.cas_gauss_seidel(occ, 60, 10, 3,
                                       np.random.default_rng(it), iters=it)
        np.testing.assert_array_equal(a, b)
        ok = np.arange(len(a)) % 5 != 0
        assert tcas.covered_voxels(a, ok, 10, 3) == \
            oracle_np.covered_voxels(a, ok, 10, 3)


def test_premium_split():
    """The bracket's mean is the baseline; the premium is the challenge
    rounds plus the plumbing."""
    ms = {"modelnet40_full (open)": 10.0, "modelnet40_full (close)": 10.4,
          "modelnet40_cas": 14.0, "cas iters=0": 11.0}
    p = tpremium.premium(ms)
    assert p["bracket_drift_ms"] == pytest.approx(0.4)
    assert p["cas_premium_ms"] == pytest.approx(3.8)
    assert p["challenge_rounds_ms"] + p["sampler_plumbing_ms"] == \
        pytest.approx(p["cas_premium_ms"])
