"""Nothing under portbench/ imports JAX, the JAX package or its benchmark,
and the reference imports nothing of the port; names compared by their
whole top-level part."""

import ast
from pathlib import Path

import pytest

from harness.cell import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


def imported_top_levels(path: Path) -> set:
    """The top-level names of every absolute import in a file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not imported_top_levels(path) & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    """The reference, and the reference network that the tests add as a
    file (`tests/added/reference/`)."""
    allowed = {"__future__", "contextlib", "dataclasses", "hashlib", "json",
               "math", "typing", "numpy", "torch"}
    for path in [*(BENCH / "reference").glob("*.py"),
                 *(BENCH / "tests/added/reference").glob("*.py")]:
        assert imported_top_levels(path) <= allowed, path.name


def test_runtime_check_compares_whole_top_level_names():
    mods = ["jax.numpy", "jaxlib", "flax.linen", "gridgcn_tpu.ops", "bench",
            "gridgcn_torch.api", "jaxtyping", "benchmark", "flaxen",
            "gridgcn_tpux", "torch"]
    assert forbidden_modules(mods) == sorted(
        ["bench", "flax.linen", "gridgcn_tpu.ops", "jax.numpy", "jaxlib"])
