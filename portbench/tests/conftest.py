"""The benchmark's CPU tests: `python -m pytest portbench/tests` from the
repo root. The benchmark's folder and the repo root go on the import path,
as `portbench/run.py` puts them; the `cuda` marker is registered here too,
for a checkout without the repo's pytest settings."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH / "tests"), str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one)")
