#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It exits non-zero, printing no result, where
no CUDA card is found; its last line of standard output is the result
object (see portbench/README.md)."""

import time

T_START = time.perf_counter()   # set-up is timed from here

import os       # noqa: E402
import sys      # noqa: E402
from pathlib import Path    # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main() -> int:
    # every build and kernel cache of the run lives at a fixed path inside
    # the checkout, so that only a cell's first run there builds
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(HERE), str(ROOT)]
    from harness import cell

    return cell.main(sys.argv[1:], t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
