"""Seconds from the process's start until the first timed request or
step: imports, CUDA initialization, kernel builds and loads, weights,
inputs and warm-up (with the check's first training steps)."""

UNIT, MOVES, LAYER = "s", None, None


def read(run):
    return run.setup_s
