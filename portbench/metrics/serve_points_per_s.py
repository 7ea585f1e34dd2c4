"""Points whose logits reached the host in the window, per second of the
window (serving cells)."""

from harness import readers

UNIT, MOVES, LAYER = "points/s", None, None


def read(run):
    return readers.points_per_s(run, "serve")
