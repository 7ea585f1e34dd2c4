"""Device kernels in the trace per traced step: the host's dispatch
work, which a launch-cutting change lowers."""

from harness import readers

UNIT, MOVES, LAYER = "launches", "train_points_per_s", "training"


def read(run):
    return readers.launches_per_call(run, "train")
