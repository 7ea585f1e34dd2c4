"""The device's idle share: 100 · (1 − traced busy per step, the union
over the device's streams, ÷ the untraced window's seconds per step)."""

from harness import readers

UNIT, MOVES, LAYER = "%", "train_points_per_s", "device"


def read(run):
    return readers.idle_share(run, "train")
