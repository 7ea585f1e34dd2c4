"""The whole step's share of the card's bf16 peak: three times the dense
layers' operations of one forward (the forward, and the backward's two
products a layer) over the untraced window's seconds per step × 989e12
(readers.mfu)."""

from harness import readers

UNIT, MOVES, LAYER = "%", "train_points_per_s", "whole step"


def read(run):
    return readers.mfu(run, "train", passes=3)
