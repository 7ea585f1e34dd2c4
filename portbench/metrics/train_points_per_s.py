"""Points of all training steps completed in the window, per second of
the window."""

from harness import readers

UNIT, MOVES, LAYER = "points/s", None, None


def read(run):
    return readers.points_per_s(run, "train")


def info(run):
    if run.driver != "train":
        return None
    return (f"{run.calls} steps, step ms p10 / median / p90 "
            f"{readers.percentile_ms(run, 10)!r} / "
            f"{readers.percentile_ms(run, 50)!r} / "
            f"{readers.percentile_ms(run, 90)!r}")
