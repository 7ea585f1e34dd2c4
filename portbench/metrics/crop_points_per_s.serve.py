"""Points whose logits reached the host in the window, per second of the
window, in a serving cell whose rate spreads too widely between runs on a
shared host to hold to an end-to-end bound (PERF.md section 2): the
quantity of `serve_points_per_s`, reported beside that cell's latency."""

from harness import readers

UNIT, MOVES, LAYER = "points/s", "serve_latency_p95_ms", "whole request"


def read(run):
    return readers.points_per_s(run, "serve")
