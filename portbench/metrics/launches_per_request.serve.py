"""Device kernels in the trace per traced request: the host's dispatch
work, which a launch-cutting change lowers."""

from harness import readers

UNIT, MOVES, LAYER = "launches", "serve_latency_p95_ms", "serving"


def read(run):
    return readers.launches_per_call(run, "serve")
