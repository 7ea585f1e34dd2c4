"""Device ms per request launched inside the program's decoder stages,
the `up{i}` spans: each stage's 3-NN query (`knn3`), the inverse-distance
interpolation, the skip concat and the up-MLP."""

import re

from harness import program_spans

UNIT, MOVES, LAYER = "ms", "serve_latency_p95_ms", "decoder"


def within(path):
    return any(re.fullmatch(r"up\d+", n) for n in path)


def read(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else 1e3 * s.per_request("device_s", within)


def info(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else s.parts("device_s", within, 1e3)
