"""Device ms per request launched inside the encoder layers' CAGQ: inside
the program's `gridconv{i}` spans and outside their `gca` spans, summed
over the layers (voxel table, center sampling and its draws, node gather
and offsets)."""

from harness import program_spans

UNIT, MOVES, LAYER = "ms", "serve_latency_p95_ms", "CAGQ"


def within(path):
    return program_spans.in_layer(path) and "gca" not in path


def read(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else 1e3 * s.per_request("device_s", within)


def info(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else s.parts("device_s", within, 1e3)
