"""Device ms per request launched inside the encoder layers' GCA (edge and
attention MLPs, pooling): the program's `gca` spans inside its
`gridconv{i}` spans, summed."""

from harness import program_spans

UNIT, MOVES, LAYER = "ms", "serve_latency_p95_ms", "GCA / MLPs"


def within(path):
    return program_spans.in_layer(path) and "gca" in path


def read(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else 1e3 * s.per_request("device_s", within)


def info(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else s.parts("device_s", within, 1e3)
