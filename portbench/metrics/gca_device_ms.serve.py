"""Device ms per request launched inside the encoder layers' GCA (edge and
attention MLPs, pooling): the `gridconv{i}.gca` spans summed."""

from harness import readers

UNIT, MOVES, LAYER = "ms", "serve_latency_p95_ms", "GCA / MLPs"


def read(run):
    return readers.span_ms_per_call(run, "serve", "gca")
