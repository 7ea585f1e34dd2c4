"""Device ms per request launched inside the encoder layers' CAGQ: each
`gridconv{i}` span less its `gca` span, summed over the layers (voxel
table, center sampling, node gather; the benchmark's own spans, opened by
forward hooks)."""

from harness import readers

UNIT, MOVES, LAYER = "ms", "serve_latency_p95_ms", "CAGQ"


def read(run):
    return readers.span_ms_per_call(run, "serve", "cagq")
