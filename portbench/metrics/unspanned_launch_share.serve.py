"""The share of the traced kernel launches that no program span below the
request holds: 100 · kernels launched with `request` or no program span
innermost ÷ every kernel in the trace. Its `info` prints the program's
whole split by span path (`harness/program_spans.py`)."""

from harness import program_spans

UNIT, MOVES, LAYER = "%", "serve_latency_p95_ms", "tracing coverage"
within = program_spans.has("request")


def read(run):
    s = program_spans.split(run, __file__, within)
    if s is None:
        return None
    every = s.total("kernels", lambda p: True)
    return (100.0 * s.total("kernels", program_spans.unspanned) / every
            if every else None)


def info(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else s.table()
