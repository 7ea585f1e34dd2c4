"""Kernel launches per request inside the program's `jaxrng` spans: the
jaxrng draws' threefry rounds on `long` tensors, one span a draw (most in
CAGQ's steps), which a fused draw kernel would cut."""

from harness import program_spans

UNIT, MOVES, LAYER = "launches", "serve_latency_p95_ms", "CAGQ draws"
within = program_spans.has("jaxrng")


def read(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else s.per_request("kernels", within)


def info(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else s.parts("kernels", within)
