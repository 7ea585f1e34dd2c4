"""CAGQ's share of the traced requests' device-idle time: 100 · the gaps
in the device's busy union whose middle falls inside the program's
`voxelize`, `sample` or `gather` span, or a draw inside one (the host
dispatching CAGQ's small kernels while the card waits) ÷ every gap whose
middle falls inside a `request` span. A share, and not ms, because the
host's speed and the profiler's stretch scale every gap of a request
alike."""

from harness import program_spans

UNIT, MOVES, LAYER = "%", "serve_latency_p95_ms", "CAGQ (host)"
request = program_spans.has("request")


def within(path):
    return any(n in ("voxelize", "sample", "gather") for n in path)


def read(run):
    s = program_spans.split(run, __file__, within)
    if s is None:
        return None
    idle = s.total("idle_s", request)
    return 100.0 * s.total("idle_s", within) / idle if idle else None


def info(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else (
        f"of {1e3 * s.per_request('idle_s', request)!r} idle ms per "
        f"request: {s.parts('idle_s', within, 1e3)}")
