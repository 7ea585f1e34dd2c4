"""Device ms per request launched inside the program's `fetch` span: the
logits' cast to float32 and their copy to (pageable) host memory."""

from harness import program_spans

UNIT, MOVES, LAYER = "ms", "serve_latency_p95_ms", "serving I/O"
within = program_spans.has("fetch")


def read(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else 1e3 * s.per_request("device_s", within)


def info(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else s.parts("device_s", within, 1e3)
