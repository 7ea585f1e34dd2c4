"""Device ms per request launched inside the program's `head` span: the
classifier's global max-pool over the last level's centers, its head MLP
and its logits."""

from harness import program_spans

UNIT, MOVES, LAYER = "ms", "serve_latency_p95_ms", "head"
within = program_spans.has("head")


def read(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else 1e3 * s.per_request("device_s", within)


def info(run):
    s = program_spans.split(run, __file__, within)
    return None if s is None else s.parts("device_s", within, 1e3)
