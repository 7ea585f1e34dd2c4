"""The whole request's share of the card's bf16 peak: the dense layers'
operations of one forward, from the configuration's shapes, over the
untraced window's seconds per request × 989e12 (readers.mfu)."""

from harness import readers

UNIT, MOVES, LAYER = "%", "serve_latency_p95_ms", "whole request"


def read(run):
    return readers.mfu(run, "serve", passes=1)
