"""The device's idle share: 100 · (1 − traced busy per request, the union
over the device's streams, ÷ the untraced window's seconds per request)."""

from harness import readers

UNIT, MOVES, LAYER = "%", "serve_latency_p95_ms", "device"


def read(run):
    return readers.idle_share(run, "serve")
