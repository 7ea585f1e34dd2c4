"""The 95th percentile of the window's request latencies, each from
submit until its logits are a host array (numpy's linear percentile)."""

from harness import readers

UNIT, MOVES, LAYER = "ms", None, None


def read(run):
    if run.driver != "serve":
        return None
    return readers.percentile_ms(run, 95)


def info(run):
    if run.driver != "serve":
        return None
    return (f"median {readers.percentile_ms(run, 50)!r} ms, p95 "
            f"{readers.percentile_ms(run, 95)!r} ms over "
            f"{len(run.latencies_s)} requests")
