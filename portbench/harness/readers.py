"""Arithmetic that several metric readers share. A reader returns None
where its run has nothing for it to read (another driver, or no sound
trace); it never returns 0 for a share of a roofline or a peak."""

from __future__ import annotations

import re

import numpy as np

from work.dense_flops import forward_flops
from work.knn3_bytes import knn3_bytes
from work.knn3_pairs import OPS_PER_PAIR, knn3_pairs
from work.peaks import BF16_OPS_PER_S, HBM_BYTES_PER_S


def config(run) -> dict:
    return run.cell.config_file["config"]


def batch(run) -> int:
    return int(run.cell.workload["batch"])


def window_s_per_call(run) -> float:
    """The untraced window's seconds per request or step."""
    return run.window_s / run.calls


def points_per_s(run, driver: str):
    if run.driver != driver:
        return None
    return run.calls * run.points / run.window_s


def traced(run, driver: str):
    """The run's sound trace, for a reader of `driver`'s cells."""
    if run.driver != driver or run.trace is None:
        return None
    return run.trace


def launches_per_call(run, driver: str):
    tr = traced(run, driver)
    return None if tr is None else tr.kernels / tr.iters


def idle_share(run, driver: str):
    """100 · (1 − traced busy seconds per call ÷ the untraced window's
    seconds per call)."""
    tr = traced(run, driver)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.iters / window_s_per_call(run))


def kernel_seconds_per_call(run, driver: str, names: tuple):
    """Device seconds per call of the kernels whose names contain one of
    `names`; None without a trace or where none ran."""
    tr = traced(run, driver)
    if tr is None:
        return None
    pat = re.compile("|".join(re.escape(n) for n in names))
    s = sum(v for k, v in tr.kernel_s.items() if pat.search(k))
    return s / tr.iters if s > 0 else None


def percentile_ms(run, q: float):
    if not run.latencies_s:
        return None
    return 1e3 * float(np.percentile(run.latencies_s, q))


def knn3_roofline(run, driver: str, kernels: tuple):
    """100 · the least time any correct k-NN needs for the configuration's
    decoder calls (their bytes at the card's HBM rate) ÷ the traced device
    time per call of the kernels whose names contain one of `kernels`."""
    s = kernel_seconds_per_call(run, driver, kernels)
    if s is None:
        return None
    return 100.0 * knn3_bytes(config(run), batch(run)) / HBM_BYTES_PER_S / s


def knn3_info(run, driver: str, kernels: tuple):
    """The kernels' ms per call beside the bytes bound and the all-pairs
    bound (32 bf16 operations a pair at the bf16 peak), which is printed
    and is not the roofline's numerator."""
    s = kernel_seconds_per_call(run, driver, kernels)
    if s is None:
        return None
    cfg, b = config(run), batch(run)
    pairs = knn3_pairs(cfg, b)
    return (f"kernels {1e3 * s!r} ms per call; bytes bound "
            f"{1e3 * knn3_bytes(cfg, b) / HBM_BYTES_PER_S!r} ms; all-pairs "
            f"bound {1e3 * pairs * OPS_PER_PAIR / BF16_OPS_PER_S!r} ms "
            f"({pairs} pairs)")


def mfu(run, driver: str, passes: int):
    """100 · `passes` times the dense layers' operations of one forward
    (from the configuration's shapes) ÷ (the untraced window's seconds per
    call × the bf16 peak); read in the traced run."""
    if traced(run, driver) is None:
        return None
    ops = passes * forward_flops(config(run), batch(run))
    return 100.0 * ops / window_s_per_call(run) / BF16_OPS_PER_S
