"""Whether what the timed path produced is correct: its outputs against
the plain reference (`reference/`), each number beside its limit.

Serving: for each sampled request and each of its clouds, the served
logits L against the reference's R on the same cloud, features and key,
over the whole of the cloud's logits (every point and class of a per-point
answer [N, C], every class of a per-cloud answer [C]):
  * `logit_rel_err`: ‖L − R‖ / ‖R − mean(R)‖;
  * `logit_max_gap`: max |L − R| / (max R − min R);
the worst over the sample.

Training: the program's first steps against the reference's from the same
weights, batches and key. A leaf's gap is | ‖x‖ − ‖x_ref‖ | over
max(‖x_ref‖ of that leaf, the median leaf's ‖x_ref‖):
  * `grad_gap_median`: the median over the parameters of the first step's
    gradient's leaf gaps (its worst leaf, an attention leaf whose gradient
    cancels under bfloat16, is printed beside it: see PERF.md);
  * `change_gap`: the worst leaf gap of each parameter's and BatchNorm
    statistic's change over the steps (‖state − start‖), leaving out the
    parameters whose reference gradient is nought to rounding (under 1e-3
    of the median leaf's: a Dense bias before a batch-statistics
    BatchNorm, which Adam moves by round-off alone).
"""

from __future__ import annotations

import math

import numpy as np
import torch

NOISE_LEAF = 1e-3       # a leaf's gradient under this share of the median


def logit_readings(out: np.ndarray, ref: np.ndarray) -> dict:
    """The serving numbers of one cloud's logits, [N, C] or [C] (float):
    each reduces over the whole array."""
    ref = ref.astype(np.float64)
    d = out.astype(np.float64) - ref
    spread = np.linalg.norm(ref - ref.mean())
    rng = ref.max() - ref.min()
    return {"logit_rel_err": float(np.linalg.norm(d) / max(spread, 1e-30)),
            "logit_max_gap": float(np.abs(d).max() / max(rng, 1e-30))}


def serve_readings(samples: list, reference) -> dict:
    """samples: [(request, served logits [B, N, C] or [B, C])], a request
    a `traffic.Request` (clouds and their features);
    reference(request) → logits of the same shape (numpy). The worst of
    each number over every sampled cloud; the reference runs once per
    distinct request."""
    worst: dict = {}
    cache: dict = {}
    for request, out in samples:
        key = id(request)
        if key not in cache:
            cache[key] = reference(request)
        ref = cache[key]
        for b in range(len(out)):
            for k, v in logit_readings(out[b], ref[b]).items():
                worst[k] = max(worst.get(k, 0.0), v) if math.isfinite(v) \
                    else math.inf
    return worst


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """{leaf: |prog − ref| / max(ref, the median of ref)} over ref's
    leaves (a NaN reads inf)."""
    med = float(np.median(list(ref.values())))
    out = {}
    for n, r in ref.items():
        v = abs(prog[n] - r) / max(r, med, 1e-30)
        out[n] = v if math.isfinite(v) else math.inf
    return out


def changes(state: dict, start: dict) -> dict:
    """{leaf: ‖state − start‖} in float64."""
    return {k: torch.linalg.vector_norm(
        state[k].double() - start[k].to(state[k].device).double()).item()
        for k in start}


def _kept(ref: dict) -> dict:
    """ref's changes without the leaves whose gradient is nought to
    rounding."""
    gmed = float(np.median(list(ref["grad_norms"].values())))
    return {n: c for n, c in ref["changes"].items()
            if ref["grad_norms"].get(n, gmed) >= NOISE_LEAF * gmed}


def train_readings(prog: dict, ref: dict) -> dict:
    """prog and ref: {"losses": [...], "grad_norms": {param: ‖g₁‖},
    "changes": {leaf: ‖Δ‖}} → the compared numbers."""
    g = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    return {"grad_gap_median": float(np.median(list(g.values()))),
            "change_gap": max(leaf_gaps(prog["changes"],
                                        _kept(ref)).values())}


def train_diagnostics(prog: dict, ref: dict) -> dict:
    """Beside the compared numbers (printed, not compared): the losses,
    each step's loss gap, the gradient's worst leaves, the change's median
    leaf gap, the global gradient norms and the noise leaves' count."""
    g = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    c = leaf_gaps(prog["changes"], _kept(ref))
    norm = lambda d: float(np.sqrt(sum(v * v for v in d.values())))  # noqa
    worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]  # noqa
    return {
        "losses": [prog["losses"], ref["losses"]],
        "loss_gaps": [abs(a - b) / abs(b) for a, b in
                      zip(prog["losses"], ref["losses"])],
        "grad_norm": [norm(prog["grad_norms"]), norm(ref["grad_norms"])],
        "grad_gap_worst": worst(g),
        "change_gap_median": float(np.median(list(c.values()))),
        "change_gap_worst": worst(c),
        "noise_leaves": len(ref["changes"]) - len(c)}


def reference_train_readings(trainer, batches: list, key) -> dict:
    """The reference trainer's readings over `batches` (one step each)."""
    start = trainer.state()
    start = {k: v.clone() for k, v in start.items()}
    losses, grad_norms = [], None
    for j, b in enumerate(batches):
        loss, grads = trainer.step(b, key)
        losses.append(loss)
        if j == 0:
            grad_norms = {n: torch.linalg.vector_norm(g.double()).item()
                          for n, g in zip(trainer.names, grads)}
    return {"losses": losses, "grad_norms": grad_norms,
            "changes": changes(trainer.state(), start)}


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number
    has its limit and none is over it (a NaN is over)."""
    checked = {}
    ok = bool(readings)
    for name, value in readings.items():
        limit = limits.get(name)
        checked[name] = {"value": value, "limit": limit}
        if limit is None or not (value <= limit):
            ok = False
    return ok, checked
