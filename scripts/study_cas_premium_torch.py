"""The classifier presets' latencies and the CAS premium on the card (the
port's counterpart of `scripts/study_cas_premium.py`).

Protocol: the folded forward in the presets' eval dtype (bf16), 16 clouds
of 1024 points drawn uniform in [-1, 1) under key 0 (the reference's
draws, `utils.jaxrng.uniform`), CAGQ key 0; BRACKETED: `modelnet40_full`
runs first and again last, and the spread of the two bounds the drift.
Between them `modelnet40_cas`, `modelnet40_compact`, and the CAS preset
at `cas_iters` 1 and 0 (0 challenge rounds: CAS's initialization, the
RVS draw, behind the CAS sampler's dispatch). The premium of CAS over
the bracket's mean splits into the challenge rounds (`cas_iters` 2 → 0)
and the sampler's plumbing (0 rounds against `modelnet40_full`).

    python scripts/study_cas_premium_torch.py [--iters 40]
        [--device cuda|cpu] [--trace-dir build/study_cas_premium]

Each run is timed (CUDA events, `--iters` calls after 2 warm-up calls)
and traced (`--iters` calls; device-busy ms per call) in a fresh process
of its own (`utils.profiling.in_fresh_process`; a trace that lost device
records is taken again). Busy time is the premium's measure; the
CUDA-events time is printed beside it. The last line is
`CAS_PREMIUM {json}`; on the CPU the busy values are null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUNS = (("modelnet40_full (open)", "modelnet40_full", None),
        ("modelnet40_cas", "modelnet40_cas", None),
        ("modelnet40_compact", "modelnet40_compact", None),
        ("cas iters=1", "modelnet40_cas", 1),
        ("cas iters=0", "modelnet40_cas", 0),
        ("modelnet40_full (close)", "modelnet40_full", None))


def cas_variant(base, iters_per_layer: int):
    """The preset with every layer's `cas_iters` set."""
    layers = tuple(dataclasses.replace(s, cas_iters=iters_per_layer)
                   for s in base.model.layers)
    return dataclasses.replace(
        base, name=f"{base.name}+iters{iters_per_layer}",
        model=dataclasses.replace(base.model, layers=layers))


def _run(preset: str, cas_iters, device: str, iters: int,
         logdir: str) -> list:
    """One run in its own process: [its `timed_trace` record]."""
    from gridgcn_torch.configs import presets
    from gridgcn_torch.models.build import build_model, init_model
    from gridgcn_torch.models.fold import fold_inference
    from gridgcn_torch.utils import jaxrng, profiling
    from gridgcn_torch.utils.precision import full_fp32

    dev = torch.device(device)
    cfg = presets.get(preset)
    if cas_iters is not None:
        cfg = cas_variant(cfg, cas_iters)
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    cfg, folded = fold_inference(cfg, sd)
    model = build_model(cfg.model)
    model.load_state_dict(folded)
    model = model.to(dev).eval()
    B, N = 16, cfg.data.num_points
    key = jaxrng.PRNGKey(0)
    xyz = jaxrng.uniform(key, (B, N, 3), dev, minval=-1.0, maxval=1.0)
    mask = torch.ones((B, N), dtype=torch.bool, device=dev)

    def fn():
        with torch.no_grad(), full_fp32():
            return model(xyz, None, mask, key)
    return [profiling.timed_trace(fn, iters, logdir, dev)]


def premium(ms: dict) -> dict:
    """The bracket's drift and the CAS premium split, from {run: ms}."""
    o, c = ms["modelnet40_full (open)"], ms["modelnet40_full (close)"]
    full = (o + c) / 2
    cas, cas0 = ms["modelnet40_cas"], ms["cas iters=0"]
    return {"bracket_drift_ms": abs(c - o),
            "bracket_drift_frac": abs(c / o - 1),
            "cas_premium_ms": cas - full,
            "cas_premium_frac": cas / full - 1,
            "challenge_rounds_ms": cas - cas0,
            "sampler_plumbing_ms": cas0 - full}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default="build/study_cas_premium")
    args = ap.parse_args(argv)

    from gridgcn_torch.utils.profiling import in_fresh_process, retaking

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    wall, busy, retaken = {}, {}, 0
    for i, (name, preset, cas_iters) in enumerate(RUNS):
        (rec,), n = retaking(lambda: in_fresh_process(
            _run, preset, cas_iters, args.device, args.iters,
            os.path.join(args.trace_dir, f"run{i}")))
        retaken += n
        wall[name], busy[name] = rec["wall_ms"], rec["busy_ms"]
        print(f"{name:28s} {rec['wall_ms']:8.3f} ms/batch-16 ({clock}), "
              f"{rec['busy_ms'] and round(rec['busy_ms'], 4)} busy",
              flush=True)
    split = {"wall": premium(wall)}
    split["busy"] = premium(busy) if all(busy.values()) else None
    for unit, p in split.items():
        if p is None:
            continue
        print(f"[{unit}] bracket drift: {p['bracket_drift_ms']:.3f} ms "
              f"({p['bracket_drift_frac'] * 100:.1f}%)")
        print(f"[{unit}] CAS premium: {p['cas_premium_ms']:+.3f} ms over "
              f"full ({p['cas_premium_frac'] * 100:+.1f}%)")
        print(f"[{unit}]   challenge rounds (iters 0→2): "
              f"{p['challenge_rounds_ms']:+.3f} ms")
        print(f"[{unit}]   sampler plumbing at 0 rounds vs rvs: "
              f"{p['sampler_plumbing_ms']:+.3f} ms")
    print("CAS_PREMIUM " + json.dumps({
        "backend": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "iters": args.iters, "batch": [16, 1024], "wall_ms": wall,
        "busy_ms": busy if all(busy.values()) else None, **split,
        "retaken": retaken}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
