"""Train-step levers at train shapes on the card (the port's counterpart
of `scripts/study_train_leads.py`).

Times the full `scannet_seg` train step as the trainer runs it
(`train/steps.py`: augmentation, CAGQ, forward, loss, backward, Adam) on
the preset's batch (8 crops of 8192 points, the split `make_dataset`
gives, first batch of seed 0, key 0) for the reference's variants: the
preset as it stands (bf16 matmuls, f32 BatchNorm), CAGQ's combined
selection table (`coord_match`) on layer 0 and on every layer, blanket
`model.dtype=bfloat16`, and bf16 with `coord_match` on layer 0.

    python scripts/study_train_leads_torch.py [--iters 30]
        [--device cuda|cpu] [--trace-dir build/study_train_leads]

Each variant runs in a fresh process of its own
(`utils.profiling.in_fresh_process`): one step whose loss must be finite,
then `--iters` steps timed by CUDA events after 2 warm-up steps and
`--iters` traced (device-busy ms per step; a trace that lost device
records is taken again). The last line is `TRAIN_LEADS {json}`; on the
CPU the busy values are null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def time_step(cfg, device: str, iters: int, logdir: str) -> list:
    """[the `timed_trace` record of cfg's train step] (in its own
    process)."""
    from gridgcn_torch.data.pipeline import make_dataset, to_device
    from gridgcn_torch.models.build import init_model
    from gridgcn_torch.train.steps import create_train_state, make_train_step
    from gridgcn_torch.utils import jaxrng, profiling

    dev = torch.device(device)
    model, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    ds = make_dataset(cfg.data, "train", cfg.model.num_classes, "seg")
    state = create_train_state(cfg, model, sd, 100, device=dev)
    step = make_train_step(cfg)
    batch = to_device(next(ds.batches(cfg.data.batch_size, seed=0)), dev)
    rng = jaxrng.PRNGKey(0)
    _, m = step(state, batch, rng)
    assert bool(torch.isfinite(m["loss"])), "loss not finite"
    return [profiling.timed_trace(lambda: step(state, batch, rng), iters,
                                  logdir, dev)]


def variant(cfg, name, coord_match_layers=(), dtype=None):
    """(name, cfg with coord_match on the given layers and, given, the
    model dtype)."""
    layers = tuple(
        dataclasses.replace(layer, coord_match=(i in coord_match_layers))
        for i, layer in enumerate(cfg.model.layers))
    m = dataclasses.replace(cfg.model, layers=layers)
    if dtype:
        m = dataclasses.replace(m, dtype=dtype)
    return name, dataclasses.replace(cfg, model=m)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default="build/study_train_leads")
    args = ap.parse_args(argv)

    from gridgcn_torch.configs import presets
    from gridgcn_torch.utils.profiling import in_fresh_process, retaking

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    base = presets.get("scannet_seg")
    n_layers = len(base.model.layers)
    variants = [
        variant(base, "base (preset: bf16, bn f32)"),
        variant(base, "coord_match L0", (0,)),
        variant(base, "coord_match all", tuple(range(n_layers))),
        variant(base, "bf16", (), "bfloat16"),
        variant(base, "bf16 + coord_match L0", (0,), "bfloat16"),
    ]
    rows, retaken = {}, 0
    for i, (name, cfg) in enumerate(variants):
        (rec,), n = retaking(lambda: in_fresh_process(
            time_step, cfg, args.device, args.iters,
            os.path.join(args.trace_dir, f"variant{i}")))
        retaken += n
        rows[name] = {"wall_ms": rec["wall_ms"], "busy_ms": rec["busy_ms"]}
        print(f"{name:28s} {rec['wall_ms']:8.3f} ms/step ({clock}), "
              f"{rec['busy_ms'] and round(rec['busy_ms'], 4)} busy",
              flush=True)
    print("TRAIN_LEADS " + json.dumps({
        "preset": "scannet_seg", "backend": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "iters": args.iters, "variants": rows, "retaken": retaken}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
