"""Layer-0 capacity budget against accuracy on the card (the port's
counterpart of `scripts/capacity_sweep.py`).

Trains the `synthetic_scene_seg` preset (labelled surface scenes, skewed
density like real scans) through the port's trainer (`train.train()`) at
layer-0 `nv` in {8, 16, 20, 32} and, without `--quick`, at the preset's
nv with the resolution halved and doubled, and reports for each point:
layer 0's dropped-point share (`ops.voxelize.capacity_stats` on the
first eval batch, key 0), the final held-out mIoU and overall accuracy,
and the forward's ms per eval batch (the freshly initialised model, eval
mode, key 0): device-busy from a trace of 20 calls, CUDA events of 20
calls after 2 warm-up calls beside it.

    python scripts/capacity_sweep_torch.py [--epochs 12] [--quick]
        [--preset synthetic_scene_seg] [--device cuda|cpu]

Each point runs in a fresh process of its own (a trace that lost device
records is taken again), its checkpoints and log under
`build/capacity_sweep/`, and prints `CAPSWEEP {json}`; the last line is
the JSON list of every point. On the CPU the busy values are null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT_DIR = os.path.join("build", "capacity_sweep")
TIMED_CALLS = 20


def run_point(base, nv: int, resolution: int, epochs: int,
              device: str) -> list:
    """[one point's row, with its forward's `timed_trace` record under
    "refused" when the trace lost device records]."""
    from gridgcn_torch.configs.base import apply_overrides
    from gridgcn_torch.data.pipeline import make_dataset
    from gridgcn_torch.models.build import init_model
    from gridgcn_torch.ops.voxelize import build_voxel_table, capacity_stats
    from gridgcn_torch.train.train import train
    from gridgcn_torch.utils import jaxrng, profiling

    dev = torch.device(device)
    name = f"capsweep_nv{nv}_r{resolution}"
    work = os.path.join(OUT_DIR, name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    l0 = dataclasses.replace(base.model.layers[0], nv=nv,
                             resolution=resolution)
    cfg = dataclasses.replace(
        base, name=name,
        model=dataclasses.replace(base.model,
                                  layers=(l0,) + base.model.layers[1:]))
    cfg = apply_overrides(cfg, {
        "train.epochs": epochs,
        "train.eval_every": epochs,          # final eval only
        "train.ckpt_every": epochs,
        "train.ckpt_dir": os.path.join(work, "ck")})

    # layer 0's dropped share on the eval split's first batch
    ds = make_dataset(cfg.data, "test", cfg.model.num_classes, "seg")
    xyz = torch.as_tensor(ds.points[:cfg.data.batch_size], device=dev)
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
    table = build_voxel_table(xyz, mask, resolution, nv, jaxrng.PRNGKey(0))
    dropped = float(capacity_stats(table)["dropped_frac"].max())

    log = os.path.join(work, "log.jsonl")
    train(cfg, log_path=log, device=device)
    final = None
    with open(log) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("kind") == "eval":
                final = rec

    # the forward at the eval batch's shape
    model, _ = init_model(cfg.model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    key = jaxrng.PRNGKey(0)

    def fwd():
        with torch.no_grad():
            return model(xyz, None, mask, key)
    timed = profiling.timed_trace(fwd, TIMED_CALLS,
                                  os.path.join(work, "trace"), dev)
    row = {"nv": nv, "resolution": resolution, "dropped_frac": dropped,
           "miou": final["miou"], "overall_acc": final["overall_acc"],
           "fwd_busy_ms_batch": timed["busy_ms"],
           "fwd_ms_batch": timed["wall_ms"]}
    if "refused" in timed:
        row["refused"] = timed["refused"]
    return [row]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--quick", action="store_true",
                    help="nv sweep only, skip the resolution arm")
    ap.add_argument("--preset", default="synthetic_scene_seg",
                    help="any seg preset (rerun the sweep on real data "
                         "once datasets are mounted)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gridgcn_torch.configs import presets
    from gridgcn_torch.utils.profiling import in_fresh_process, retaking

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    base = presets.get(args.preset)
    r0 = base.model.layers[0].resolution
    points = [(nv, r0) for nv in (8, 16, 20, 32)]
    if not args.quick:
        nv0 = base.model.layers[0].nv
        points += [(nv0, r0 // 2), (nv0, r0 * 2)]
    rows = []
    for nv, res in points:
        (row,), _ = retaking(lambda: in_fresh_process(
            run_point, base, nv, res, args.epochs, args.device))
        rows.append(row)
        print("CAPSWEEP " + json.dumps(row), flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
