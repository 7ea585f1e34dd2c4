"""Selective-precision bf16 training on the card (the port's counterpart
of `scripts/study_selective_precision.py`).

Blanket `model.dtype=bfloat16` is the fast path; the model's precision
knobs keep islands in f32: `att_dtype` (the geometry encoding and the
attention MLP and softmax), `interp_dtype` (the decoder's
inverse-distance accumulation) and `bn_dtype` (BatchNorm). Each variant
clears the base preset's own knobs first, so a name means the same
whatever the preset's default is (`scannet_seg` defaults to bf16 with
f32 BatchNorm, `bf16_bn32`).

Two arms per variant:
  * speed: the full `scannet_seg` train step at crop shapes, the
    protocol of `scripts/study_train_leads_torch.py` and its `time_step`
    (one finite step, then `--iters` steps timed by CUDA events after 2
    warm-up steps and `--iters` traced for device-busy ms per step, in a
    fresh process of its own);
  * quality: paired `--epochs`-epoch `synthetic_scene_seg` runs per seed
    through the port's trainer (`train.train()`), final held-out mIoU
    and overall accuracy (checkpoints under `build/study_selective_
    precision/`).

    python scripts/study_selective_precision_torch.py [--seeds 0 1 2]
        [--epochs 12] [--iters 30] [--variants f32 bf16 ...]
        [--skip-quality] [--skip-speed] [--device cuda|cpu]
        [--trace-dir build/study_selective_precision]

Lines `SPEED <variant>: ...` and `QUALITY {json}` as each finishes, and
last `SELECTIVE_PRECISION {json}`; on the CPU the busy values are null.
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

OUT_DIR = os.path.join("build", "study_selective_precision")


def make_variant(base, name):
    """A precision variant of any config, the base's own precision knobs
    cleared first."""
    m = dataclasses.replace(base.model, dtype="float32", att_dtype="",
                            interp_dtype="", bn_dtype="")
    knobs = {
        "f32": {},
        "bf16": {"dtype": "bfloat16"},
        "bf16_att32": {"dtype": "bfloat16", "att_dtype": "float32"},
        "bf16_interp32": {"dtype": "bfloat16", "interp_dtype": "float32"},
        "bf16_att32_interp32": {"dtype": "bfloat16", "att_dtype": "float32",
                                "interp_dtype": "float32"},
        "bf16_bn32": {"dtype": "bfloat16", "bn_dtype": "float32"},
        # only the Dense matmuls in bf16: BatchNorm and relu, the
        # attention path and the interpolation accumulation in f32
        "bf16_matmul_only": {"dtype": "bfloat16", "att_dtype": "float32",
                             "interp_dtype": "float32",
                             "bn_dtype": "float32"},
    }
    if name not in knobs:
        raise ValueError(f"unknown variant {name}")
    return dataclasses.replace(base, name=f"{base.name}_{name}",
                               model=dataclasses.replace(m, **knobs[name]))


def quality_run(variant_name: str, seed: int, epochs: int,
                device: str) -> dict:
    """One `synthetic_scene_seg` run through the trainer; the final
    held-out metrics."""
    from gridgcn_torch.configs import presets
    from gridgcn_torch.configs.base import apply_overrides
    from gridgcn_torch.train.train import train

    work = os.path.join(OUT_DIR, f"{variant_name}_s{seed}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = make_variant(presets.get("synthetic_scene_seg"), variant_name)
    cfg = apply_overrides(cfg, {
        "train.seed": seed, "train.epochs": epochs,
        "train.eval_every": epochs,          # final eval only
        "train.ckpt_every": epochs,
        "train.ckpt_dir": os.path.join(work, "ck")})
    log = os.path.join(work, "log.jsonl")
    train(cfg, log_path=log, device=device)
    final = None
    with open(log) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("kind") == "eval":
                final = rec
    return {"variant": variant_name, "seed": seed,
            "miou": final["miou"], "overall_acc": final["overall_acc"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--iters", type=int, default=30)
    # the reference's decision table: both negatives (att32,
    # att32+interp32), the bf16_bn32 row and the all-islands-f32 bound
    ap.add_argument("--variants", nargs="+",
                    default=["f32", "bf16", "bf16_att32",
                             "bf16_att32_interp32", "bf16_bn32",
                             "bf16_matmul_only"])
    ap.add_argument("--skip-quality", action="store_true")
    ap.add_argument("--skip-speed", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default="build/study_selective_precision")
    args = ap.parse_args(argv)

    from gridgcn_torch.configs import presets
    from gridgcn_torch.utils.profiling import in_fresh_process, retaking
    from scripts.study_train_leads_torch import time_step

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    for v in args.variants:                       # unknown names fail early
        make_variant(presets.get("scannet_seg"), v)
    results = {"quality": [], "speed": {}, "retaken": 0}

    if not args.skip_speed:
        for v in args.variants:
            (rec,), n = retaking(lambda: in_fresh_process(
                time_step, make_variant(presets.get("scannet_seg"), v),
                args.device, args.iters, os.path.join(args.trace_dir, v)))
            results["retaken"] += n
            results["speed"][v] = {"wall_ms": rec["wall_ms"],
                                   "busy_ms": rec["busy_ms"]}
            print(f"SPEED {v}: {rec['wall_ms']:.3f} ms/step ({clock}), "
                  f"{rec['busy_ms'] and round(rec['busy_ms'], 4)} busy",
                  flush=True)

    if not args.skip_quality:
        for seed in args.seeds:
            for v in args.variants:
                row = in_fresh_process(quality_run, v, seed, args.epochs,
                                       args.device)
                results["quality"].append(row)
                print("QUALITY " + json.dumps(row), flush=True)

    print("SELECTIVE_PRECISION " + json.dumps({
        "backend": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "iters": args.iters, "epochs": args.epochs, **results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
