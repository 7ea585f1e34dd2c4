"""Preset-scale convergence runs of the PyTorch port, on one CUDA card.

The port's counterpart of `scripts/convergence.py`, arm for arm: the
presets' exact models trained on the synthetic stand-ins, the held-out
metrics read back from the JSONL the trainer writes, and one `{"run": ...}`
JSON line per arm with the same keys. The targets are in
`gridgcn_torch/train/accuracy_targets.json`:

  * `cls`: `modelnet40_full` on `synthetic_shapes40` (40 shape families,
    1024 points, batch 16).
  * `seg`: `scannet_seg` on 96 labeled surface scenes (8192-point crops,
    batch 8, 4 part classes, every point scored).
  * `spatial`: `scannet_seg` trained on whole scenes through tier 3 at
    one rank (`train_spatial(..., mesh_devices=1, tier="resident_ml")`,
    augmentation off), then evaluated as `seg` is.
  * `s3dis`: `s3dis_seg` (4096-point blocks, 6 input channels) on the
    surface scenes.
  * `field`: `s3dis_seg` on the feature-field task (`--seed k`), the
    sensitive gate.

Usage:
  python scripts/convergence_torch.py
      --run {cls,seg,s3dis,field,spatial,both,all}
      [--epochs-cls 30] [--epochs-seg 60] [--seed 0] [--override k=v ...]
      [--device cuda] [--out-dir build/convergence]

`--override` applies to the seg, spatial and field arms, as in the JAX
script. Each arm trains in a fresh directory under `--out-dir` (its
checkpoints and JSONL log). `--device` defaults to `cuda` and raises
without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gridgcn_torch.configs import presets
from gridgcn_torch.configs.base import apply_overrides, parse_cli_overrides


def cls_config(epochs: int, ckpt_dir: str = ""):
    cfg = apply_overrides(presets.get("modelnet40_full"), {
        "data.dataset": "synthetic_shapes40",
        "train.epochs": epochs,
        "train.eval_every": max(epochs // 10, 1),
        "train.ckpt_every": epochs,          # final only
        "train.ckpt_dir": ckpt_dir,
    })
    return dataclasses.replace(cfg, name="modelnet40_full+shapes40")


def seg_config(epochs: int, extra: dict | None = None, ckpt_dir: str = ""):
    cfg = apply_overrides(presets.get("scannet_seg"), {
        "data.dataset": "synthetic_scene",
        "data.synthetic_size": 96,
        "model.num_classes": 4,
        "train.epochs": epochs,
        "train.eval_every": max(epochs // 10, 1),
        "train.ckpt_every": epochs,
        "train.ckpt_dir": ckpt_dir,
        **(extra or {}),
    })
    # surface-scene labels have no "unannotated" class: every point scores
    return dataclasses.replace(
        cfg, name="scannet_seg+surface",
        model=dataclasses.replace(cfg.model, ignore_label=None))


def spatial_config(epochs: int, extra: dict | None = None,
                   ckpt_dir: str = ""):
    cfg = apply_overrides(presets.get("scannet_seg"), {
        "data.dataset": "synthetic_scene",
        "data.synthetic_size": 96,
        "model.num_classes": 4,
        "train.epochs": epochs,
        "train.ckpt_every": epochs,
        "train.ckpt_dir": ckpt_dir,
        # the protocol pins augmentation off (accuracy_targets.json,
        # scannet_seg_surface_spatial); --override data.augment=true
        # runs the augmented arm
        "data.augment": False,
        **(extra or {}),
    })
    return dataclasses.replace(
        cfg, name="scannet_seg+surface_spatial",
        model=dataclasses.replace(cfg.model, ignore_label=None))


def s3dis_config(epochs: int, ckpt_dir: str = ""):
    cfg = apply_overrides(presets.get("s3dis_seg"), {
        "data.dataset": "synthetic_scene",
        "data.num_points": 4096,
        "data.synthetic_size": 96,
        "model.num_classes": 4,
        "train.epochs": epochs,
        "train.eval_every": max(epochs // 10, 1),
        "train.ckpt_every": epochs,
        "train.ckpt_dir": ckpt_dir,
    })
    return dataclasses.replace(cfg, name="s3dis_seg+surface")


def field_config(epochs: int, seed: int = 0, extra: dict | None = None,
                 ckpt_dir: str = ""):
    cfg = apply_overrides(presets.get("s3dis_seg"), {
        "data.dataset": "synthetic_field",
        "data.num_points": 4096,
        "data.synthetic_size": 96,
        "model.num_classes": 4,
        "train.seed": seed,
        "train.epochs": epochs,
        "train.eval_every": max(epochs // 10, 1),
        "train.ckpt_every": epochs,
        "train.ckpt_dir": ckpt_dir,
        **(extra or {}),
    })
    return dataclasses.replace(cfg, name="s3dis_seg+field")


def _run_dir(out_dir: str, arm: str) -> str:
    """A fresh directory for one arm's run: a run never resumes another."""
    os.makedirs(out_dir, exist_ok=True)
    return tempfile.mkdtemp(prefix=f"conv_{arm}_", dir=out_dir)


def _read(log_path: str, kind: str) -> list:
    with open(log_path) as f:
        return [r for r in map(json.loads, f) if r.get("kind") == kind]


def _train_and_read(cfg, log_path: str, device: str) -> list:
    from gridgcn_torch.train.train import train

    train(cfg, log_path=log_path, device=device)
    return _read(log_path, "eval")


def run_cls(epochs: int, device: str, out_dir: str):
    d = _run_dir(out_dir, "cls")
    evals = _train_and_read(cls_config(epochs, os.path.join(d, "ck")),
                            os.path.join(d, "log.jsonl"), device)
    print("CLS eval trajectory (epoch, overall_acc):")
    for e in evals:
        print(f"  {e['epoch']:4d}  {e['overall_acc']:.4f}")
    best = max(e["overall_acc"] for e in evals)
    final = evals[-1]["overall_acc"]
    print(json.dumps({"run": "modelnet40_full+shapes40",
                      "final_overall_acc": final, "best": best}))
    return final


def _seg_arm(cfg, device: str, d: str, label: str, run: str, **keys):
    evals = _train_and_read(cfg, os.path.join(d, "log.jsonl"), device)
    print(f"{label} eval trajectory (epoch, overall_acc, miou):")
    for e in evals:
        print(f"  {e['epoch']:4d}  {e['overall_acc']:.4f}  {e['miou']:.4f}")
    final = evals[-1]
    rec = {"run": run, **keys, "final_overall_acc": final["overall_acc"],
           "final_miou": final["miou"]}
    return evals, rec


def run_seg(epochs: int, device: str, out_dir: str,
            extra: dict | None = None):
    d = _run_dir(out_dir, "seg")
    _, rec = _seg_arm(seg_config(epochs, extra, os.path.join(d, "ck")),
                      device, d, "SEG", "scannet_seg+surface")
    print(json.dumps(rec))
    return rec["final_miou"]


def run_spatial(epochs: int, device: str, out_dir: str,
                extra: dict | None = None):
    """`scannet_seg` trained spatially (tier 3 at one rank, each example
    one whole scene through `train_spatial`) on the seg arm's scenes, then
    evaluated with the seg arm's held-out protocol (the eval step over the
    test split's crops) on the final checkpoint."""
    import torch

    from gridgcn_torch.data.pipeline import make_dataset, to_device
    from gridgcn_torch.train.evaluate import _restore
    from gridgcn_torch.train.metrics import summarize_confusion
    from gridgcn_torch.train.steps import make_eval_step
    from gridgcn_torch.train.train import train_spatial
    from gridgcn_torch.utils import jaxrng

    d = _run_dir(out_dir, "spatial")
    cfg = spatial_config(epochs, extra, os.path.join(d, "ck"))
    log = os.path.join(d, "log.jsonl")
    train_spatial(cfg, mesh_devices=1, tier="resident_ml", log_path=log,
                  device=device)
    state = _restore(cfg.train.ckpt_dir, cfg, device)
    eval_step = make_eval_step(cfg)
    val_ds = make_dataset(cfg.data, "test", cfg.model.num_classes, "seg")
    C = cfg.model.num_classes
    cm = torch.zeros((C, C), dtype=torch.int32, device=state.device)
    ek = jaxrng.PRNGKey(10_000)
    for batch in val_ds.batches(cfg.data.eval_batch_size, seed=0,
                                shuffle=False, drop_last=False):
        cm = cm + eval_step(state, to_device(batch, state.device), ek)
    s = summarize_confusion(cm)
    last_ep = _read(log, "epoch")[-1]
    print(f"SPATIAL-TRAIN held-out: overall_acc {float(s['overall_acc']):.4f}"
          f"  miou {float(s['miou']):.4f}  (final train acc "
          f"{last_ep['acc']:.4f}, ghost_overflow "
          f"{last_ep.get('ghost_overflow', 0)})")
    print(json.dumps({"run": "scannet_seg+surface_spatial_tier3",
                      "final_overall_acc": float(s["overall_acc"]),
                      "final_miou": float(s["miou"]),
                      "ghost_overflow": int(last_ep.get("ghost_overflow",
                                                        0))}))
    return float(s["miou"])


def run_s3dis(epochs: int, device: str, out_dir: str):
    d = _run_dir(out_dir, "s3dis")
    _, rec = _seg_arm(s3dis_config(epochs, os.path.join(d, "ck")), device,
                      d, "S3DIS", "s3dis_seg+surface")
    print(json.dumps(rec))
    return rec["final_miou"]


def run_field(epochs: int, device: str, out_dir: str, seed: int = 0,
              extra: dict | None = None):
    d = _run_dir(out_dir, f"field{seed}")
    evals, rec = _seg_arm(
        field_config(epochs, seed, extra, os.path.join(d, "ck")), device, d,
        "FIELD", "s3dis_seg+field", seed=seed)
    rec["best_overall_acc"] = max(e["overall_acc"] for e in evals)
    print(json.dumps(rec))
    return rec["final_overall_acc"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run",
                    choices=["cls", "seg", "s3dis", "field", "spatial",
                             "both", "all"],
                    default="both")
    ap.add_argument("--epochs-cls", type=int, default=30)
    ap.add_argument("--epochs-seg", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0,
                    help="train seed (field arm: paired-seed spread)")
    ap.add_argument("--override", action="append", default=[],
                    help="dotted config override k=v, applied to the seg, "
                         "spatial and field arms (cls/s3dis ignore it)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out-dir", default="build/convergence",
                    help="each arm's run directory goes under it")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("convergence_torch: no CUDA device (pass "
                             "--device cpu to train on the CPU)")
    extra = parse_cli_overrides(args.override)
    kw = dict(device=args.device, out_dir=args.out_dir)
    if args.run in ("cls", "both", "all"):
        run_cls(args.epochs_cls, **kw)
    if args.run in ("seg", "both", "all"):
        run_seg(args.epochs_seg, extra=extra, **kw)
    if args.run in ("s3dis", "all"):
        run_s3dis(args.epochs_seg, **kw)
    if args.run in ("spatial", "all"):
        run_spatial(args.epochs_seg, extra=extra, **kw)
    if args.run in ("field", "all"):
        run_field(args.epochs_seg, seed=args.seed, extra=extra, **kw)


if __name__ == "__main__":
    main()
