"""One-command reference-parity pipeline for the PyTorch port (the
counterpart of `scripts/parity.py`): "data mounted" → "parity verified".

  python scripts/parity_torch.py --dataset modelnet40 --root data
  python scripts/parity_torch.py --dataset s3dis --root data [--fold K]
  python scripts/parity_torch.py --dataset scannet --root data [--skip-train]
  ... [--device cuda|cpu]

Per dataset: verifies the data layout (`scripts/prepare_data_torch.py`
check), trains the matching preset with `gridgcn_torch.train.train`
(resuming from any existing checkpoint), then runs the reference's
evaluation protocol with the published target gate through
`gridgcn_torch.train.evaluate --target`
(`gridgcn_torch/train/accuracy_targets.json`), with the JAX script's
argument lists. Exit 0 = parity. It runs on the card unless `--device cpu`
is given.
"""

from __future__ import annotations

import argparse
import os
import sys

_PRESET = {"modelnet40": "modelnet40_full", "s3dis": "s3dis_seg",
           "scannet": "scannet_seg"}
_EVAL_FLAGS = {
    "modelnet40": ["--votes", "12"],                     # rotation voting
    "s3dis": ["--s3dis-rooms"],                          # room block-merge
    "scannet": ["--whole-scene", "--votes", "3"],        # voxel projection
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", required=True, choices=sorted(_PRESET))
    p.add_argument("--root", default="data")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--skip-train", action="store_true",
                   help="evaluate an existing checkpoint only")
    p.add_argument("--fold", type=int, default=None, choices=range(1, 7),
                   help="s3dis only: hold out Area_<fold> (the paper's "
                        "6-fold CV; default is the Area-5 protocol)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train and evaluate (cuda raises without "
                        "a card)")
    p.add_argument("overrides", nargs="*",
                   help="extra train config overrides (a.b=c)")
    args = p.parse_args(argv)
    if args.fold is not None and args.dataset != "s3dis":
        p.error("--fold is an s3dis protocol option")

    from gridgcn_torch.train import evaluate as eval_cli
    from gridgcn_torch.train import train as train_cli
    from scripts.prepare_data_torch import check

    rc = check(args.root, dataset=args.dataset)
    if rc:
        print("parity: dataset files missing — fix the layout above before "
              "training (otherwise make_dataset would silently fall back "
              "to synthetic data)", file=sys.stderr)
        return rc
    suffix = f"_fold{args.fold}" if args.fold is not None else ""
    ckpt = args.ckpt_dir or f"checkpoints/{_PRESET[args.dataset]}{suffix}"
    overrides = list(args.overrides)
    if args.fold is not None:
        # eval reads the holdout back from the checkpoint's config
        overrides.append(f"data.s3dis_holdout=Area_{args.fold}")
    device = ["--device", args.device]
    if not args.skip_train:
        train_cli.main([
            "--preset", _PRESET[args.dataset],
            f"data.root={args.root}", f"train.ckpt_dir={ckpt}",
            *overrides, *device])
    eval_cli.main(["--ckpt-dir", ckpt, "--target", args.dataset,
                   *_EVAL_FLAGS[args.dataset], *device])
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
