"""Freeze a checkpoint's served forward into one artifact (the JAX
package's `export.py`).

`torch.export` traces the folded forward (`models.fold.fold_inference`,
the preset's inference dtype) at a fixed [B, N] signature into a program
that holds its weights, saved with `torch.export.save`; a `.json` beside
it holds the config and the signature. A serving process then needs no
model-building code and no checkpoint directory.

    python -m gridgcn_torch.export --ckpt-dir checkpoints/run --out model.pt2
    # serving side:
    from gridgcn_torch.export import load_exported
    predict = load_exported("model.pt2")
    logits = predict(points)          # [B,N,3] -> [B,C] / [B,N,C]

The program's signature is (xyz [B,N,3] f32, feat [B,N,Cin] f32 if the
model takes features, mask [B,N] bool, key [2] int64): the CAGQ key is an
input (the words of a jaxrng key), so every key derivation and draw is
traced, not frozen. The decoder's kNN kernels are the custom ops of
`kernels.knn` and each draw one of `kernels.rng` (`gridgcn::rng_draw_keys`,
the key a tensor): the loader imports both modules so that they exist, and
an exported program on the card launches them (counted in
`knn3_mxu.launches` and `jaxrng.launches`). The program is pinned to the device it was traced on
(`meta["platforms"]`). TF32 is not part of the program: the loader runs it
with TF32 off (`utils.precision.full_fp32`), as the live Predictor does.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.precision import full_fp32


class _Forward(torch.nn.Module):
    """The served forward with the artifact's signature."""

    def __init__(self, model: torch.nn.Module, with_feat: bool):
        super().__init__()
        self.model = model
        self.with_feat = with_feat

    def forward(self, xyz, *rest):
        feat, mask, key = rest if self.with_feat else (None, *rest)
        return self.model(xyz, feat, mask, key)


def export_predictor(ckpt_dir: str, out_path: str,
                     batch_size: Optional[int] = None,
                     num_points: Optional[int] = None,
                     step: Optional[int] = None, device="cuda") -> dict:
    """Freeze the checkpoint's forward at a fixed [B, N] signature on
    `device`. Writes `out_path` (a `torch.export` program) and
    `out_path + '.json'` (config and signature). Returns the meta dict."""
    from gridgcn_torch.api import load_predictor
    from gridgcn_torch.configs.base import to_json

    p = load_predictor(ckpt_dir, step=step, device=device)
    cfg, dev = p.cfg, p.device
    B = batch_size or cfg.data.eval_batch_size
    N = num_points or cfg.data.num_points
    Cin = cfg.model.in_channels
    args = [torch.zeros((B, N, 3), device=dev)]
    if Cin > 0:
        args.append(torch.zeros((B, N, Cin), device=dev))
    args.append(torch.ones((B, N), dtype=torch.bool, device=dev))
    args.append(jaxrng.key_tensor(jaxrng.PRNGKey(0), dev))
    with torch.no_grad(), full_fp32():
        program = torch.export.export(_Forward(p._model, Cin > 0),
                                      tuple(args), strict=False)
    torch.export.save(program, out_path)
    meta = {
        "format": "gridgcn-torch-export-v1",
        "config": json.loads(to_json(cfg)),
        "task": cfg.model.task,
        "num_classes": cfg.model.num_classes,
        "batch_size": B,
        "num_points": N,
        "in_channels": Cin,
        "step": p.step,
        "platforms": [dev.type],
        "torch_version": torch.__version__,
        "bytes": os.path.getsize(out_path),
    }
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ExportedPredictor:
    """Serving-side wrapper: pads any batch [B' <= B, N' <= N] to the
    exported signature (padding masked off), trims the logits back."""

    def __init__(self, path: str):
        import gridgcn_torch.kernels.knn  # noqa: F401  (the custom ops)
        import gridgcn_torch.kernels.rng  # noqa: F401

        with open(path + ".json") as f:
            self.meta = json.load(f)
        self.task = self.meta["task"]
        self.B = self.meta["batch_size"]
        self.N = self.meta["num_points"]
        self.Cin = self.meta["in_channels"]
        self.device = torch.device(self.meta["platforms"][0])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("this program was exported for CUDA, which "
                               "is not available")
        self._fn = torch.export.load(path).module()

    @torch.no_grad()
    @full_fp32()
    def __call__(self, xyz, feat=None, mask=None, rng=None,
                 votes: int = 1) -> np.ndarray:
        """`votes` > 1 logit-averages that many CAGQ keys fold_in(rng, v)
        (the whole-scene voting protocol); the padded input is staged
        once."""
        if votes < 1:
            raise ValueError(f"votes must be >= 1, got {votes}")
        xyz = np.asarray(xyz, np.float32)
        squeeze = xyz.ndim == 2
        if squeeze:
            xyz = xyz[None]
            if feat is not None:
                feat = np.asarray(feat, np.float32)[None]
            if mask is not None:
                mask = np.asarray(mask, bool)[None]
        Bq, Nq = xyz.shape[:2]
        if Bq > self.B or Nq > self.N:
            raise ValueError(
                f"input [{Bq},{Nq}] exceeds the exported signature "
                f"[{self.B},{self.N}]; re-export with larger capacity")
        if (self.Cin > 0) != (feat is not None):
            raise ValueError(
                f"exported model takes in_channels={self.Cin}; got "
                f"feat={'present' if feat is not None else 'none'}")
        if mask is None:
            mask = np.ones((Bq, Nq), bool)
        dev = self.device
        x = torch.zeros((self.B, self.N, 3), device=dev)
        x[:Bq, :Nq] = torch.as_tensor(xyz, device=dev)
        m = torch.zeros((self.B, self.N), dtype=torch.bool, device=dev)
        m[:Bq, :Nq] = torch.as_tensor(np.asarray(mask, bool), device=dev)
        args = [x]
        if self.Cin > 0:
            f = torch.zeros((self.B, self.N, self.Cin), device=dev)
            f[:Bq, :Nq] = torch.as_tensor(feat, device=dev)
            args.append(f)
        args.append(m)
        key = np.asarray(rng if rng is not None else jaxrng.PRNGKey(0),
                         np.uint32)
        acc = None
        for v in range(votes):
            k = jaxrng.fold_in(key, v) if votes > 1 else key
            lg = self._fn(*args, jaxrng.key_tensor(k, dev))
            acc = lg if acc is None else acc + lg
        out = (acc.float() / votes).cpu().numpy()
        out = out[:Bq, :Nq] if self.task == "seg" else out[:Bq]
        return out[0] if squeeze else out


def load_exported(path: str) -> ExportedPredictor:
    return ExportedPredictor(path)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Freeze a checkpoint's forward into a serving artifact")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--num-points", type=int, default=None)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the program runs (cuda raises without a "
                         "card)")
    args = ap.parse_args(argv)
    meta = export_predictor(args.ckpt_dir, args.out,
                            batch_size=args.batch_size,
                            num_points=args.num_points, step=args.step,
                            device=args.device)
    print(json.dumps({k: meta[k] for k in
                      ("task", "batch_size", "num_points", "step",
                       "platforms", "bytes")}))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
