"""Serving API: a config and a state_dict → a predictor on one device.

    from gridgcn_torch.api import Predictor
    predict = Predictor(cfg, state_dict)          # device="cuda"
    logits = predict(points)                      # [N,3] or [B,N,3]
    labels = predict.predict_classes(points)
    scene = predict.predict_scene(points, votes=2)
    predict = load_predictor("checkpoints")       # a trainer's checkpoint
    predict = Predictor(cfg, state_dict, mesh=2)  # in each of 2 workers

Every preset serves: the classifiers and the segmentation networks with
any decoder method. The serving protocol is the JAX package's: BatchNorm
folded into the Dense weights and the weights pre-cast to the preset's
inference dtype (`models.fold.fold_inference`). Logits are float32 numpy
arrays: [C] / [B, C] for classification, [N, C] / [B, N, C] for per-point
tasks. The CAGQ randomness comes from a jaxrng key
(default `PRNGKey(0)`), so the same key gives the JAX package's indices.

Mesh serving (`mesh=`, data parallelism): every rank of a
`parallel.mesh` group calls with the same batch; the batch is padded to a
multiple of the mesh size as the JAX package pads it, each rank runs its
rows (the per-cloud keys those of the padded batch, as JAX's), and every
rank gets the whole batch's logits. The resident tiers
(`predict_scene(spatial=)` on a mesh, `predict_scenes`) are not ported
yet. Each call runs with TF32 off (`utils.precision.full_fp32`), the
caller's setting restored after.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gridgcn_torch.models.build import build_model
from gridgcn_torch.models.fold import fold_inference
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.precision import full_fp32

RESIDENT = ("the resident spatial tiers (predict_scene on a mesh, "
            "predict_scenes) are not ported yet (ROADMAP queue 1, item 7)")


class Predictor:
    def __init__(self, cfg, state_dict, device="cuda", mesh=None):
        """cfg: a `configs.base.Config`; state_dict: the model's unfolded
        weights (e.g. from `init_model` or `utils.convert`); device: where
        the model runs — "cuda" (the default) raises when CUDA is absent,
        "cpu" runs the kernels' plain versions. mesh: None (one device),
        an int (a data-parallel mesh of that many ranks, one device each,
        inside a process group) or a `parallel.mesh.Mesh`, whose device
        then replaces `device`."""
        self.mesh = None
        if mesh is not None:
            from gridgcn_torch.parallel.mesh import make_mesh, mesh_devices

            self.mesh = (make_mesh(mesh, mesh_devices(device, mesh))
                         if isinstance(mesh, int) else mesh)
            device = self.mesh.device
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        self.cfg, folded = fold_inference(cfg, state_dict)
        model = build_model(self.cfg.model)
        model.load_state_dict(folded)
        self._model = model.to(self.device).eval()

    @torch.no_grad()
    @full_fp32()
    def __call__(self, xyz, feat=None, mask=None,
                 rng: Optional[np.ndarray] = None) -> np.ndarray:
        """xyz [N,3] or [B,N,3] → logits: [C] / [B,C] for classification,
        [N,C] / [B,N,C] for per-point tasks."""
        dev = self.device
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=dev)
        squeeze = xyz.dim() == 2
        if squeeze:
            xyz = xyz[None]
            feat = None if feat is None else torch.as_tensor(feat)[None]
            mask = None if mask is None else torch.as_tensor(mask)[None]
        if mask is None:
            mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
        if feat is not None:
            feat = torch.as_tensor(feat, dtype=torch.float32, device=dev)
        key = rng if rng is not None else jaxrng.PRNGKey(0)
        if self.mesh is None:
            out = self._model(xyz, feat, mask, key).float().cpu().numpy()
            return out[0] if squeeze else out
        # mesh serving: pad to the shard count, run this rank's rows (the
        # keys those of the padded batch), gather every rank's logits
        B = xyz.shape[0]
        Bp = B + (-B) % self.mesh.size
        r0, r1 = self.mesh.rows(Bp)

        def rows(t):
            pad = t.new_zeros((Bp - B, *t.shape[1:]))
            return torch.cat([t, pad])[r0:r1]
        logits = self._model(rows(xyz), None if feat is None else rows(feat),
                             rows(mask), key, row0=r0).float()
        out = self.mesh.gather_rows(logits, Bp)[:B].cpu().numpy()
        return out[0] if squeeze else out

    def predict_classes(self, xyz, feat=None, mask=None):
        """The argmax of the logits: a class per cloud (classification) or
        per point."""
        return np.argmax(self(xyz, feat, mask), axis=-1)

    def predict_scene(self, xyz, feat=None, *, votes: int = 1,
                      spatial: str = "auto",
                      rng: Optional[np.ndarray] = None) -> np.ndarray:
        """Whole-scene per-point logits for ONE scene [N, 3] on this
        device: `votes` CAGQ keys `fold_in(rng, v)` are logit-averaged (the
        reference's whole-scene voting protocol). On a mesh the JAX
        package shards the scene over it with a resident tier (`spatial`),
        which is not ported yet and raises."""
        if self.cfg.model.task != "seg":
            raise ValueError("predict_scene is for segmentation models")
        if votes < 1:
            raise ValueError(f"votes must be >= 1, got {votes}")
        spatial = spatial.replace("-", "_")
        if spatial not in ("auto", "resident", "resident_ml"):
            raise ValueError(f"unknown spatial tier {spatial!r}; expected "
                             "'auto', 'resident', or 'resident_ml'")
        if self.mesh is not None:
            raise NotImplementedError(RESIDENT)
        xyz = np.asarray(xyz, np.float32)
        C_in = self.cfg.model.in_channels
        if C_in and feat is None:
            raise ValueError(f"this config has in_channels={C_in}: "
                             f"predict_scene needs feat [N, {C_in}]")
        if feat is not None:
            feat = np.asarray(feat, np.float32)
            if feat.shape != (xyz.shape[0], C_in):
                raise ValueError(f"feat shape {feat.shape} != expected "
                                 f"{(xyz.shape[0], C_in)}")
        rng = jaxrng.PRNGKey(0) if rng is None else rng
        acc = None
        for v in range(votes):
            lg = self(xyz, feat, rng=jaxrng.fold_in(rng, v))
            acc = lg if acc is None else acc + lg
        return acc / votes

    def predict_scenes(self, scenes_xyz, feats=None, *, votes: int = 1,
                       rng=None):
        raise NotImplementedError(RESIDENT)


def load_predictor(ckpt_dir: str, step: Optional[int] = None,
                   device="cuda", mesh=None) -> Predictor:
    """A Predictor for a checkpoint directory written by the trainer: its
    config and the newest (or the given) step's weights. The step served
    is `.step`. mesh=N serves data-parallel over N ranks (see
    `Predictor`)."""
    from gridgcn_torch.utils.checkpoint import CheckpointManager

    ckpt = CheckpointManager(ckpt_dir, CheckpointManager.load_config(ckpt_dir))
    payload = ckpt.read(step)
    if payload is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    pred = Predictor(ckpt.cfg, payload["model"], device=device, mesh=mesh)
    pred.step = int(payload["optimizer"]["count"])
    return pred
