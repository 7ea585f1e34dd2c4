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
rank gets the whole batch's logits. On a mesh, `predict_scene` shards one
scene over the ranks with a resident tier (`spatial=`: "resident",
"resident_ml", or "auto", tier 3 when every layer's center count divides
the mesh size), and `predict_scenes` serves B scenes at once on a 2-D
(scene × slab) mesh of the same ranks, built at first use. Each call runs
with TF32 off (`utils.precision.full_fp32`), the caller's setting restored
after.

On one CUDA device without a mesh the forward replays from CUDA graphs
(`graphs.Signatures`): a request signature (B, N, the feature width) runs
the eager forward (the key on the host) at its first call, is captured at
its second and
replayed at every later call, cut at the program's spans so that a trace
of a replay holds the spans of the eager forward. The inputs and
the key are copied into static buffers on the card, the key as the int64
words that `torch.export` takes (`jaxrng.key_tensor`), so every key
derivation runs on the card and a new key gives its own draws; the logits
are copied out into a fresh array at each call. `graphs=False` keeps the
eager forward for every call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gridgcn_torch.graphs import CudaGraphs, Signatures
from gridgcn_torch.models.build import build_model
from gridgcn_torch.models.fold import fold_inference
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.precision import full_fp32
from gridgcn_torch.utils.profiling import annotate

class Predictor:
    def __init__(self, cfg, state_dict, device="cuda", mesh=None,
                 graphs: bool = True):
        """cfg: a `configs.base.Config`; state_dict: the model's unfolded
        weights (e.g. from `init_model` or `utils.convert`); device: where
        the model runs — "cuda" (the default) raises when CUDA is absent,
        "cpu" runs the kernels' plain versions. mesh: None (one device),
        an int (a data-parallel mesh of that many ranks, one device each,
        inside a process group) or a `parallel.mesh.Mesh`, whose device
        then replaces `device`. graphs: replay the forward from CUDA
        graphs where it runs on one CUDA device without a mesh (False:
        the eager forward, against which tests hold the replay).

        `requests` counts the calls; `captures` the signatures captured
        and `replays` the calls replayed (0 on the CPU, on a mesh and with
        graphs=False). The kernels' host counters (`knn3_mxu.launches`,
        `jaxrng.launches`) count the eager calls and each capture, never a
        replay."""
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
        self._scene_fwds = {}       # per spatial tier, built at first use
        self.requests = 0           # calls made, each one span `request#<n>`
        self._graphs = (Signatures(lambda: CudaGraphs(self.device))
                        if graphs and self.mesh is None
                        and self.device.type == "cuda" else None)

    @property
    def captures(self) -> int:
        return self._graphs.captures if self._graphs else 0

    @property
    def replays(self) -> int:
        return self._graphs.replays if self._graphs else 0

    @torch.no_grad()
    @full_fp32()
    def __call__(self, xyz, feat=None, mask=None,
                 rng: Optional[np.ndarray] = None) -> np.ndarray:
        """xyz [N,3] or [B,N,3] → logits: [C] / [B,C] for classification,
        [N,C] / [B,N,C] for per-point tasks. The call is the span
        `request#<n>`, n its number among this Predictor's calls, with the
        spans `copy_in` (inputs to the device) and `fetch` (logits to the
        host) inside it."""
        self.requests += 1
        with annotate(f"request#{self.requests - 1}"):
            return self._predict(xyz, feat, mask, rng)

    def _predict(self, xyz, feat, mask, rng) -> np.ndarray:
        if self._graphs is not None:
            sig = _signature(xyz, feat)
            if self._graphs.seen(sig):
                with torch.cuda.device(self.device):
                    return self._replayed(sig, xyz, feat, mask, rng)
        dev = self.device
        with annotate("copy_in"):
            xyz = torch.as_tensor(xyz, dtype=torch.float32, device=dev)
            squeeze = xyz.dim() == 2
            if squeeze:
                xyz = xyz[None]
                feat = None if feat is None else torch.as_tensor(feat)[None]
                mask = None if mask is None else torch.as_tensor(mask)[None]
            if mask is None:
                mask = torch.ones(xyz.shape[:2], dtype=torch.bool,
                                  device=dev)
            mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
            if feat is not None:
                feat = torch.as_tensor(feat, dtype=torch.float32, device=dev)
        key = rng if rng is not None else jaxrng.PRNGKey(0)
        if self.mesh is None:
            logits = self._model(xyz, feat, mask, key)
            with annotate("fetch"):
                out = logits.float().cpu().numpy()
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
                             rows(mask), key, row0=r0)
        with annotate("fetch"):
            out = self.mesh.gather_rows(logits.float(), Bp)[:B].cpu().numpy()
        return out[0] if squeeze else out

    def _replayed(self, sig, xyz, feat, mask, rng) -> np.ndarray:
        """The single-device forward on the card from CUDA graphs
        (`graphs.Signatures`), on the signature's static inputs."""
        with annotate("copy_in"):
            xyz = torch.as_tensor(xyz, dtype=torch.float32)
            feat = None if feat is None else torch.as_tensor(
                feat, dtype=torch.float32)
            mask = None if mask is None else torch.as_tensor(
                mask, dtype=torch.bool)
            squeeze = xyz.dim() == 2
            if squeeze:
                xyz = xyz[None]
                feat = None if feat is None else feat[None]
                mask = None if mask is None else mask[None]
            static = self._graphs.static(
                sig, lambda: _StaticInputs(xyz, feat, self.device))
            static.fill(xyz, feat, mask,
                        jaxrng.PRNGKey(0) if rng is None else rng)
        logits = self._graphs.run(sig, lambda: self._model(*static.args))
        with annotate("fetch"):
            out = logits.float().cpu().numpy()
        return out[0] if squeeze else out

    def predict_classes(self, xyz, feat=None, mask=None):
        """The argmax of the logits: a class per cloud (classification) or
        per point."""
        return np.argmax(self(xyz, feat, mask), axis=-1)

    def predict_scene(self, xyz, feat=None, *, votes: int = 1,
                      spatial: str = "auto",
                      rng: Optional[np.ndarray] = None) -> np.ndarray:
        """Whole-scene per-point logits [N, C] for ONE scene [N, 3]:
        `votes` CAGQ keys `fold_in(rng, v)` are logit-averaged (the
        reference's whole-scene voting protocol). Without a mesh the scene
        runs on this device; on a mesh it is sharded over the ranks by a
        resident tier, `spatial` "resident" (tier 2), "resident_ml" (tier
        3) or "auto" (tier 3 when every layer's n_centers divides the
        mesh size, else tier 2), and every rank gets the logits. `feat`
        [N, in_channels] is required when the config has input channels
        and rides the partition."""
        if self.cfg.model.task != "seg":
            raise ValueError("predict_scene is for segmentation models")
        if votes < 1:
            raise ValueError(f"votes must be >= 1, got {votes}")
        spatial = spatial.replace("-", "_")
        if spatial not in ("auto", "resident", "resident_ml"):
            raise ValueError(f"unknown spatial tier {spatial!r}; expected "
                             "'auto', 'resident', or 'resident_ml'")
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
        if self.mesh is None:
            acc = None
            for v in range(votes):
                lg = self(xyz, feat, rng=jaxrng.fold_in(rng, v))
                acc = lg if acc is None else acc + lg
            return acc / votes

        from gridgcn_torch.parallel import resident, resident_ml

        if spatial == "auto":
            divides = all(layer.n_centers % self.mesh.size == 0
                          for layer in self.cfg.model.layers)
            spatial = "resident_ml" if divides else "resident"
        if spatial not in self._scene_fwds:
            make = (resident_ml.make_resident_ml_forward
                    if spatial == "resident_ml"
                    else resident.make_resident_forward)
            self._scene_fwds[spatial] = make(self.cfg, self.mesh)
        predict = (resident_ml.resident_ml_seg_predict
                   if spatial == "resident_ml"
                   else resident.resident_seg_predict)
        return predict(self.cfg, self._model, xyz, np.ones(len(xyz), bool),
                       self.mesh, rng=rng, fwd=self._scene_fwds[spatial],
                       votes=votes, feat=feat)

    def predict_scenes(self, scenes_xyz, feats=None, *, votes: int = 1,
                       rng: Optional[np.ndarray] = None) -> np.ndarray:
        """Whole-scene logits [B, N, C] for B scenes at once, on a mesh
        Predictor whose size B divides: the scenes ride the data axis of a
        2-D mesh of the same ranks (built at first use for each B), each
        scene's slabs a ring of mesh size / B ranks (tier 3). Each scene's
        logits are the 1-D tier-3 path's under key row b of split(rng, B)
        (fold_in(rng, v) per vote first when votes > 1); every rank gets
        them. `feats` [B, N, in_channels] when the config has input
        channels."""
        if self.cfg.model.task != "seg":
            raise ValueError("predict_scenes is for segmentation models")
        if self.mesh is None:
            raise ValueError("predict_scenes needs a mesh Predictor "
                             "(Predictor(..., mesh=N))")
        if votes < 1:
            raise ValueError(f"votes must be >= 1, got {votes}")
        scenes_xyz = np.asarray(scenes_xyz, np.float32)
        if scenes_xyz.ndim != 3 or scenes_xyz.shape[-1] != 3:
            raise ValueError(f"scenes_xyz must be [B, N, 3], got "
                             f"{scenes_xyz.shape}")
        B, D = scenes_xyz.shape[0], self.mesh.size
        if B < 1 or D % B:
            raise ValueError(f"scene count {B} must divide the mesh size "
                             f"{D}")
        Ds = D // B
        if any(layer.n_centers % Ds for layer in self.cfg.model.layers):
            raise ValueError(
                f"tier-3 scene batching needs every layer's n_centers "
                f"divisible by {Ds} spatial shards "
                f"({[layer.n_centers for layer in self.cfg.model.layers]})")
        C_in = self.cfg.model.in_channels
        if C_in:
            if feats is None:
                raise ValueError(f"this config has in_channels={C_in}: "
                                 f"predict_scenes needs feats [B, N, {C_in}]")
            feats = np.asarray(feats, np.float32)
            if feats.shape != scenes_xyz.shape[:2] + (C_in,):
                raise ValueError(f"feats shape {feats.shape} != expected "
                                 f"{scenes_xyz.shape[:2] + (C_in,)}")

        from gridgcn_torch.parallel.mesh import (
            DATA_AXIS, SPACE_AXIS, make_mesh2d)
        from gridgcn_torch.parallel.resident_ml import (
            make_resident_ml_forward, resident_ml_seg_predict_scenes)

        key = ("scenes", B)
        if key not in self._scene_fwds:
            mesh2d = make_mesh2d(B, Ds, [self.device] * D)
            self._scene_fwds[key] = (mesh2d, make_resident_ml_forward(
                self.cfg, mesh2d, axis_name=SPACE_AXIS,
                batch_axis=DATA_AXIS))
        mesh2d, fwd = self._scene_fwds[key]
        masks = np.ones(scenes_xyz.shape[:2], bool)
        rng = jaxrng.PRNGKey(0) if rng is None else rng
        acc = None
        for v in range(votes):
            k = jaxrng.fold_in(rng, v) if votes > 1 else rng
            lg = resident_ml_seg_predict_scenes(
                self.cfg, self._model, scenes_xyz, masks, mesh2d,
                feats=feats, rng=k, fwd=fwd)
            acc = lg if acc is None else acc + lg
        return acc / votes


def _signature(xyz, feat) -> tuple:
    """A request's signature: (B, N, the feature width or None), B = 1 for
    one cloud [N, 3]. The inputs' dtypes are not in it: the static buffers
    hold them cast, as the eager forward casts them."""
    shape = tuple(np.shape(xyz))
    lead = (1,) if len(shape) == 2 else ()
    return (*lead, *shape[:-1], None if feat is None else np.shape(feat)[-1])


class _StaticInputs:
    """A signature's inputs on the card, which its captured forward reads
    at each replay: xyz, feat (or None), mask and the key, int64 [2],
    written through a page-locked block without blocking."""

    def __init__(self, xyz, feat, device):
        self.xyz = torch.empty(xyz.shape, device=device)
        self.feat = None if feat is None else torch.empty(feat.shape,
                                                          device=device)
        self.mask = torch.empty(xyz.shape[:2], dtype=torch.bool,
                                device=device)
        self.key = torch.empty(2, dtype=torch.int64, device=device)
        self._key_host = torch.empty(2, dtype=torch.int64, pin_memory=True)

    @property
    def args(self) -> tuple:
        return self.xyz, self.feat, self.mask, self.key

    def fill(self, xyz, feat, mask, key):
        self.xyz.copy_(xyz)
        if feat is not None:
            self.feat.copy_(feat)
        if mask is None:
            self.mask.fill_(True)
        else:
            self.mask.copy_(mask)
        # the last call's copy out of this block is done: that call's
        # logits reached the host after it
        self._key_host.numpy()[:] = np.asarray(key, np.uint32)
        self.key.copy_(self._key_host, non_blocking=True)


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
