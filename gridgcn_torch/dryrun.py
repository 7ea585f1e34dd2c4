"""The multi-device dry run: one pass over every parallel program of the
port (the JAX package's `__graft_entry__.dryrun_multichip`, part for part).

    python -m gridgcn_torch.dryrun --devices N [--device cpu]

starts N ranks on localhost (`parallel.launch`; under `torchrun`, or
inside a process group, it runs as this rank) and runs, in order:

  1. the DP train step on `synthetic_tiny` (batch 2N, 128 points,
     augmentation on);
  2. `exchange_halo_planes` on an [N·4, 8] ramp;
  3. the tier-2 and tier-3 forwards of `synthetic_tiny_seg`;
  4. the tier-2 spatial train step;
  5. featured `s3dis_seg` through tier 3, serving and one train step with
     calibrated ghost caps (`FEATURED_SPATIAL_TRAIN`);
  6. for N ≥ 4, the 2 × N/2 scene-batched tier-3 forward and train step
     (`SCENE_BATCHED_TIER3`, `SCENE_BATCHED_TIER3_TRAIN`);
  7. the communication audit of `scannet_seg` and `scannet_whole_scene`
     at the default, calibrated and quarter-share ghost caps
     (`COMM_REPORT`), each preset whose layers' center counts divide N.

The ranks run on `cuda` unless the caller asks for the CPU: one card per
rank when there are N, else the ranks share the cards (gloo), as the
resident tiers do on one card. The printed lines keep the reference's
formats; their numbers are the port's.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from gridgcn_torch.configs import presets
from gridgcn_torch.configs.base import apply_overrides
from gridgcn_torch.parallel.launch import launch


def rank_devices(n: int, device="cuda") -> list:
    """The n ranks' devices: the CPU n times, or the cards round-robin
    (raises without a card)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * n
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"dryrun: no CUDA device for --device {device} "
                           f"(pass --device cpu to run on the CPU)")
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(n)]


def _finite(x) -> bool:
    return bool(torch.isfinite(torch.as_tensor(x)).all())


def _train_state(cfg, model, sd, dev):
    from gridgcn_torch.train.steps import create_train_state

    return create_train_state(cfg, model, sd, 4, device=dev)


def _init(cfg, dev, seed: int = 0):
    from gridgcn_torch.models.build import init_model

    model, sd = init_model(cfg.model, torch.Generator().manual_seed(seed))
    return model.to(dev), sd


def _run(n: int, devices: list, anchors: Optional[dict]) -> dict:
    """One rank's dry run; returns what rank 0 printed, by line kind."""
    from gridgcn_torch.data.pipeline import make_dataset
    from gridgcn_torch.data.synthetic import synthetic_scene_surface
    from gridgcn_torch.parallel import dp
    from gridgcn_torch.parallel.comm_audit import comm_report
    from gridgcn_torch.parallel.mesh import (
        DATA_AXIS, make_mesh, make_mesh2d, shard_batch)
    from gridgcn_torch.parallel.resident import resident_seg_predict
    from gridgcn_torch.parallel.resident_ml import (
        calibrate_ghost_cap, resident_ml_seg_predict,
        resident_ml_seg_predict_scenes)
    from gridgcn_torch.parallel.spatial import exchange_halo_planes
    from gridgcn_torch.parallel.spatial_train import (
        make_spatial_train_step, shard_scene_batch, shard_scene_batches)
    from gridgcn_torch.utils.jaxrng import PRNGKey

    mesh = make_mesh(n, devices)
    dev = mesh.device
    if dev.type == "cpu":          # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    lead = mesh.rank == 0
    out = {"lines": []}

    def say(line: str):
        out["lines"].append(line)
        if lead:
            print(line, flush=True)

    # 1. the DP train step
    cfg = apply_overrides(presets.get("synthetic_tiny"), {
        "data.batch_size": 2 * n, "data.num_points": 128,
        "data.augment": True})
    model, sd = _init(cfg, dev)
    state = _train_state(cfg, model, sd, dev)
    ds = make_dataset(cfg.data, "train", cfg.model.num_classes, "cls")
    batch = next(ds.batches(cfg.data.batch_size, seed=0))
    state, metrics = dp.make_parallel_train_step(cfg, mesh)(
        state, shard_batch(batch, mesh), PRNGKey(0))
    assert _finite(metrics["loss"]), "dry-run loss not finite"
    assert state.step == 1
    out["dp_loss"] = float(metrics["loss"])

    # 2. the halo-plane exchange: each rank's slab of an [n·W, R] ramp
    W, R = 4, 8
    ramp = torch.arange(n * W * R, dtype=torch.float32).reshape(n * W, R)
    local = ramp[mesh.rank * W:(mesh.rank + 1) * W].to(dev)
    lg, rg = exchange_halo_planes(local, mesh)
    halo = torch.cat([lg, local, rg])
    assert halo.shape == (W + 2, R)
    if mesh.rank > 0:
        assert torch.equal(lg.cpu(), ramp[mesh.rank * W - 1:mesh.rank * W])

    # 3. tiers 2 and 3, 4. the tier-2 spatial train step
    seg_cfg = presets.get("synthetic_tiny_seg")
    if seg_cfg.model.layers[0].n_centers % n == 0:
        seg_model, seg_sd = _init(seg_cfg, dev)
        rng = np.random.default_rng(0)
        N = 64 * n
        sxyz = rng.uniform(0, 8, size=(N, 3)).astype(np.float32)
        smask = np.ones(N, bool)
        logits = resident_seg_predict(seg_cfg, seg_model, sxyz, smask, mesh,
                                      capacity=N)
        assert logits.shape == (N, seg_cfg.model.num_classes)
        assert np.isfinite(logits).all(), "resident dry-run logits not finite"
        if all(layer.n_centers % n == 0 for layer in seg_cfg.model.layers):
            logits = resident_ml_seg_predict(seg_cfg, seg_model, sxyz, smask,
                                             mesh, capacity=N)
            assert logits.shape == (N, seg_cfg.model.num_classes)
            assert np.isfinite(logits).all(), \
                "resident-ml dry-run logits not finite"
        seg_state = _train_state(seg_cfg, seg_model, seg_sd, dev)
        labels = rng.integers(0, seg_cfg.model.num_classes, N).astype(
            np.int32)
        sbatch = shard_scene_batch(seg_cfg, sxyz, labels, smask, mesh, N)
        seg_state, sm = make_spatial_train_step(seg_cfg, mesh,
                                                tier="resident")(
            seg_state, sbatch, PRNGKey(1))
        assert _finite(sm["loss"]), "spatial train dry-run loss not finite"
        assert seg_state.step == 1
        out["spatial_loss"] = float(sm["loss"])

    # 5. featured s3dis_seg through tier 3: serving and one train step
    s3 = presets.get("s3dis_seg")
    if all(layer.n_centers % n == 0 for layer in s3.model.layers):
        rng = np.random.default_rng(1)
        s3_model, s3_sd = _init(s3, dev)
        Nf = 96 * n
        fxyz = rng.uniform(0, 2, size=(Nf, 3)).astype(np.float32)
        ffeat = rng.uniform(0, 1, size=(Nf, s3.model.in_channels)).astype(
            np.float32)
        fmask = np.ones(Nf, bool)
        logits = resident_ml_seg_predict(s3, s3_model, fxyz, fmask, mesh,
                                         capacity=Nf, feat=ffeat)
        assert logits.shape == (Nf, s3.model.num_classes)
        assert np.isfinite(logits).all(), \
            "featured resident-ml dry-run logits not finite"
        s3_state = _train_state(s3, s3_model, s3_sd, dev)
        caps = calibrate_ghost_cap(s3, fxyz, fmask, n)
        flabels = rng.integers(0, s3.model.num_classes, Nf).astype(np.int32)
        fbatch = shard_scene_batch(s3, fxyz, flabels, fmask, mesh, Nf,
                                   feat=ffeat)
        s3_state, fm = make_spatial_train_step(
            s3, mesh, tier="resident_ml", ghost_cap=caps)(
            s3_state, fbatch, PRNGKey(2))
        assert _finite(fm["loss"]), \
            "featured spatial train dry-run loss not finite"
        assert s3_state.step == 1
        say(f"FEATURED_SPATIAL_TRAIN {{\"config\": \"{s3.name}\", "
            f"\"tier\": 3, \"n_devices\": {n}, \"ghost_cap\": {list(caps)}, "
            f"\"ghost_overflow\": {int(fm['ghost_overflow'])}, "
            f"\"loss\": {float(fm['loss']):.4f}}}")

    # 6. the 2 × n/2 scene-batched tier 3: forward and train step
    if n >= 4 and n % 2 == 0:
        cfg2 = presets.get("synthetic_tiny_seg")
        Dsp = n // 2
        if all(layer.n_centers % Dsp == 0 for layer in cfg2.model.layers):
            model2, sd2 = _init(cfg2, dev)
            rng2 = np.random.default_rng(3)
            N2 = 64 * Dsp
            scenes2 = rng2.uniform(0, 8, size=(2, N2, 3)).astype(np.float32)
            mesh2d = make_mesh2d(2, Dsp, devices)
            lg2 = resident_ml_seg_predict_scenes(
                cfg2, model2, scenes2, np.ones((2, N2), bool), mesh2d,
                capacity=N2)
            assert lg2.shape == (2, N2, cfg2.model.num_classes)
            assert np.isfinite(lg2).all(), \
                "2-D mesh scene-batched dry-run logits not finite"
            say(f"SCENE_BATCHED_TIER3 {{\"mesh\": [2, {Dsp}], "
                f"\"scenes\": 2, \"points_per_scene\": {N2}, \"ok\": true}}")
            state2 = _train_state(cfg2, model2, sd2, dev)
            labels2 = rng2.integers(0, cfg2.model.num_classes,
                                    (2, N2)).astype(np.int32)
            batch2 = shard_scene_batches(cfg2, scenes2, labels2,
                                         np.ones((2, N2), bool), mesh2d, N2)
            state2, m2 = make_spatial_train_step(
                cfg2, mesh2d, tier="resident_ml", batch_axis=DATA_AXIS)(
                state2, batch2, PRNGKey(4))
            assert _finite(m2["loss"]), \
                "scene-batched spatial train dry-run loss not finite"
            assert state2.step == 1
            say(f"SCENE_BATCHED_TIER3_TRAIN {{\"mesh\": [2, {Dsp}], "
                f"\"scenes\": 2, \"points_per_scene\": {N2}, "
                f"\"loss\": {float(m2['loss']):.4f}, "
                f"\"ghost_overflow\": {int(m2['ghost_overflow'])}, "
                f"\"ok\": true}}")

    # 7. the communication audit: bytes, and with the caller's measured
    # anchors (the single-device forward's and train step's busy ms, the
    # ghost tax's eval and train fits, the decoder's kNN ms, tier 2's
    # measured replicated share) each setting's projection, the tax taken
    # at n ranks and the setting's caps
    for name in ("scannet_seg", "scannet_whole_scene"):
        flagship = presets.get(name)
        if any(layer.n_centers % n for layer in flagship.model.layers):
            continue
        a = (anchors or {}).get(name, {})
        kw = dict(compute_ms_per_step=(a["compute_ms"] / n if a else None),
                  train_ms_per_step=(a["train_ms"] / n
                                     if a.get("train_ms") else None),
                  tax_fit=a.get("tax_fit"), knn_ms=a.get("knn_ms"),
                  tier2_frac=a.get("tier2_frac"))
        cal_xyz = np.asarray(synthetic_scene_surface(
            flagship.data.num_points * flagship.data.batch_size, seed=7),
            np.float32)
        settings = (
            ("default", 0),
            ("calibrated", calibrate_ghost_cap(
                flagship, cal_xyz, np.ones(len(cal_xyz), bool), n)),
            ("quarter_share", tuple(max(8, layer.n_centers // n // 4)
                                    for layer in flagship.model.layers)))
        for label, caps in settings:
            rep = comm_report(flagship, n, ghost_cap=caps, **kw)
            say("COMM_REPORT " + json.dumps(
                {"ghost_cap_setting": f"{name}:{label}", **rep}))
    return out


def dryrun_multichip(n_devices: int, device="cuda",
                     anchors: Optional[dict] = None,
                     timeout_s: float = 900.0) -> dict:
    """The dry run over n_devices ranks of `device` (see the module
    docstring). `anchors`: {preset: {"compute_ms": its single-device
    forward's device-busy ms, "tax_fit": {"eval": (fixed, coeff),
    "train": (fixed, coeff)}, the ghost tax's fits from the mesh-1 study,
    "knn_ms": the decoder's kNN ms per stage, coarsest first, and
    optionally "train_ms": its single-device train step's busy ms and
    "tier2_frac": tier 2's replicated share R/C}} from measurements on the
    card, for part 7's projections at every ghost-cap setting; without
    anchors the reports carry bytes only. Returns rank 0's record:
    {"lines": the printed lines, "dp_loss", "spatial_loss"}."""
    devices = rank_devices(n_devices, device)
    return launch(_run, devices, n_devices, devices, anchors,
                  timeout_s=timeout_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, required=True,
                    help="ranks of the mesh")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
