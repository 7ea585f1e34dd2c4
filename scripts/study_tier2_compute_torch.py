"""Measure tier 2's replicated share of the whole-scene forward on the card
(the port's counterpart of `scripts/study_tier2_compute.py`).

Tier 2 (`gridgcn_torch/parallel/resident.py`) shards the dense work —
encoder layer 0 on each rank's slab, the last decoder stage and the head
on the slab's points — and runs the coarse pyramid (encoder layers 1..,
decoder stages 0..n-2) on every rank. A rank's time is then

    dense / D + replicated + all-gather     (not total / D + all-gather),

so the communication audit's tier-2 projection needs the replicated
share. This study measures it through the stage-drivable model
(`models/segmentation.py`: `encode_layer`, `decode_stage`,
`head_logits`), with the keys the full forward draws:

  * C  — the full forward (BatchNorm folded, the preset's dtype, the
    81920-point `synthetic_scene_surface` scene of seed 7);
  * R  — the replicated pyramid alone: encoder layers 1..n-1 from the
    level-1 input, then decoder stages 0..n-2 back to level 1;
  * E0 — encoder layer 0 alone (cross-check: C = E0 + R + the last stage
    and head).

Each is read as device-busy ms per call from a `utils.profiling.trace`
through `utils.traceview` (host launch overhead inflates the small R
far more than C in wall time), with a CUDA-events wall time beside it.
It prints one `TIER2_COMPUTE {json}` line: the JAX script's keys, with
`model_replicated_frac` from the port's byte model
(`parallel.comm_audit.tier2_replicated_fraction`) priced with the
decoder's kNN times read from the same trace, and the `knn3_mxu`
launches per full forward under the trace.

    python scripts/study_tier2_compute_torch.py [--iters 10]
        [--preset scannet_whole_scene] [--device cuda|cpu]
        [--trace-dir build/study_tier2_compute]

On the CPU (`--device cpu`) the busy values, the shares read from them
and the byte model are null: only the host-clock wall times are printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gridgcn_torch.utils.jaxrng import flax_make_rng  # noqa: E402


def layer_key(key, i: int):
    """Encoder layer i's CAGQ key, as the full forward draws it."""
    return flax_make_rng(key, (f"gridconv{i}",), 1)


def decoder_keys(model, key) -> list:
    """Each decoder stage's grid key, as the full forward draws it (None
    for a stage that does not query the grid)."""
    layers, keys, n_grid = model.cfg.layers, [], 0
    for i in range(len(model.cfg.up_layers)):
        k = None
        if model.uses_grid(i, layers[-1 - i].n_centers):
            n_grid += 1
            k = flax_make_rng(key, (), n_grid)
        keys.append(k)
    return keys


def level0(model, xyz, feat, mask):
    """The encoder's input level: (xyz, features, mask)."""
    if model.cfg.use_xyz_feature:
        feat = xyz if feat is None else torch.cat([xyz, feat], -1)
    return xyz, feat, mask


def encode0(model, lvl0, key):
    """E0: encoder layer 0 → level 1 (xyz, features, mask)."""
    return model.encode_layer(0, *lvl0, layer_key(key, 0))


def replicated(model, lvl1, key):
    """R: encoder layers 1..n-1 from level 1, then decoder stages 0..n-2
    back to level 1 → level 1's decoded features."""
    n = len(model.cfg.layers)
    levels = [lvl1]
    for i in range(1, n):
        levels.append(model.encode_layer(i, *levels[-1], layer_key(key, i)))
    keys = decoder_keys(model, key)
    c_xyz, c_feat, c_mask = levels[-1]
    for i in range(n - 1):
        d_xyz, d_feat, d_mask = levels[-2 - i]
        c_feat = model.decode_stage(i, c_xyz, c_feat, c_mask, d_xyz, d_feat,
                                    d_mask, keys[i])
        c_xyz, c_mask = d_xyz, d_mask
    return c_feat


def final(model, lvl0, lvl1, feat1, key):
    """The last decoder stage (level 1 → the points) and the head."""
    n = len(model.cfg.layers)
    x = model.decode_stage(n - 1, lvl1[0], feat1, lvl1[2], *lvl0,
                           decoder_keys(model, key)[n - 1])
    return model.head_logits(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10,
                    help="calls per timing and per trace")
    ap.add_argument("--preset", default="scannet_whole_scene")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default="build/study_tier2_compute")
    args = ap.parse_args(argv)

    from gridgcn_torch.configs import presets
    from gridgcn_torch.data.synthetic import synthetic_scene_surface
    from gridgcn_torch.kernels import knn
    from gridgcn_torch.models.build import build_model, init_model
    from gridgcn_torch.models.fold import fold_inference
    from gridgcn_torch.parallel.comm_audit import tier2_replicated_fraction
    from gridgcn_torch.utils import jaxrng, profiling, traceview
    from gridgcn_torch.utils.precision import full_fp32

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    cfg = presets.get(args.preset)
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    cfg, folded = fold_inference(cfg, sd)
    model = build_model(cfg.model)
    model.load_state_dict(folded)
    model = model.to(dev).eval()
    N = cfg.data.num_points
    xyz = torch.as_tensor(synthetic_scene_surface(N, seed=7), device=dev)[None]
    mask = torch.ones((1, N), dtype=torch.bool, device=dev)
    C_in = cfg.model.in_channels
    feat = (jaxrng.uniform(jaxrng.PRNGKey(3), (1, N, C_in), dev)
            if C_in else None)
    key = jaxrng.PRNGKey(0)

    def timed(name, fn):
        """(wall ms, busy ms or None) per call, and the trace's directory
        and knn3_mxu launches per call under the trace."""
        wall = profiling.steady_state_time(fn, warmup=2, iters=args.iters,
                                           device=dev) * 1e3
        logdir = os.path.join(args.trace_dir, name)
        n0 = knn.knn3_mxu.launches
        with profiling.trace(logdir):
            for _ in range(args.iters):
                fn()
        launches = (knn.knn3_mxu.launches - n0) / args.iters
        busy = (profiling.busy_ms_per_iter(logdir, args.iters)
                if dev.type == "cuda" else None)
        return wall, busy, logdir, launches

    with torch.no_grad(), full_fp32():
        lvl0 = level0(model, xyz, feat, mask)
        lvl1 = encode0(model, lvl0, key)
        Cw, Cb, c_dir, launches = timed(
            "full", lambda: model(xyz, feat, mask, key))
        Rw, Rb, _, _ = timed("replicated",
                             lambda: replicated(model, lvl1, key))
        E0w, E0b, _, _ = timed("enc0", lambda: encode0(model, lvl0, key))

    # the byte model, its kNN terms the full forward's knn3_mxu calls in
    # the trace (pack + kernel, in launch order: decoder stage 0 first)
    model_frac = knn_ms = None
    if Cb is not None and launches == len(cfg.model.up_layers):
        events = [e for evs in traceview.load_events(c_dir).values()
                  for e in evs if "mxu_pack_kernel" in e[2]
                  or "knn3_mxu_kernel" in e[2]]
        events.sort()
        if len(events) != 2 * args.iters * launches:
            raise RuntimeError(f"{len(events)} knn3_mxu pack and kernel "
                               f"events in the trace for {args.iters} x "
                               f"{launches} calls")
        per_call = np.asarray([e[1] - e[0] for e in events], np.float64)
        per_call = per_call.reshape(args.iters, int(launches), 2).sum(-1)
        knn_ms = (per_call.mean(0) / 1e9).tolist()
        model_frac = tier2_replicated_fraction(cfg, knn_ms)

    def r(x, n=4):
        return None if x is None else round(x, n)

    out = {
        "preset": args.preset,
        "backend": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "iters": args.iters,
        "full_busy_ms": r(Cb),
        "replicated_busy_ms": r(Rb),
        "enc0_busy_ms": r(E0b),
        "measured_replicated_frac": r(Rb / Cb, 6) if Cb else None,
        "model_replicated_frac": r(model_frac, 6),
        "model_knn_ms": None if knn_ms is None else [r(t, 6) for t in knn_ms],
        "crosscheck_final_stage_head_busy_ms":
            r(Cb - Rb - E0b) if Cb else None,
        "knn3_mxu_launches_per_full": launches,
        "wall_ms": {"full": r(Cw), "replicated": r(Rw), "enc0": r(E0w),
                    "replicated_frac_wall": r(Rw / Cw, 6)},
    }
    print("TIER2_COMPUTE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
