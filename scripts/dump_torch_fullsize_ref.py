"""Dump a full-size reference of the served whole-scene forward from the
JAX package, for the PyTorch port to be held against on the card.

    JAX_PLATFORMS=cpu python scripts/dump_torch_fullsize_ref.py \
        [--out gridgcn_torch/testdata/fullsize_ref.npz]

One `scannet_whole_scene` forward at full width and size: the
81920-point `synthetic_scene_surface` scene of seed 7 (`bench.py`'s first
scene), weights `models.build.numpy_state_dict(cfg.model, seed=0)` from the
port (numpy-seeded, so the card's machine makes the same ones without
JAX) converted with `utils.convert.state_dict_to_flax`, BatchNorm folded
and bf16 as served, CAGQ key `PRNGKey(0)`. The decoder runs the exact
dense 3-NN (`UpLayerSpec.method="dense"`, `approx_knn=False`), the XLA
path that gives `flash_knn`'s indices; Pallas interpret mode is not run
at this size. The file holds, compressed:

- `digest/<name>`: the SHA-256 of each converted weight tensor;
- per encoder layer i: `enc{i}_center_vids` [M] int32,
  `enc{i}_center_valid` [M] bool, `enc{i}_neighbor_idx` [M, K] int32,
  `enc{i}_neighbor_mask` [M, K] bool (compared bit for bit), and
  `enc{i}_center_xyz` [M, 3] float32, the next level's points (so each
  layer can be held on the reference's own input: XLA's float32 prefix
  sums at this size order otherwise than torch's, and a barycenter a few
  ulps off can cross a voxel face at the next layer);
- per decoder stage i: `dec{i}_idx` [Nq, 3] int32, the exact 3-NN;
- `subset` [4096] int32 (a fixed sorted point subset, numpy seed 0) and
  `logits` [4096, 21] float16, the served logits there.

It runs on the CPU in a few minutes and a few GiB.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED_WEIGHTS = 0
SCENE_SEED = 7
N_POINTS = 81920
SUBSET = 4096


def reference_config(presets):
    """scannet_whole_scene with the exact dense decoder."""
    cfg = presets.get("scannet_whole_scene")
    ups = tuple(dataclasses.replace(u, method="dense", approx_knn=False)
                for u in cfg.model.up_layers)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, up_layers=ups))


def subset_indices() -> np.ndarray:
    return np.sort(np.random.default_rng(0).choice(
        N_POINTS, SUBSET, replace=False)).astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "gridgcn_torch", "testdata", "fullsize_ref.npz"))
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from gridgcn_tpu.configs import presets as jpresets
    from gridgcn_tpu.data.synthetic import synthetic_scene_surface
    from gridgcn_tpu.models import gridconv as jgridconv
    from gridgcn_tpu.models import segmentation as jseg
    from gridgcn_tpu.models.build import build_model as jbuild
    from gridgcn_tpu.models.fold import fold_inference as jfold
    from gridgcn_torch.configs import presets as tpresets
    from gridgcn_torch.models.build import (
        numpy_state_dict, state_dict_digests)
    from gridgcn_torch.utils.convert import state_dict_to_flax

    t0 = time.time()
    sd = numpy_state_dict(tpresets.get("scannet_whole_scene").model,
                          SEED_WEIGHTS)
    out = {f"digest/{k}": np.array(v)
           for k, v in state_dict_digests(sd).items()}
    cfg = reference_config(jpresets)
    fcfg, fvars = jfold(cfg, state_dict_to_flax(sd))
    model = jbuild(fcfg.model)
    xyz = synthetic_scene_surface(N_POINTS, seed=SCENE_SEED)

    # the recorded indices leave the jitted forward as extra outputs: the
    # jitted program's fusions set the reference's roundings (barycenters),
    # which an op-by-op run would not repeat
    enc, dec = [], []
    cagq, dense = jgridconv.cagq, jseg.dense_three_nn

    def cagq_rec(*a, **k):
        o = cagq(*a, **k)
        g = o.groups
        enc.append((g.center_vids, g.center_valid, g.neighbor_idx,
                    g.neighbor_mask, g.center_xyz))
        return o

    def dense_rec(*a, **k):
        o = dense(*a, **k)
        dec.append(o[0])
        return o

    def fwd(x, m, key):
        enc.clear()
        dec.clear()
        lg = model.apply(fvars, x, None, m, train=False,
                         rngs={"cagq": key})
        return lg, list(enc), list(dec)

    jgridconv.cagq, jseg.dense_three_nn = cagq_rec, dense_rec
    try:
        logits, enc_out, dec_out = jax.jit(fwd)(
            jnp.asarray(xyz[None]), jnp.ones((1, N_POINTS), bool),
            jax.random.PRNGKey(0))
    finally:
        jgridconv.cagq, jseg.dense_three_nn = cagq, dense
    logits = np.asarray(logits)[0]
    assert len(enc_out) == len(cfg.model.layers) == len(dec_out)
    for i, g in enumerate(enc_out):
        vids, valid, nidx, nmask, cxyz = (np.asarray(a)[0] for a in g)
        out[f"enc{i}_center_vids"] = vids.astype(np.int32)
        out[f"enc{i}_center_valid"] = valid
        out[f"enc{i}_neighbor_idx"] = nidx.astype(np.int32)
        out[f"enc{i}_neighbor_mask"] = nmask
        out[f"enc{i}_center_xyz"] = cxyz.astype(np.float32)
    for i, idx in enumerate(dec_out):
        out[f"dec{i}_idx"] = np.asarray(idx)[0].astype(np.int32)
    sub = subset_indices()
    out["subset"] = sub
    out["logits"] = logits[sub].astype(np.float16)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes, "
          f"logits range {float(np.ptp(logits)):.4f}, "
          f"{time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
