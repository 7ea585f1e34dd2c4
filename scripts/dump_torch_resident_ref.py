"""Dump a full-size reference of the resident spatial tiers from the JAX
package, for the PyTorch port to be held against on the card.

    python scripts/dump_torch_resident_ref.py \
        [--out gridgcn_torch/testdata/resident_ref.npz]

`scannet_whole_scene` served (BatchNorm folded, bf16) on the 81920-point
`synthetic_scene_surface` scene of seed 7, with the weights
`models.build.numpy_state_dict(cfg.model, seed=0)` of the port (numpy
seeded: the card's machine makes the same ones without JAX), through tier
2 (`resident_seg_predict`) and tier 3 (`resident_ml_seg_predict`) on a
2-device CPU mesh, key `PRNGKey(0)`, the default capacity and ghost caps.
The decoder runs the exact dense 3-NN (`UpLayerSpec.method="dense"`),
never Pallas interpret mode at this size. The file holds, compressed:

- `digest/<name>`: the SHA-256 of each weight tensor;
- the partition: `edges` [3], `halo`, `capacity`, `partition_sha256` (of
  the shard xyz, mask, owned and scatter-index arrays) and `owned_count`
  [2];
- per tier t (2, 3), shard d and encoder layer i: `t{t}_d{d}_vids{i}`
  [M] int32 and `t{t}_d{d}_valid{i}` [M] bool (the CAGQ centers), and for
  i ≥ 1 the layer's input level `t{t}_d{d}_in{i}_xyz` [R, 3] float32 and
  `t{t}_d{d}_in{i}_mask` [R] bool (layer 0's input is the shard's slab);
- `t3_overflow` [2]: the boundary rows each shard could not send;
- `subset` [4096] int32 (a fixed sorted point subset, numpy seed 0) and
  `t{t}_logits` [4096, 21] float16, the stitched logits there.

The per-shard values are recorded from inside the jitted `shard_map`
with `jax.debug.callback`. It runs on the CPU in a few minutes.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
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
SHARDS = 2


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


def partition_digest(parts) -> str:
    """SHA-256 over a partition's shard xyz, mask, owned and scatter-index
    arrays."""
    h = hashlib.sha256()
    for a in parts:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "gridgcn_torch", "testdata", "resident_ref.npz"))
    args = ap.parse_args(argv)

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count="
                               f"{SHARDS}")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from gridgcn_tpu.configs import presets as jpresets
    from gridgcn_tpu.data.synthetic import synthetic_scene_surface
    from gridgcn_tpu.models import gridconv as jgridconv
    from gridgcn_tpu.models.fold import fold_inference as jfold
    from gridgcn_tpu.ops.voxelize import grid_bounds
    from gridgcn_tpu.parallel import resident_ml as jml
    from gridgcn_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from gridgcn_tpu.parallel.resident import (
        resident_halo, resident_seg_predict)
    from gridgcn_tpu.parallel.spatial import partition_scene, \
        suggest_capacity
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
    xyz = synthetic_scene_surface(N_POINTS, seed=SCENE_SEED)
    mask = np.ones(N_POINTS, bool)
    mesh = make_mesh(SHARDS)

    _, vsize = grid_bounds(jnp.asarray(xyz)[None], jnp.asarray(mask)[None],
                           cfg.model.layers[0].resolution)
    halo = resident_halo(cfg, np.asarray(vsize)[0])
    cap = suggest_capacity(xyz, mask, SHARDS, halo)
    sx, sm, owned, sidx, edges = partition_scene(xyz, mask, SHARDS, halo,
                                                 cap)
    out.update(edges=edges, halo=np.float64(halo), capacity=np.int64(cap),
               partition_sha256=np.array(partition_digest(
                   (sx, sm, owned, sidx))),
               owned_count=owned.sum(1).astype(np.int64))

    rec = {d: [] for d in range(SHARDS)}
    dropped = {d: 0 for d in range(SHARDS)}
    cagq, exch = jgridconv.cagq, jml.exchange_boundary

    def cagq_rec(x, m, spec, *a, **k):
        o = cagq(x, m, spec, *a, **k)
        jax.debug.callback(
            lambda d, x_, m_, v, ok: rec[int(d)].append(
                tuple(np.asarray(t)[0] for t in (x_, m_, v, ok))),
            jax.lax.axis_index(DATA_AXIS), x, m, o.groups.center_vids,
            o.groups.center_valid)
        return o

    def exch_rec(*a, **k):
        o = exch(*a, **k)

        def add(d, n):
            dropped[int(d)] += int(n)
        jax.debug.callback(add, jax.lax.axis_index(a[-1]), o[4])
        return o

    sub = subset_indices()
    out["subset"] = sub
    jgridconv.cagq, jml.exchange_boundary = cagq_rec, exch_rec
    try:
        for tier, predict in ((2, resident_seg_predict),
                              (3, jml.resident_ml_seg_predict)):
            for d in rec:
                rec[d].clear()
            logits = predict(fcfg, fvars, xyz, mask, mesh,
                             rng=jax.random.PRNGKey(0))
            jax.effects_barrier()
            out[f"t{tier}_logits"] = np.asarray(logits)[sub].astype(
                np.float16)
            for d, calls in rec.items():
                assert len(calls) == len(cfg.model.layers), len(calls)
                for i, (x_, m_, v, ok) in enumerate(calls):
                    out[f"t{tier}_d{d}_vids{i}"] = v.astype(np.int32)
                    out[f"t{tier}_d{d}_valid{i}"] = ok
                    if i:
                        out[f"t{tier}_d{d}_in{i}_xyz"] = x_.astype(
                            np.float32)
                        out[f"t{tier}_d{d}_in{i}_mask"] = m_
            print(f"tier {tier}: logits range "
                  f"{float(np.ptp(np.asarray(logits))):.4f}, "
                  f"{time.time() - t0:.1f} s")
    finally:
        jgridconv.cagq, jml.exchange_boundary = cagq, exch
    out["t3_overflow"] = np.array([dropped[d] for d in range(SHARDS)],
                                  np.int64)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes, "
          f"{time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
