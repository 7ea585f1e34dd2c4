"""The port's resident-tier partition and per-shard layer-0 CAGQ on the CPU
against the full-size JAX reference of the tiers
(`gridgcn_torch/testdata/resident_ref.npz`, written by
`scripts/dump_torch_resident_ref.py`): `scannet_whole_scene` on the
81920-point scene cut into 2 slabs. The partition is host numpy, compared
by its digest; each shard's layer-0 CAGQ (tier 2 and tier 3, each with its
own key and grid) runs on the shard's slab and is compared bit for bit.
The deeper layers and the logits are held on the card (`chip_smoke.py`),
each layer on the reference's own input level."""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

from gridgcn_torch.configs import presets
from gridgcn_torch.data.synthetic import synthetic_scene_surface
from gridgcn_torch.models.build import numpy_state_dict, state_dict_digests
from gridgcn_torch.ops.cagq import cagq
from gridgcn_torch.parallel.resident import (
    resident_halo, scene_bounds, stage_key)
from gridgcn_torch.parallel.spatial import partition_scene, suggest_capacity
from gridgcn_torch.utils import jaxrng

torch.set_num_threads(1)

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gridgcn_torch", "testdata", "resident_ref.npz")
N, D = 81920, 2


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(REF))


@pytest.fixture(scope="module")
def scene():
    cfg = presets.get("scannet_whole_scene")
    xyz = synthetic_scene_surface(N, seed=7)
    mask = np.ones(N, bool)
    origin, vsize = scene_bounds(xyz, mask, cfg.model.layers[0].resolution)
    halo = resident_halo(cfg, vsize)
    cap = suggest_capacity(xyz, mask, D, halo)
    return cfg, origin, vsize, halo, cap, partition_scene(xyz, mask, D, halo,
                                                          cap)


def test_numpy_weights_have_the_files_digests(ref):
    sd = numpy_state_dict(presets.get("scannet_whole_scene").model, 0)
    want = {k[len("digest/"):]: str(v) for k, v in ref.items()
            if k.startswith("digest/")}
    assert state_dict_digests(sd) == want


def test_partition_matches_the_reference(ref, scene):
    _, _, _, halo, cap, parts = scene
    assert halo == float(ref["halo"]) and cap == int(ref["capacity"])
    np.testing.assert_array_equal(parts[4], ref["edges"])
    h = hashlib.sha256()
    for a in parts[:4]:
        h.update(np.ascontiguousarray(a).tobytes())
    assert h.hexdigest() == str(ref["partition_sha256"])
    np.testing.assert_array_equal(parts[2].sum(1), ref["owned_count"])


@pytest.mark.parametrize("tier", [2, 3])
def test_layer0_cagq_of_each_shard_matches_the_reference(ref, scene, tier):
    """Tier 2 draws layer 0 from fold_in(key, d) on the scene's grid, tier
    3 from fold_in(fold_in(key, 0), d) on the grid of the scene's extent;
    both sample 8192 / 2 centers a shard."""
    cfg, origin, vsize, _, _, (sx, sm, _, _, _) = scene
    spec = cfg.model.layers[0]
    spec = dataclasses.replace(spec, n_centers=spec.n_centers // D)
    key = jaxrng.PRNGKey(0)
    o = torch.from_numpy(origin)[None]
    if tier == 3:
        extent = vsize * spec.resolution / (1.0 + 1e-5)
        v = torch.from_numpy(extent) * (1.0 + 1e-5) / spec.resolution
    else:
        v = torch.from_numpy(vsize)
    for d in range(D):
        k = jaxrng.fold_in(key, d) if tier == 2 else \
            jaxrng.fold_in(jaxrng.fold_in(key, 0), d)
        g = cagq(torch.from_numpy(sx[d:d + 1]), torch.from_numpy(sm[d:d + 1]),
                 spec, stage_key(k, 0), bounds=(o, v[None])).groups
        np.testing.assert_array_equal(g.center_valid[0].numpy(),
                                      ref[f"t{tier}_d{d}_valid0"])
        np.testing.assert_array_equal(g.center_vids[0].numpy(),
                                      ref[f"t{tier}_d{d}_vids0"])
        assert ref[f"t{tier}_d{d}_valid0"].mean() > 0.5
    assert ref["t3_overflow"].sum() == 0
