"""The port's CPU CAGQ against the full-size JAX reference
(`gridgcn_torch/testdata/fullsize_ref.npz`, written by
`scripts/dump_torch_fullsize_ref.py`): every encoder layer of
`scannet_whole_scene` on the 81920-point scene, bit for bit, each on the
reference's own input level. CAGQ is geometric, so the four levels need no
network. Chained on its own levels instead, the port's layer 1 differs:
XLA:CPU's float32 prefix sums over 81920 points run in another order than
torch's, the barycenters (the next level's points) differ by a few ulps,
and one of them crosses a voxel face (1867 against 1868 occupied layer-1
voxels). The same file holds the card (`chip_smoke.py`); its logits are
checked there only."""

import os

import numpy as np
import pytest
import torch

from gridgcn_torch.configs import presets
from gridgcn_torch.data.synthetic import synthetic_scene_surface
from gridgcn_torch.models.build import numpy_state_dict, state_dict_digests
from gridgcn_torch.ops.cagq import cagq
from gridgcn_torch.utils import jaxrng

torch.set_num_threads(1)

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gridgcn_torch", "testdata", "fullsize_ref.npz")


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(REF))


def test_numpy_weights_have_the_files_digests(ref):
    """The weights the reference was made with, regenerated from numpy's
    seed (as the card's machine regenerates them)."""
    sd = numpy_state_dict(presets.get("scannet_whole_scene").model, 0)
    got = state_dict_digests(sd)
    want = {k[len("digest/"):]: str(v) for k, v in ref.items()
            if k.startswith("digest/")}
    assert got == want


def _scene():
    xyz = torch.from_numpy(synthetic_scene_surface(81920, seed=7))[None]
    return xyz, torch.ones((1, 81920), dtype=torch.bool)


def _layer(ref, i, xyz, mask):
    spec = presets.get("scannet_whole_scene").model.layers[i]
    return cagq(xyz, mask, spec, jaxrng.flax_make_rng(
        jaxrng.PRNGKey(0), (f"gridconv{i}",), 1)).groups


@pytest.mark.parametrize("i", range(4))
def test_cagq_layer_matches_the_reference_bit_for_bit(ref, i):
    """Layer i's CAGQ on the reference's own level-i points: centers,
    their validity, node indices and node masks bit for bit; the centers'
    positions (the next level) within 4e-6 of the scene's extent
    (measured: 2.5e-6 at layer 0, float32 prefix sums in another order)."""
    if i == 0:
        xyz, mask = _scene()
    else:
        xyz = torch.from_numpy(ref[f"enc{i - 1}_center_xyz"])[None]
        mask = torch.from_numpy(ref[f"enc{i - 1}_center_valid"])[None]
    g = _layer(ref, i, xyz, mask)
    for name in ("center_vids", "center_valid", "neighbor_idx",
                 "neighbor_mask"):
        want = ref[f"enc{i}_{name}"]
        got = getattr(g, name)[0].numpy()
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=f"layer {i} {name}")
    assert ref[f"enc{i}_center_valid"].mean() > 0.5
    valid = ref[f"enc{i}_center_valid"]
    np.testing.assert_allclose(g.center_xyz[0].numpy()[valid],
                               ref[f"enc{i}_center_xyz"][valid], rtol=0,
                               atol=4e-6 * float(np.ptp(
                                   _scene()[0][0].numpy())))
