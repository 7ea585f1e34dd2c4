"""The served forward replayed from CUDA graphs (`api.Predictor`, the
default on one card) against the eager forward (`graphs=False`) on the
card, for the benchmark's three configurations at their cells' shapes:
the logits bit for bit under two keys, one capture a signature, the
replays counted, the kernels' host counters an eager forward's over the
capture and still over a replay, no two answers sharing memory, and
`predict_scene`'s votes.

Needs an NVIDIA GPU with nvcc: every test here is marked `cuda` and skips
without one. Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _clouds(name: str, B: int, N: int) -> np.ndarray:
    from gridgcn_torch.data.synthetic import (
        synthetic_scene_surface, synthetic_shapes40)

    if name == "modelnet40_cas":
        return synthetic_shapes40(B, N, seed=3)[0]
    return np.stack([synthetic_scene_surface(N, seed=11 + b)
                     for b in range(B)])


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _pair(name):
    from gridgcn_torch.api import Predictor
    from gridgcn_torch.configs import presets
    from gridgcn_torch.models.build import init_model

    cfg = presets.get(name)
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    return (Predictor(cfg, sd, device="cuda", graphs=False),
            Predictor(cfg, sd, device="cuda"))


@pytest.mark.parametrize("name,B,N", [("scannet_whole_scene", 4, 81920),
                                      ("scannet_seg", 8, 8192),
                                      ("modelnet40_cas", 16, 1024)])
def test_replay_is_the_eager_forward_bit_for_bit(cuda, name, B, N):
    from gridgcn_torch.kernels import knn
    from gridgcn_torch.utils import jaxrng

    eager, graphed = _pair(name)
    xyz = _clouds(name, B, N)
    other = np.ascontiguousarray(xyz[::-1])
    k2 = jaxrng.fold_in(jaxrng.PRNGKey(9), 3)
    def counters():
        return knn.knn3_mxu.launches, dict(jaxrng.launches)

    def launched(before):
        n, d = counters()
        return n - before[0], {k: v - before[1][k] for k, v in d.items()}

    c0 = counters()
    want = eager(xyz)
    per_forward = launched(c0)
    want2 = eager(xyz, rng=k2)
    want_other = eager(other)
    assert not np.array_equal(want, want2)

    # eager (the numpy key), then the capture, which launches what an
    # eager forward launches, then a replay
    got = [graphed(xyz)]
    c0 = counters()
    got.append(graphed(xyz))
    assert launched(c0) == per_forward
    got.append(graphed(xyz))
    assert (graphed.captures, graphed.replays) == (1, 1)
    for g in got:
        assert g.shape == want.shape and g.dtype == np.float32
        np.testing.assert_array_equal(_bits(g), _bits(want))
    # a new key gives that key's draws; new points that points' logits
    n0, d0 = knn.knn3_mxu.launches, dict(jaxrng.launches)
    got2 = graphed(xyz, rng=k2)
    got_other = graphed(other)
    np.testing.assert_array_equal(_bits(got2), _bits(want2))
    np.testing.assert_array_equal(_bits(got_other), _bits(want_other))
    # the host counters count no replay
    assert knn.knn3_mxu.launches == n0 and dict(jaxrng.launches) == d0
    assert (graphed.captures, graphed.replays) == (1, 3)
    # every answer an array of its own
    assert not np.shares_memory(got[1], got[2])
    assert not np.shares_memory(got2, got_other)
    got[2][...] = 0
    np.testing.assert_array_equal(_bits(got[1]), _bits(want))


def test_signatures_capture_once_each(cuda):
    """A second request shape is a signature of its own: eager, then one
    capture; the first shape keeps replaying."""
    eager, graphed = _pair("scannet_seg")
    xyz = _clouds("scannet_seg", 8, 8192)
    small = np.ascontiguousarray(xyz[:2])
    for x in (xyz, xyz, small, small, xyz, small, small[0]):
        np.testing.assert_array_equal(_bits(graphed(x)), _bits(eager(x)))
    assert (graphed.requests, graphed.captures, graphed.replays) == (7, 2, 2)


def test_predict_scene_votes_replay(cuda):
    """predict_scene(votes=2) replays one graph under fold_in(rng, v), bit
    for bit the eager votes."""
    from gridgcn_torch.utils import jaxrng

    eager, graphed = _pair("scannet_whole_scene")
    xyz = _clouds("scannet_whole_scene", 1, 81920)[0]
    rng = jaxrng.PRNGKey(2)
    want = eager.predict_scene(xyz, votes=2, rng=rng)
    for _ in range(2):
        got = graphed.predict_scene(xyz, votes=2, rng=rng)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (graphed.captures, graphed.replays) == (1, 2)
