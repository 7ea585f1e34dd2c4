"""The frozen generator against the port's `synthetic_scene_surface`
today, and the traffic's pools, requests and batches from the seed."""

import numpy as np
import pytest

from harness import scenes, traffic


@pytest.mark.parametrize("seed", [3, 2**31 + 12345])
@pytest.mark.parametrize("labels", [False, True])
def test_frozen_generator_is_the_ports(seed, labels):
    from gridgcn_torch.data.synthetic import synthetic_scene_surface

    a = scenes.synthetic_scene_surface(4096, seed=seed, return_labels=labels)
    b = synthetic_scene_surface(4096, seed=seed, return_labels=labels)
    for x, y in zip(a if labels else [a], b if labels else [b]):
        np.testing.assert_array_equal(x, y)


def _wl(**kw):
    return {"generator": "scene_surface", "pool": 4,
            "params": {"num_points": 256}, **kw}


def test_pool_from_the_seed():
    a, la = traffic.make_pool(_wl(labels=True), 2**33 + 1)
    b, lb = traffic.make_pool(_wl(labels=True), 2**33 + 1)
    c, _ = traffic.make_pool(_wl(labels=True), 5)
    assert a.shape == (4, 256, 3) and la.shape == (4, 256)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert not np.array_equal(a, c) and a.shape == c.shape
    assert not np.array_equal(a[0], a[1])        # every item its own seed
    assert traffic.make_pool(_wl(), 1)[1] is None


def test_requests_and_batches():
    xyz, labels = traffic.make_pool(_wl(labels=True), 9)
    reqs = traffic.requests(xyz, 2)
    assert len(reqs) == 2 and reqs[1].shape == (2, 256, 3)
    with pytest.raises(ValueError):
        traffic.requests(xyz, 3)
    b = traffic.Batches(xyz, labels, 2, 9)
    steps = [b.get(j) for j in range(4)]
    first = np.concatenate([s["xyz"] for s in steps[:2]])
    # an epoch visits every cloud once; the next epoch in another order
    assert sorted(map(bytes, first)) == sorted(map(bytes, xyz))
    np.testing.assert_array_equal(b.get(1)["xyz"], steps[1]["xyz"])
    assert steps[0]["mask"].all() and steps[0]["label"].shape == (2, 256)
