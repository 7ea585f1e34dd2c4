"""The frozen generator against the port's `synthetic_scene_surface`
today, the generators found by name as files, and the traffic's pools,
requests and batches from the seed, features cut with their clouds."""

import numpy as np
import pytest

import tiny
from harness import scenes, spec, traffic


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


def test_generator_file_is_the_frozen_generator():
    gen = spec.load_generator(spec.BENCH_DIR, "scene_surface")
    xyz, feat, labels = gen(7, True, {"num_points": 512,
                                      "room": [4.0, 2.5, 3.0]})
    want = scenes.synthetic_scene_surface(512, seed=7, room=(4.0, 2.5, 3.0),
                                          return_labels=True)
    np.testing.assert_array_equal(xyz, want[0])
    np.testing.assert_array_equal(labels, want[1])
    assert feat is None and gen(7, False, {"num_points": 512})[2] is None


def test_pool_from_the_seed():
    a, fa, la = traffic.make_pool(_wl(labels=True), 2**33 + 1)
    b, _, lb = traffic.make_pool(_wl(labels=True), 2**33 + 1)
    c, _, _ = traffic.make_pool(_wl(labels=True), 5)
    assert a.shape == (4, 256, 3) and la.shape == (4, 256) and fa is None
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert not np.array_equal(a, c) and a.shape == c.shape
    assert not np.array_equal(a[0], a[1])        # every item its own seed
    assert traffic.make_pool(_wl(), 1).labels is None


def _featured(seed, **kw):
    """A pool from a generator file of another folder (the tests' added
    files), with three feature channels."""
    return traffic.make_pool(
        {"generator": "shapes", "pool": 4, "params": {"num_points": 256,
                                                      "channels": 3}, **kw},
        seed, tiny.ADDED)


def test_generator_found_by_name_with_features():
    pool = _featured(2**31 + 7, labels=True)
    assert pool.xyz.shape == (4, 256, 3) and pool.xyz.dtype == np.float32
    assert pool.feat.shape == (4, 256, 3) and pool.feat.dtype == np.float32
    assert pool.labels.shape == (4, 256) and pool.labels.dtype == np.int32
    again = _featured(2**31 + 7, labels=True)
    for x, y in zip(pool, again):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(FileNotFoundError):
        traffic.make_pool(_wl(generator="no_such_generator"), 1)


def test_requests_and_batches():
    pool = traffic.make_pool(_wl(labels=True), 9)
    reqs = traffic.requests(pool, 2)
    assert len(reqs) == 2 and reqs[1].xyz.shape == (2, 256, 3)
    assert reqs[1].feat is None
    with pytest.raises(ValueError):
        traffic.requests(pool, 3)
    b = traffic.Batches(pool, 2, 9)
    steps = [b.get(j) for j in range(4)]
    first = np.concatenate([s["xyz"] for s in steps[:2]])
    # an epoch visits every cloud once; the next epoch in another order
    assert sorted(map(bytes, first)) == sorted(map(bytes, pool.xyz))
    np.testing.assert_array_equal(b.get(1)["xyz"], steps[1]["xyz"])
    assert steps[0]["mask"].all() and steps[0]["label"].shape == (2, 256)
    assert "feat" not in steps[0]


def test_features_ride_with_their_clouds():
    pool = _featured(3, labels=True)
    for r, req in enumerate(traffic.requests(pool, 2)):
        np.testing.assert_array_equal(req.xyz, pool.xyz[2 * r:2 * r + 2])
        np.testing.assert_array_equal(req.feat, pool.feat[2 * r:2 * r + 2])
    b = traffic.Batches(pool, 2, 3)
    for j in range(4):
        step = b.get(j)
        for x, f in zip(step["xyz"], step["feat"]):
            i = next(i for i in range(4) if np.array_equal(pool.xyz[i], x))
            np.testing.assert_array_equal(pool.feat[i], f)
