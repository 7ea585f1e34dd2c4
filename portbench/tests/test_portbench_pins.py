"""The three cells read what they read before a configuration could name
its own generator and reference network: at two fixed seeds, the sha256 of
each existing workload's pool, of each configuration's seeded state_dict,
and of the reference's logits for the first request of `scannet_seg.serve`
(on the CPU, one thread: the reduction order of a float32 sum follows the
thread count), and the work counts of both configurations.

The values were recorded from PR 16's tree (the harness before the
generators, the features and the named reference network) with the same
digest."""

import hashlib

import numpy as np
import pytest
import torch

from harness import spec, traffic, weights
from harness.drivers import PREDICTOR_KEY
from reference.config import from_dict
from reference.serve import ServeReference
from work.dense_flops import forward_flops
from work.knn3_bytes import knn3_bytes
from work.knn3_pairs import knn3_pairs

SEEDS = (5, 2147483659)
POOLS = {
    "scannet_whole_scene.b1@5":
        "3fd58637e0d3967043fa82419178763dd85dfa2065cb85830f04f5322265f879",
    "scannet_whole_scene.b1@2147483659":
        "74efd2b0880bb433f07545a0ed6c098872422d7c2c3ad56dc55b88156b07f6a2",
    "scannet_whole_scene.b4@5":
        "3fd58637e0d3967043fa82419178763dd85dfa2065cb85830f04f5322265f879",
    "scannet_whole_scene.b4@2147483659":
        "74efd2b0880bb433f07545a0ed6c098872422d7c2c3ad56dc55b88156b07f6a2",
    "scannet_seg.serve@5":
        "4d697bf4df01c39885a215722da4ae1d5151a540fdc7ea9738a961ff6c690bba",
    "scannet_seg.serve@2147483659":
        "93da7a17d668e0ef9efe3984e36967d00bb8bdef9a10adac787df06126412bfb",
    "scannet_seg.train@5":
        "d9a8517cf72d19164e399974d09b95e585268cedc83c2aa47df7a8a0dda8877a",
    "scannet_seg.train@2147483659":
        "a1e9e12173df1a8fbbdfa007ee45cafd0560af88c845ccdb31210f9734483e79",
}
STATE_DICTS = {
    "scannet_whole_scene@5":
        "d9764596dd9f1ee45c0e34fa027b565fb69f2971dda365e10016bc6988ab8755",
    "scannet_whole_scene@2147483659":
        "ed339e807641da27c3d4918446c57cdc8b0a8ff359bff71e115cc3c74e01ef3b",
    "scannet_seg@5":
        "d9764596dd9f1ee45c0e34fa027b565fb69f2971dda365e10016bc6988ab8755",
    "scannet_seg@2147483659":
        "ed339e807641da27c3d4918446c57cdc8b0a8ff359bff71e115cc3c74e01ef3b",
}
LOGITS = {
    "scannet_seg.serve@5":
        "390e0de08899fe397c124f7f7fc8eff27005edc16b4735beb73c244942fe4e60",
    "scannet_seg.serve@2147483659":
        "58f8e849a760facd18f4e6de29da3bef8ed83f86a1fbd3b322d296c131ba23fc",
}
# [forward_flops, knn3_bytes, knn3_pairs] at a batch
WORK = {
    "scannet_whole_scene@1": (25164578816, 3570304, 688979968),
    "scannet_whole_scene@4": (100658315264, 14281216, 2755919872),
    "scannet_whole_scene@8": (201316630528, 28562432, 5511839744),
    "scannet_seg@1": (4605034496, 437920, 17895424),
    "scannet_seg@4": (18420137984, 1751680, 71581696),
    "scannet_seg@8": (36840275968, 3503360, 143163392),
}


def digest(arrays, names=()) -> str:
    h = hashlib.sha256()
    for n in names:
        h.update(n.encode() + b"\0")
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _config(name: str) -> dict:
    return spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")


def _workload(name: str) -> dict:
    return spec.load_json(spec.BENCH_DIR / "workloads" / f"{name}.json")


def _net(config: str):
    return spec.reference_network(_config(config))


@pytest.mark.parametrize("key", sorted(POOLS))
def test_pool(key):
    name, seed = key.split("@")
    pool = traffic.make_pool(_workload(name), int(seed))
    assert pool.feat is None
    assert digest([a for a in (pool.xyz, pool.labels) if a is not None]) \
        == POOLS[key]


@pytest.mark.parametrize("key", sorted(STATE_DICTS))
def test_state_dict(key):
    name, seed = key.split("@")
    cfg = from_dict(_config(name)["config"])
    sd = weights.make_state_dict(cfg.model, int(seed), "cpu", _net(name))
    assert digest([v.numpy() for v in sd.values()], list(sd)) == \
        STATE_DICTS[key]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_logits(seed, one_thread):
    f = _config("scannet_seg")
    wl = _workload("scannet_seg.serve")
    cfg = from_dict(f["config"])
    sd = weights.make_state_dict(cfg.model, seed, "cpu", _net("scannet_seg"))
    first = traffic.requests(traffic.make_pool(wl, seed),
                             int(wl["batch"]))[0]
    ref = ServeReference(cfg, sd, "cpu", net=_net("scannet_seg"))
    logits = ref(first.xyz, PREDICTOR_KEY, first.feat).numpy()
    assert digest([logits]) == LOGITS[f"scannet_seg.serve@{seed}"]


@pytest.mark.parametrize("key", sorted(WORK))
def test_work_counts(key):
    name, batch = key.split("@")
    cfg = _config(name)["config"]
    b = int(batch)
    assert (forward_flops(cfg, b), knn3_bytes(cfg, b), knn3_pairs(cfg, b)) \
        == WORK[key]
