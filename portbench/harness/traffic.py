"""Traffic from a workload file's parameters, made from the run's seed:
a pool of clouds from one general generator, cut into requests (serving)
or shuffled into batches epoch by epoch (training). The same seed gives
the same clouds, requests and batches; every seed gives the same sizes."""

from __future__ import annotations

import numpy as np

from harness import scenes

GENERATORS = {"scene_surface": scenes.synthetic_scene_surface}
ITEM_SEEDS = 4096       # pool item i of seed s is generated from s·4096 + i


def make_pool(workload: dict, seed: int):
    """(xyz [P, N, 3] float32, labels [P, N] int32 or None) for the
    workload's pool, each item drawn by its generator under its own seed."""
    gen = GENERATORS[workload["generator"]]
    P = int(workload["pool"])
    if P > ITEM_SEEDS:
        raise ValueError(f"pool of {P} is over {ITEM_SEEDS} items")
    labels = bool(workload.get("labels", False))
    params = dict(workload["params"])
    if "room" in params:
        params["room"] = tuple(params["room"])
    items = [gen(seed=seed * ITEM_SEEDS + i, return_labels=labels, **params)
             for i in range(P)]
    if labels:
        return (np.stack([x for x, _ in items]),
                np.stack([y for _, y in items]).astype(np.int32))
    return np.stack(items), None


def requests(pool_xyz: np.ndarray, batch: int) -> list:
    """The pool cut into requests of `batch` clouds, in pool order; the
    driver cycles them."""
    P = len(pool_xyz)
    if P % batch:
        raise ValueError(f"the pool of {P} is not a multiple of the batch "
                         f"{batch}")
    return [pool_xyz[r * batch:(r + 1) * batch] for r in range(P // batch)]


class Batches:
    """Training batches: epoch e visits the pool in the order of
    `default_rng([seed, e]).permutation`, `batch` clouds a step, as the
    trainer's epochs do (drop-last); `get(j)` is step j's batch."""

    def __init__(self, xyz: np.ndarray, labels: np.ndarray, batch: int,
                 seed: int):
        if len(xyz) % batch:
            raise ValueError(f"the pool of {len(xyz)} is not a multiple of "
                             f"the batch {batch}")
        self.xyz, self.labels, self.batch, self.seed = xyz, labels, batch, seed
        self.per_epoch = len(xyz) // batch

    def get(self, j: int) -> dict:
        e, s = divmod(j, self.per_epoch)
        order = np.random.default_rng([self.seed, e]).permutation(
            len(self.xyz))
        idx = order[s * self.batch:(s + 1) * self.batch]
        xyz = self.xyz[idx]
        return {"xyz": xyz, "label": self.labels[idx],
                "mask": np.ones(xyz.shape[:2], bool)}
