"""Traffic from a workload file's parameters, made from the run's seed:
a pool of clouds from the generator that the workload names
(`generators/<name>.py`, found by `spec.load_generator`), cut into requests
(serving) or shuffled into batches epoch by epoch (training). A cloud's
per-point features, where its generator gives them, ride with it. The same
seed gives the same clouds, requests and batches; every seed gives the same
sizes."""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

from harness import spec

ITEM_SEEDS = 4096       # pool item i of seed s is generated from s·4096 + i


class Pool(NamedTuple):
    xyz: np.ndarray                 # [P, N, 3] float32
    feat: np.ndarray | None         # [P, N, C] float32, or None
    labels: np.ndarray | None       # [P, ...] int32, or None


class Request(NamedTuple):
    xyz: np.ndarray                 # [B, N, 3]
    feat: np.ndarray | None         # [B, N, C], or None


def _stack(parts: list, dtype):
    if all(p is None for p in parts):
        return None
    if any(p is None for p in parts):
        raise ValueError("a generator gave some items of a pool features "
                         "or labels and others none")
    return np.stack(parts).astype(dtype, copy=False)


def make_pool(workload: dict, seed: int,
              bench_dir: Path | None = None) -> Pool:
    """The workload's pool, each item drawn by its generator (under
    `bench_dir`, default the benchmark's folder) under its own seed;
    labels only where the workload asks for them."""
    gen = spec.load_generator(
        spec.BENCH_DIR if bench_dir is None else bench_dir,
        workload["generator"])
    P = int(workload["pool"])
    if P > ITEM_SEEDS:
        raise ValueError(f"pool of {P} is over {ITEM_SEEDS} items")
    labels = bool(workload.get("labels", False))
    items = [gen(seed * ITEM_SEEDS + i, labels, workload["params"])
             for i in range(P)]
    return Pool(np.stack([x for x, _, _ in items]),
                _stack([f for _, f, _ in items], np.float32),
                _stack([y for _, _, y in items], np.int32) if labels
                else None)


def requests(pool: Pool, batch: int) -> list:
    """The pool cut into requests of `batch` clouds, in pool order; the
    driver cycles them."""
    P = len(pool.xyz)
    if P % batch:
        raise ValueError(f"the pool of {P} is not a multiple of the batch "
                         f"{batch}")

    def cut(a, r):
        return None if a is None else a[r * batch:(r + 1) * batch]

    return [Request(cut(pool.xyz, r), cut(pool.feat, r))
            for r in range(P // batch)]


class Batches:
    """Training batches: epoch e visits the pool in the order of
    `default_rng([seed, e]).permutation`, `batch` clouds a step, as the
    trainer's epochs do (drop-last); `get(j)` is step j's batch, with
    "feat" where the pool has features."""

    def __init__(self, pool: Pool, batch: int, seed: int):
        if len(pool.xyz) % batch:
            raise ValueError(f"the pool of {len(pool.xyz)} is not a "
                             f"multiple of the batch {batch}")
        self.xyz, self.feat, self.labels = pool
        self.batch, self.seed = batch, seed
        self.per_epoch = len(self.xyz) // batch

    def get(self, j: int) -> dict:
        e, s = divmod(j, self.per_epoch)
        order = np.random.default_rng([self.seed, e]).permutation(
            len(self.xyz))
        idx = order[s * self.batch:(s + 1) * self.batch]
        xyz = self.xyz[idx]
        out = {"xyz": xyz, "label": self.labels[idx],
               "mask": np.ones(xyz.shape[:2], bool)}
        if self.feat is not None:
            out["feat"] = self.feat[idx]
        return out
