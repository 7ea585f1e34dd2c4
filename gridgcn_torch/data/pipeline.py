"""A materialized split and its shuffled batches (the JAX package's
`data/pipeline.Dataset`): the same seed gives the same batch order, the
same padding of the final partial batch and the same `example_mask`.
Batches are numpy; the train and eval steps move them to their device."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class Dataset:
    """A fully materialized split: points [S, N, 3], labels [S] or
    [S, N]."""
    points: np.ndarray
    labels: np.ndarray
    features: Optional[np.ndarray] = None   # [S, N, C] extra per-point feats
    task: str = "cls"
    num_classes: int = 0

    @property
    def size(self) -> int:
        return self.points.shape[0]

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, self.size // batch_size)

    def batches(self, batch_size: int, seed: int = 0,
                shuffle: bool = True, drop_last: bool = True
                ) -> Iterator[dict]:
        """Yield one epoch of numpy batches of a static batch size. A final
        partial batch (drop_last=False) is padded with clouds drawn again
        from the epoch's order; `example_mask` marks the real ones."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(self.size) if shuffle else np.arange(self.size)
        n = self.size
        stop = (n // batch_size) * batch_size if drop_last else n
        if stop == 0:
            stop = n
        for s in range(0, stop, batch_size):
            idx = order[s:s + batch_size]
            n_real = len(idx)
            if n_real < batch_size:
                idx = np.concatenate(
                    [idx, rng.choice(order, batch_size - n_real)])
            xyz = np.take(self.points, idx, axis=0)
            example_mask = np.zeros(batch_size, bool)
            example_mask[:n_real] = True
            batch = {
                "xyz": xyz,
                "label": np.take(self.labels, idx, axis=0),
                "mask": np.ones(xyz.shape[:2], bool),
                "example_mask": example_mask,
            }
            if self.features is not None:
                batch["feat"] = np.take(self.features, idx, axis=0)
            yield batch
