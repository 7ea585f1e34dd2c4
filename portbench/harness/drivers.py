"""The port's timed paths. A driver's `call(i)` is the i-th request or
step as a user makes it, returning once its result is on the host:

  * `ServeDriver`: `api.Predictor.__call__` on request i mod R (the pool
    cut into R requests), with the request's per-point features where the
    pool has them and the key the Predictor takes when the caller passes
    none; logits come back as a numpy array, [B, N, C] per point or
    [B, C] per cloud.
  * `TrainDriver`: the trainer's step (`train.steps.make_train_step` on
    `create_train_state`), fed as the trainer feeds it (a `Prefetcher`
    putting each batch, its features with it, on the device ahead of the
    step), the loss read as the trainer's log reads it.

Each exposes `points` (the points one call carries). Each takes, beside
the port's configuration, `net`: the reference network's class, which the
stand-ins of `controls.py` build in the program's place and the port's own
drivers leave alone."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from harness import traffic

# the key `api.Predictor` takes when its caller passes none: PRNGKey(0)
PREDICTOR_KEY = np.array([0, 0], np.uint32)


class ServeDriver:
    def __init__(self, port_cfg, state_dict, pool: traffic.Pool,
                 batch: int, device, net=None):
        from gridgcn_torch.api import Predictor

        self.predict = Predictor(port_cfg, state_dict, device=device)
        self.batch = batch
        self.requests = traffic.requests(pool, batch)
        self.points = batch * pool.xyz.shape[1]

    def request(self, i: int) -> traffic.Request:
        """Request i: its clouds [B, N, 3] and features [B, N, C] or
        None."""
        return self.requests[i % len(self.requests)]

    def call(self, i: int) -> np.ndarray:
        xyz, feat = self.request(i)
        if self.batch == 1:         # one cloud, as a user passes it: [N, …]
            return self.predict(xyz[0], None if feat is None
                                else feat[0])[None]
        return self.predict(xyz, feat)

    def close(self):
        self.predict = None


class TrainDriver:
    def __init__(self, port_cfg, state_dict, batches: traffic.Batches,
                 key: np.ndarray, device, net=None):
        from gridgcn_torch.data.pipeline import Prefetcher, to_device
        from gridgcn_torch.models.build import build_model
        from gridgcn_torch.train.steps import (
            create_train_state, make_train_step)

        model = build_model(port_cfg.model)
        self.state = create_train_state(
            port_cfg, model, {k: v.clone() for k, v in state_dict.items()},
            steps_per_epoch=batches.per_epoch, device=device)
        self.model = self.state.model
        self.names = [n for n, _ in self.model.named_parameters()]
        self.step = make_train_step(port_cfg)
        self.key = key
        self.points = batches.batch * batches.xyz.shape[1]
        dev = torch.device(device)
        self.feed = Prefetcher((batches.get(j) for j in itertools.count()),
                               put=lambda b: to_device(b, dev))

    def call(self, i: int) -> float:
        self.state, m = self.step(self.state, next(self.feed), self.key)
        return float(m["loss"])

    # readings of the program's state for the check (set-up, not timed)

    @torch.no_grad()
    def first_gradient_norms(self) -> dict:
        """{parameter: ‖g‖} of the gradient the optimizer took at its
        first step, worked out from Adam's first moment (mu = (1 − b1)·g);
        read right after the first step."""
        tx = self.state.tx
        scale = float(np.float32(1 - tx.b1))
        return {n: torch.linalg.vector_norm(m.double()).item() / scale
                for n, m in zip(self.names, tx.mu)}

    @torch.no_grad()
    def state_copy(self) -> dict:
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    def close(self):
        self.state = self.model = self.step = None
