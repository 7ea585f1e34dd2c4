"""Stand-ins for the port's timed path, for showing that the check fails
what it must fail (`portbench/readings.py` on the card, the tests on the
CPU): the control, the plain reference put in the program's place and
computed one precision below the configuration's (fp8 Dense operands for
its bfloat16), and the faults a cell can have. Each has the interface of
the driver it replaces, and builds the reference network that the
configuration names (`net`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from harness import traffic
from harness.drivers import PREDICTOR_KEY, ServeDriver
from reference.config import from_dict
from reference.serve import ServeReference
from reference.train import TrainReference


def as_reference(cfg):
    """The reference's config tree for a config of the port or of the
    reference (the same dataclasses, field for field)."""
    return from_dict(dataclasses.asdict(cfg))


class ControlServe:
    """The reference served in fp8 in place of `api.Predictor`."""

    def __init__(self, cfg, state_dict, pool: traffic.Pool, batch: int,
                 device, net):
        self.ref = ServeReference(as_reference(cfg), state_dict, device,
                                  precision="fp8", net=net)
        self.requests = traffic.requests(pool, batch)
        self.points = batch * pool.xyz.shape[1]

    def request(self, i: int) -> traffic.Request:
        return self.requests[i % len(self.requests)]

    def call(self, i: int) -> np.ndarray:
        xyz, feat = self.request(i)
        return self.ref(xyz, PREDICTOR_KEY, feat).cpu().numpy()

    def close(self):
        self.ref = None


def alter_answer(out: np.ndarray) -> np.ndarray:
    """The fault "an answer altered where it is produced": in each cloud's
    first answer (its first point's logits [B, N, C], or the cloud's own
    [B, C]), the largest and smallest logits swapped."""
    out = out.copy()
    for b in range(len(out)):
        row = out[b].reshape(-1, out.shape[-1])[0]
        hi, lo = int(row.argmax()), int(row.argmin())
        row[hi], row[lo] = row[lo], row[hi]
    return out


class AlteredServe(ServeDriver):
    """The port's timed path with the fault `alter_answer` planted where
    its answer is produced."""

    def call(self, i: int) -> np.ndarray:
        return alter_answer(super().call(i))


class ControlTrain:
    """The reference's training step in place of the port's: in fp8
    (`precision="fp8"`, the control), or in float32 on the first half of
    each batch alone, the mean taken over it (`half_batch`, a fault)."""

    def __init__(self, cfg, state_dict, batches: traffic.Batches, key,
                 device, net, precision: str = "fp8",
                 half_batch: bool = False):
        self.trainer = TrainReference(
            as_reference(cfg), {k: v.clone() for k, v in state_dict.items()},
            batches.per_epoch, device, precision=precision, net=net)
        self.names = self.trainer.names
        self.batches, self.key, self.half = batches, key, half_batch
        self.points = batches.batch * batches.xyz.shape[1]
        self.grads = None

    def call(self, i: int) -> float:
        b = self.batches.get(i)
        if self.half:
            b = {k: v[:len(v) // 2] for k, v in b.items()}
        loss, grads = self.trainer.step(b, self.key)
        if self.trainer.tx.count == 1:
            self.grads = grads
        return loss

    @torch.no_grad()
    def first_gradient_norms(self) -> dict:
        return {n: torch.linalg.vector_norm(g.double()).item()
                for n, g in zip(self.names, self.grads)}

    @torch.no_grad()
    def state_copy(self) -> dict:
        return {k: v.clone() for k, v in self.trainer.state().items()}

    def close(self):
        self.trainer = None


def half_batch_train(*args, **kw) -> ControlTrain:
    """The fault "half of the batch left out, the mean taken over the
    rest", planted in the reference (float32) put in the program's place;
    the arguments are TrainDriver's."""
    return ControlTrain(*args, precision="float32", half_batch=True, **kw)
