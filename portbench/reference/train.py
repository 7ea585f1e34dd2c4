"""The reference's training step (a frozen copy of the port's
`train/steps.py` on one device, segmentation only; the network is the
class that the caller names): augmentation (the features' geometric
columns turning with the cloud), CAGQ, forward, the masked cross-entropy
without the ignore label, backward, the BatchNorm update and optax's Adam
with its schedule, every operation in float32 (or, for the control, in the
configuration's dtypes with fp8 Dense operands)."""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from . import jaxrng
from .augment import augment_batch
from .config import Config
from .layers import update_batch_stats
from .precision import full_fp32
from .serve import model_config, set_precision

_f32 = np.float32


def make_lr_schedule(cfg: Config, steps_per_epoch: int
                     ) -> Callable[[int], np.float32]:
    """optax's schedule for cfg.train as a host function of the step
    count, in float32: cosine decay to 1% over every step, a staircase
    exponential decay, or a constant."""
    t = cfg.train
    total = max(1, t.epochs * steps_per_epoch)
    lr = _f32(t.lr)
    if t.lr_schedule == "cosine":
        alpha = 0.01

        def cosine(count: int) -> np.float32:
            c = _f32(min(count, total))
            decay = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c
                                                  / _f32(total)))
            return lr * (_f32(1 - alpha) * decay + _f32(alpha))
        return cosine
    if t.lr_schedule == "step":
        def staircase(count: int) -> np.float32:
            if count <= 0:
                return lr
            p = np.floor(_f32(count) / _f32(t.lr_decay_steps))
            return lr * np.power(_f32(t.lr_decay_rate), p)
        return staircase
    if t.lr_schedule == "const":
        return lambda count: lr
    raise ValueError(f"unknown lr_schedule: {t.lr_schedule}")


def global_norm(tensors) -> torch.Tensor:
    """optax's `global_norm`: the L2 norm of all the tensors together."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Adam:
    """optax's `adam(sched)` (or `adamw`), after `clip_by_global_norm`
    when grad_clip > 0, on a list of parameters updated in place."""

    def __init__(self, params, sched, weight_decay: float = 0.0,
                 grad_clip: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.sched = sched
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads, grad_norm: torch.Tensor):
        grads = list(grads)
        if self.grad_clip > 0:
            keep = grad_norm < self.grad_clip
            grads = [torch.where(keep, g, (g / grad_norm) * self.grad_clip)
                     for g in grads]
        b1, b2 = _f32(self.b1), _f32(self.b2)
        torch._foreach_mul_(self.mu, float(b1))
        torch._foreach_add_(self.mu,
                            torch._foreach_mul(grads, float(_f32(1 - self.b1))))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, float(_f32(1 - self.b2)))
        torch._foreach_mul_(self.nu, float(b2))
        torch._foreach_add_(self.nu, g2)
        t = self.count + 1
        mu_hat = torch._foreach_div(self.mu, float(_f32(1) - b1 ** t))
        nu_hat = torch._foreach_div(self.nu, float(_f32(1) - b2 ** t))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, float(_f32(self.eps)))
        u = torch._foreach_div(mu_hat, den)
        if self.weight_decay > 0:
            torch._foreach_add_(u, torch._foreach_mul(
                self.params, float(_f32(self.weight_decay))))
        torch._foreach_mul_(u, float(-self.sched(self.count)))
        torch._foreach_add_(self.params, u)
        self.count = t


def seg_loss(cfg: Config, logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Per-point cross-entropy over the one-hot labels (label smoothing
    optional), masked, without the ignore label, over the kept points."""
    ls = cfg.train.label_smoothing
    C = cfg.model.num_classes
    onehot = F.one_hot(labels, C).to(logits.dtype)
    target = (1.0 - ls) * onehot + ls / C if ls > 0 else onehot
    ce = -(target * F.log_softmax(logits, -1)).sum(-1)
    if cfg.model.ignore_label is not None:
        mask = mask & (labels != cfg.model.ignore_label)
    w = mask.to(ce.dtype)
    return (ce * w).sum() / torch.clamp_min(w.sum().detach(), 1e-6)


class TrainReference:
    """The training step of the network `net` on `device` from
    `state_dict`'s weights: `step(batch, rng)` takes a batch of numpy
    arrays ("xyz", "label", "mask", and "feat" where the cloud has
    features) and the trainer's base key, and returns (loss, the gradients
    in `names`' order as the optimizer gets them). `names` are the
    parameters', `state()` every parameter and buffer by name."""

    def __init__(self, cfg: Config, state_dict, steps_per_epoch: int,
                 device, precision: str = "float32", *, net):
        if cfg.model.task != "seg":
            raise ValueError("the reference trains segmentation models")
        if cfg.train.class_weighting:
            raise ValueError("class weighting is not in the reference")
        self.cfg = cfg
        self.device = torch.device(device)
        model = net(model_config(cfg.model, precision))
        model.load_state_dict(state_dict)
        set_precision(model, precision)
        self.model = model.to(self.device)
        self.names = [n for n, _ in self.model.named_parameters()]
        t = cfg.train
        self.tx = Adam(self.model.parameters(),
                       make_lr_schedule(cfg, steps_per_epoch),
                       weight_decay=t.weight_decay, grad_clip=t.grad_clip)

    def state(self) -> dict:
        return {k: v.detach() for k, v in self.model.state_dict().items()}

    def step(self, batch: dict, rng: np.ndarray):
        dev = self.device
        xyz = torch.as_tensor(batch["xyz"], dtype=torch.float32, device=dev)
        mask = torch.as_tensor(batch["mask"], dtype=torch.bool, device=dev)
        labels = torch.as_tensor(batch["label"], dtype=torch.int64,
                                 device=dev)
        feat = batch.get("feat")
        if feat is not None:
            feat = torch.as_tensor(feat, dtype=torch.float32, device=dev)
        k_aug, k_cagq, k_drop = jaxrng.split(
            jaxrng.fold_in(rng, self.tx.count), 3)
        model = self.model.train()
        with full_fp32():
            xyz, mask, feat = augment_batch(xyz, mask, k_aug, self.cfg.data,
                                            feat=feat)
            with torch.enable_grad():
                logits = model(xyz, feat, mask, k_cagq, k_drop)
                loss = seg_loss(self.cfg, logits, labels, mask)
                grads = torch.autograd.grad(loss, self.tx.params,
                                            allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, self.tx.params)]
            with torch.no_grad():
                update_batch_stats(model)
                self.tx.update(grads, global_norm(grads))
        return float(loss.detach()), grads
