"""Train and eval steps (the JAX package's `train/steps.py`).

    state = create_train_state(cfg, model, state_dict, steps_per_epoch)
    step = make_train_step(cfg)
    state, metrics = step(state, batch, rng)       # updates state in place
    cm = make_eval_step(cfg)(state, batch, rng)     # [C, C] int32

A step runs on the state's device (CUDA unless the caller asks for the
CPU): augmentation, CAGQ, forward, loss, backward and the optimizer. The
parameters and BatchNorm statistics live in the model, the optimizer's
moments in tensors beside them. The randomness follows the JAX step: one
key per step, `fold_in(rng, step)`, split into the augmentation, CAGQ and
dropout streams, so the same key gives the JAX package's draws and indices.
The optimizer is optax's Adam (or AdamW, after an optional global-norm
clip) written op by op, not `torch.optim`, whose formulas round otherwise.

Given a `parallel.mesh.Mesh`, the same steps run data-parallel
(`parallel.dp`): each rank takes its rows of the global batch, and the
step is the single-device step on the global batch, as the JAX package's
GSPMD step is. Every draw is made at the global batch's counters (the
rank's rows of them, `row0`), BatchNorm takes the global batch's
statistics, the loss and accuracy divide by the global counts, and the
gradients are summed over the ranks before the norm, the clip and Adam,
so every rank holds the same parameters and optimizer state. With one
rank the arithmetic is the single-device step's, bit for bit. Steps run
with TF32 off (`utils.precision.full_fp32`), the caller's setting
restored after.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gridgcn_torch.configs.base import Config
from gridgcn_torch.data.augment import augment_batch, rotation_y
from gridgcn_torch.data.native import label_histogram
from gridgcn_torch.data.pipeline import to_device
from gridgcn_torch.models.layers import batch_stats_over, update_batch_stats
from gridgcn_torch.train.metrics import confusion_matrix
from gridgcn_torch.utils import jaxrng
from gridgcn_torch.utils.precision import full_fp32

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


def noise_gradient_params(cfg: Config, names) -> set[str]:
    """The parameters among `names` (the model's parameter names) whose
    training gradient is 0 up to rounding: the bias of each Dense layer
    that feeds a batch-statistics BatchNorm (the BatchNorm subtracts it
    again), and the attention logit's bias of each GridConv stage with
    softmax attention (softmax is shift-invariant). Two devices or two
    packages give these gradients different rounding noise, which Adam
    turns into a step of up to lr either way."""
    names = set(names)
    layers = cfg.model.layers

    def softmax_logit_bias(n: str) -> bool:
        stage = n.split(".")[0]
        return (n.endswith(".att_dense1.bias") and stage.startswith("gridconv")
                and layers[int(stage[8:])].att_activation == "softmax")

    return {n for n in names if n.endswith(".bias") and (
        ("_dense" in n and n.replace("_dense", "_bn") in names)
        or softmax_logit_bias(n))}


class Adam:
    """optax's `adam(sched)` (or `adamw(sched, weight_decay)`), after
    `clip_by_global_norm(grad_clip)` when grad_clip > 0, on a list of
    parameters updated in place. Every optax operation is its own rounded
    float32 step:

        g ← g                      if ‖g‖ < clip else g / ‖g‖ · clip
        mu ← (1 − b1)·g + b1·mu,   nu ← (1 − b2)·g² + b2·nu
        u ← (mu / (1 − b1ᵗ)) / (sqrt(nu / (1 − b2ᵗ)) + eps),  t = count + 1
        u ← u + wd·p  (adamw),     p ← p + (−sched(count))·u
    """

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
        """One optimizer step with `grads` (matching `params`) and their
        global norm."""
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

    def state_dict(self) -> dict:
        """The optimizer's state: the moments (in `params`' order) and the
        step count."""
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a `state_dict()` into this optimizer's moments (on their
        device) and set its step count."""
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            if len(mine) != len(theirs):
                raise ValueError(f"optimizer state holds {len(theirs)} "
                                 f"moments, this optimizer {len(mine)}")
            for m, t in zip(mine, theirs):
                m.copy_(t)
        self.count = int(state["count"])


def make_optimizer(cfg: Config, params, steps_per_epoch: int) -> Adam:
    """The optimizer over params for cfg.train: Adam, AdamW when
    weight_decay > 0, clipped by global norm when grad_clip > 0; its
    schedule (`make_lr_schedule`) is its `sched`."""
    t = cfg.train
    return Adam(params, make_lr_schedule(cfg, steps_per_epoch),
                weight_decay=t.weight_decay, grad_clip=t.grad_clip)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics) and its optimizer,
    on one device; `step` counts the optimizer steps taken."""
    model: nn.Module
    tx: Adam
    device: torch.device

    @property
    def step(self) -> int:
        return self.tx.count


def create_train_state(cfg: Config, model: nn.Module, state_dict,
                       steps_per_epoch: int, device="cuda") -> TrainState:
    """Load state_dict into model, move it to device and build the
    optimizer. device "cuda" (the default) raises when CUDA is absent;
    "cpu" runs the kernels' plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "to train on the CPU")
    model.load_state_dict(state_dict)
    model.to(dev)
    tx = make_optimizer(cfg, model.parameters(), steps_per_epoch)
    return TrainState(model=model, tx=tx, device=dev)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _loss_and_logits(cfg: Config, logits: torch.Tensor, batch: dict,
                     class_weights: Optional[torch.Tensor] = None,
                     total: Callable = _identity):
    """(loss, acc) of the JAX package: cls cross-entropy (label smoothing
    optional); seg per-point cross-entropy over the one-hot labels,
    masked, without the ignore label, optionally weighted by class.
    `total` sums a count over the data-parallel ranks: the loss is then
    this rank's share (its own sum over the global denominator, the
    shares summing to the global loss) and acc the global accuracy."""
    labels = batch["label"]
    ls = cfg.train.label_smoothing
    C = cfg.model.num_classes
    pred = logits.argmax(-1)
    if cfg.model.task == "cls":
        if ls > 0:
            target = (1.0 - ls) * F.one_hot(labels, C).float() + ls / C
            per = -(target * F.log_softmax(logits, -1)).sum(-1)
        else:
            picked = logits.gather(-1, labels[..., None])[..., 0]
            per = torch.logsumexp(logits, -1) - picked
        n = total(per.new_full((), float(per.shape[0])))
        return (per.sum() / n,
                total((pred == labels).float().sum()) / n)
    onehot = F.one_hot(labels, C).to(logits.dtype)
    target = (1.0 - ls) * onehot + ls / C if ls > 0 else onehot
    ce = -(target * F.log_softmax(logits, -1)).sum(-1)
    mask = batch["mask"]
    if cfg.model.ignore_label is not None:
        mask = mask & (labels != cfg.model.ignore_label)
    w = mask.to(ce.dtype)
    if class_weights is not None:
        w = w * (onehot * class_weights.to(ce.dtype)).sum(-1)
    loss = (ce * w).sum() / torch.clamp_min(total(w.sum().detach()), 1e-6)
    n = torch.clamp_min(total(mask.sum()), 1)
    return loss, total((mask & (pred == labels)).sum()).float() / n.float()


def class_weights_from_dataset(labels, num_classes: int,
                               ignore_label: int | None = None
                               ) -> torch.Tensor:
    """Inverse-sqrt-frequency class weights (seg), float32 on the CPU. The
    ignore class gets weight 0 and leaves the frequency normalization."""
    hist = label_histogram(labels, num_classes).astype(np.float64)
    if ignore_label is not None:
        hist[ignore_label] = 0.0
    freq = hist / max(hist.sum(), 1.0)
    w = 1.0 / np.sqrt(freq + 1e-4)
    if ignore_label is not None:
        w[ignore_label] = 0.0
        w = w / w[w > 0].mean() if (w > 0).any() else w
    else:
        w = w / w.mean()
    return torch.as_tensor(w, dtype=torch.float32)


def _rows(batch: dict, mesh) -> tuple[int, Callable]:
    """(row0, total) of a step: the first global row of this rank's batch
    rows and the sum over the ranks (row 0 and the identity without a
    mesh). A mesh's ranks hold equal shares of the global batch."""
    if mesh is None:
        return 0, _identity
    return mesh.rank * len(batch["xyz"]), mesh.sum


def make_train_step(cfg: Config, class_weights=None, mesh=None):
    """(state, batch, rng) → (state, metrics): one training step on the
    state's device, the state updated in place. batch holds numpy arrays
    or tensors ("xyz", "mask", "label", optional "feat"); rng is a jaxrng
    key. metrics: "loss", "acc", "grad_norm" (before clipping) and "lr",
    the optimizer's schedule at the step count after the update. With a
    `parallel.mesh.Mesh`, batch is this rank's rows of the global batch
    (`parallel.mesh.shard_batch`) and the metrics are the global batch's
    (see the module docstring)."""

    def step(state: TrainState, batch: dict, rng: np.ndarray):
        model, dev = state.model, state.device
        b = to_device(batch, dev)
        row0, total = _rows(b, mesh)
        cw = None if class_weights is None else \
            torch.as_tensor(class_weights, device=dev)
        k_aug, k_cagq, k_drop = jaxrng.split(jaxrng.fold_in(rng, state.step),
                                             3)
        model.train()
        params = state.tx.params
        with full_fp32(), batch_stats_over(
                model, None if mesh is None else mesh.group):
            xyz, mask, feat = augment_batch(b["xyz"], b["mask"], k_aug,
                                            cfg.data, feat=b.get("feat"),
                                            row0=row0)
            with torch.enable_grad():
                logits = model(xyz, feat, mask, k_cagq, k_drop, row0=row0)
                loss, acc = _loss_and_logits(
                    cfg, logits, {**b, "mask": mask}, cw, total)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, params)]
            with torch.no_grad():
                if mesh is not None:
                    grads = mesh.sum_all(grads)
                    loss = mesh.sum(loss.detach())
                update_batch_stats(model)
                grad_norm = global_norm(grads)
                state.tx.update(grads, grad_norm)
        return state, {"loss": loss.detach(), "acc": acc,
                       "grad_norm": grad_norm,
                       "lr": torch.tensor(state.tx.sched(state.step))}

    return step


def _confusion_mask(cfg: Config, batch: dict):
    """Confusion-matrix weighting of an eval batch: the point mask for seg
    (without the ignore label), none for cls; in both, the clouds that pad
    a final partial batch (batch["example_mask"]) are left out."""
    em = batch.get("example_mask")
    if cfg.model.task == "seg":
        mask = batch["mask"]
        if cfg.model.ignore_label is not None:
            mask = mask & (batch["label"] != cfg.model.ignore_label)
        return mask & em[:, None] if em is not None else mask
    return em


def make_eval_step(cfg: Config, mesh=None):
    """(state, batch, rng) → confusion matrix [C, C] int32, the model in
    eval mode (running BatchNorm statistics, no dropout). With a mesh,
    batch is this rank's rows and the matrix is summed over the ranks."""

    @torch.no_grad()
    def step(state: TrainState, batch: dict, rng: np.ndarray):
        b = to_device(batch, state.device)
        row0, total = _rows(b, mesh)
        with full_fp32():
            logits = state.model.eval()(b["xyz"], b.get("feat"), b["mask"],
                                        rng, row0=row0)
        return total(confusion_matrix(logits, b["label"],
                                      cfg.model.num_classes,
                                      _confusion_mask(cfg, b)))

    return step


def make_voting_eval_step(cfg: Config, votes: int, mesh=None):
    """Rotation-voting eval: vote v rotates the cloud (and the feature
    columns cfg.data.feat_geo_channels) by 2πv/votes about the up axis and
    draws CAGQ keys from fold_in(rng, v); the votes' logits are summed
    before the confusion matrix. votes=1 is the plain eval step. With a
    mesh, batch is this rank's rows and the matrix is summed over the
    ranks."""
    geo = list(cfg.data.feat_geo_channels)
    if geo and len(geo) != 3:
        raise ValueError("feat_geo_channels must name 3 columns")

    @torch.no_grad()
    @full_fp32()
    def step(state: TrainState, batch: dict, rng: np.ndarray):
        b = to_device(batch, state.device)
        row0, total = _rows(b, mesh)
        model = state.model.eval()
        acc = None
        for v in range(votes):
            rot = rotation_y(torch.tensor(2.0 * math.pi * v / votes,
                                          device=state.device))
            feat = b.get("feat")
            if feat is not None and geo:
                feat = feat.clone()
                feat[..., geo] = feat[..., geo] @ rot
            logits = model(b["xyz"] @ rot, feat, b["mask"],
                           jaxrng.fold_in(rng, v), row0=row0)
            acc = logits if acc is None else acc + logits
        return total(confusion_matrix(acc, b["label"], cfg.model.num_classes,
                                      _confusion_mask(cfg, b)))

    return step
