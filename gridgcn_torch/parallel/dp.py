"""Data-parallel train and eval steps (the JAX package's `parallel/dp.py`).

The JAX package's DP step is `jax.jit` of the single-device step with the
batch sharded over the mesh: GSPMD computes the single-device step on the
global batch. Its BatchNorm statistics are therefore the global batch's
(the docstring of its `parallel/dp.py` says shard-local, but
`tests/test_sharding.py` holds its gradients to the single device's).
These steps do the same over a `torch.distributed` mesh: each rank runs
its rows of the global batch, and `train.steps` sums what the global batch
sums (the BatchNorm statistics through a differentiable all-reduce, the
loss's and accuracy's counts, the gradients, the confusion matrix). The
batch a step takes is this rank's rows (`mesh.shard_batch`); every rank
ends the step with the same parameters and optimizer state.
"""

from __future__ import annotations

from gridgcn_torch.configs.base import Config
from gridgcn_torch.parallel.mesh import Mesh
from gridgcn_torch.train.steps import make_eval_step, make_train_step


def make_parallel_train_step(cfg: Config, mesh: Mesh, class_weights=None):
    """`steps.make_train_step` over the mesh: (state, rows, rng) →
    (state, global metrics)."""
    return make_train_step(cfg, class_weights=class_weights, mesh=mesh)


def make_parallel_eval_step(cfg: Config, mesh: Mesh):
    """`steps.make_eval_step` over the mesh: (state, rows, rng) → the
    global batch's confusion matrix, on every rank."""
    return make_eval_step(cfg, mesh=mesh)
