"""One rank of the gloo mesh that `tests/test_torch_comm_audit.py` starts
on the CPU: it runs the port's parallel programs once each (a DP train
step per task, the tier-2 and tier-3 forwards, both spatial train steps)
with torch.distributed's collectives wrapped to record the bytes each is
handed, and returns what this rank recorded. Imports the port only; the
program carries no counter of its own. `chip_smoke.py` counts the card's
tier-3 bytes with the same `recording`."""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from gridgcn_torch.configs import presets
from gridgcn_torch.configs.base import apply_overrides
from gridgcn_torch.models.build import build_model, init_model
from gridgcn_torch.parallel import dp
from gridgcn_torch.parallel.mesh import make_mesh, mesh_devices, shard_batch
from gridgcn_torch.parallel.resident import (
    make_resident_forward, resident_halo, scene_bounds, slab_inputs)
from gridgcn_torch.parallel.resident_ml import make_resident_ml_forward
from gridgcn_torch.parallel.spatial import partition_scene
from gridgcn_torch.parallel.spatial_train import (
    make_spatial_train_step, shard_scene_batch)
from gridgcn_torch.train import steps
from gridgcn_torch.utils import jaxrng

# (config, overrides) of each program the test audits
DP_CASES = {"cls": ("synthetic_tiny", {"data.batch_size": 4}),
            "seg": ("synthetic_tiny_seg", {"data.batch_size": 4})}
TIER_CASE = ("synthetic_tiny_seg", {"model.dtype": "bfloat16"})
N_SCENE = 128


def config(case):
    name, over = case
    return apply_overrides(presets.get(name), over)


@contextlib.contextmanager
def recording(log: list):
    """Record (collective, bytes handed to it) for every all_reduce,
    all_gather and point-to-point op (isend / irecv) in the block."""
    ar, ag, bi = dist.all_reduce, dist.all_gather, dist.batch_isend_irecv

    def nbytes(t):
        return t.numel() * t.element_size()

    def all_reduce(t, *a, **k):
        log.append(("all_reduce", nbytes(t)))
        return ar(t, *a, **k)

    def all_gather(out, t, *a, **k):
        log.append(("all_gather", nbytes(t)))
        return ag(out, t, *a, **k)

    def batch_isend_irecv(ops):
        log.extend((op.op.__name__, nbytes(op.tensor)) for op in ops)
        return bi(ops)

    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    dist.batch_isend_irecv = batch_isend_irecv
    try:
        yield
    finally:
        dist.all_reduce, dist.all_gather, dist.batch_isend_irecv = ar, ag, bi


def run():
    torch.set_num_threads(1)
    mesh = make_mesh(2, mesh_devices("cpu", 2))
    rng = np.random.default_rng(0)
    out = {}
    for task, case in DP_CASES.items():
        cfg = config(case)
        _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
        state = steps.create_train_state(cfg, build_model(cfg.model), sd, 4,
                                         device="cpu")
        shape = (4,) if task == "cls" else (4, 256)
        batch = {"xyz": rng.uniform(0, 1, (4, 256, 3)).astype(np.float32),
                 "mask": np.ones((4, 256), bool),
                 "label": rng.integers(0, 4, shape).astype(np.int32)}
        log = out[f"dp {task}"] = []
        with recording(log):
            dp.make_parallel_train_step(cfg, mesh)(
                state, shard_batch(batch, mesh), jaxrng.PRNGKey(0))

    cfg = config(TIER_CASE)
    model, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    xyz = rng.uniform(0, 8, (N_SCENE, 3)).astype(np.float32)
    mask = np.ones(N_SCENE, bool)
    origin, vsize = scene_bounds(xyz, mask, cfg.model.layers[0].resolution)
    extent = vsize * cfg.model.layers[0].resolution / (1.0 + 1e-5)
    sx, sm, _, sidx, edges = partition_scene(
        xyz, mask, 2, resident_halo(cfg, vsize), N_SCENE)
    pos = slab_inputs(cfg, sx, sm, sidx, slice(mesh.rank, mesh.rank + 1),
                      "cpu")
    for tier, fwd, geo in (("tier2", make_resident_forward(cfg, mesh), vsize),
                           ("tier3", make_resident_ml_forward(cfg, mesh),
                            extent)):
        log = out[tier] = []
        with torch.no_grad(), recording(log):
            fwd(model, *pos, edges, origin, geo, jaxrng.PRNGKey(0))
    state = steps.create_train_state(cfg, build_model(cfg.model), sd, 4,
                                     device="cpu")
    labels = rng.integers(0, 4, N_SCENE).astype(np.int32)
    batch = shard_scene_batch(cfg, xyz, labels, mask, mesh, N_SCENE)
    for tier in ("resident", "resident_ml"):
        step = make_spatial_train_step(cfg, mesh, tier=tier)
        log = out[f"train {tier}"] = []
        with recording(log):
            step(state, batch, jaxrng.PRNGKey(1))
    return mesh.rank, out


def run_all(result_dir: str):
    """Each rank writes what it recorded to result_dir/rank<r>.pt."""
    rank, out = run()
    torch.save(out, f"{result_dir}/rank{rank}.pt")
