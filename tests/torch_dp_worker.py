"""One rank of the gloo mesh that `tests/test_torch_dp.py` starts on the
CPU (`parallel.launch`): it runs every data-parallel path of the port on
the inputs the test wrote, and saves what each returned for the test to
hold against the JAX package. Imports the port only."""

import contextlib

import numpy as np
import torch

from gridgcn_torch.api import Predictor
from gridgcn_torch.models.build import build_model
from gridgcn_torch.parallel import dp
from gridgcn_torch.parallel.mesh import make_mesh, mesh_devices, shard_batch
from gridgcn_torch.parallel.spatial import sharded_scene_apply
from gridgcn_torch.train import steps


def _train_step(case, mesh, local_bn: bool):
    cfg = case["cfg"]
    state = steps.create_train_state(cfg, build_model(cfg.model), case["sd"],
                                     case["spe"], device="cpu")
    grads = []
    update = state.tx.update
    state.tx.update = lambda g, norm: (
        grads.append([x.clone() for x in g]), update(g, norm))[1]
    step = dp.make_parallel_train_step(cfg, mesh)
    with contextlib.ExitStack() as stack:
        if local_bn:       # the shard-local-statistics variant
            stack.enter_context(_patched(steps, "batch_stats_over",
                                         lambda model, group:
                                         contextlib.nullcontext()))
        state, m = step(state, shard_batch(case["batch"], mesh), case["key"])
    names = [n for n, _ in state.model.named_parameters()]
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: g.numpy() for n, g in zip(names, grads[0])},
            "sd": {k: v.clone() for k, v in state.model.state_dict().items()}}


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def run(inputs_path: str, out_dir: str):
    torch.set_num_threads(1)
    inp = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh(2, mesh_devices("cpu", 2))
    out = {"rank": mesh.rank, "train": {}}
    for name, case in inp["train"].items():
        out["train"][name] = {v: _train_step(case, mesh, v == "local")
                              for v in ("global", "local")}

    ev = inp["eval"]
    cfg = ev["cfg"]
    state = steps.create_train_state(cfg, build_model(cfg.model), ev["sd"], 1,
                                     device="cpu")
    out["eval_cm"] = dp.make_parallel_eval_step(cfg, mesh)(
        state, shard_batch(ev["batch"], mesh), ev["key"]).numpy()

    sv = inp["serve"]
    pred = Predictor(sv["cfg"], sv["sd"], device="cpu", mesh=mesh)
    out["serve"] = {b: pred(sv["xyz"][:b], rng=sv["key"])
                    for b in (3, 4)}

    t1 = inp["tier1"]
    model = build_model(t1["cfg"].model)
    model.load_state_dict(t1["sd"])
    model.eval()

    def apply_fn(x, m, row0):
        with torch.no_grad():
            return model(x, None, m, t1["key"], row0=row0)
    out["tier1"] = sharded_scene_apply(
        apply_fn, t1["xyz"], np.ones(len(t1["xyz"]), bool), mesh,
        halo=t1["halo"], capacity=t1["capacity"],
        num_outputs=t1["cfg"].model.num_classes)
    torch.save(out, f"{out_dir}/rank{mesh.rank}.pt")
