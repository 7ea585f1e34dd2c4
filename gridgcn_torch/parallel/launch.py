"""Start the processes of a data-parallel mesh.

    launch(fn, mesh_devices("cpu", 2), *args, **kwargs)

runs `fn(*args, **kwargs)` in one worker process per device on localhost,
the workers joined in one process group (gloo on the CPU; NCCL over
distinct cards; see `mesh.backend_for`), and returns rank 0's result when
every worker has returned; a worker that raises, dies or outlives the
timeout makes it raise (a training run passes `timeout_s=None`: no wall
deadline, while a collective that waits longer than `mesh.TIMEOUT_S`
still fails). Under `torchrun` (the environment already
describes a group) it joins that group and runs `fn` in this process
instead, so the CLIs' `--mesh N` keeps the JAX package's one-command form
either way. `fn` must be importable (a module-level function) and its
result picklable; each worker builds its rank's mesh with `mesh.make_mesh`.
"""

from __future__ import annotations

import os
import socket
import time

import torch.distributed as dist
import torch.multiprocessing as mp

from typing import Optional

from gridgcn_torch.parallel.mesh import (
    TIMEOUT_S, backend_for, init_distributed)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, devices, timeout_s: float,
            results, fn, args, kwargs):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    init_distributed(devices, timeout_s)
    try:
        out = fn(*args, **kwargs)
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def launch(fn, devices, *args, timeout_s: Optional[float] = TIMEOUT_S,
           **kwargs):
    """Run fn(*args, **kwargs) on every rank of a mesh with one rank per
    entry of `devices` (`mesh.mesh_devices`). Returns rank 0's result (this
    process's under an existing group or torchrun). `timeout_s` bounds
    the workers' wall time and their collectives' waits (None: no wall
    deadline, collectives `mesh.TIMEOUT_S`; the training loops pass it)."""
    devices = list(devices)
    world = len(devices)
    group_timeout = TIMEOUT_S if timeout_s is None else timeout_s
    if dist.is_initialized() or init_distributed(devices, group_timeout):
        if dist.get_world_size() != world:
            raise ValueError(f"a {world}-rank mesh under a group of "
                             f"{dist.get_world_size()} processes")
        return fn(*args, **kwargs)
    backend_for(devices)                # refuse unknown devices early
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _worker, args=(world, _free_port(), devices, group_timeout, results,
                       fn, args, kwargs),
        nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out = []
    try:
        done = False
        while not done:
            done = ctx.join(timeout=1.0)
            while not results.empty():   # drain before the workers exit
                out.append(results.get())
            if not done and deadline is not None and \
                    time.monotonic() > deadline:
                raise TimeoutError(f"mesh workers ran past {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return out[0] if out else None
