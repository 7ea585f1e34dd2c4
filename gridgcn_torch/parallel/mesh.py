"""A data-parallel mesh over `torch.distributed` (the JAX package's
`parallel/mesh.py`).

The JAX package runs one program over a 1-D device mesh: GSPMD splits the
batch over the chips and inserts the reductions. The port runs one process
per device instead, joined by a process group: gloo on the CPU, NCCL
between distinct cards, and gloo again when several ranks share one card
(NCCL refuses that). A `Mesh` is that group seen from one rank: its size,
its rank, its device, and the collectives the data-parallel paths use.
Only `all_reduce` is used; under gloo a CUDA tensor goes through the
host (`all_reduce_`), so a collective has completed when it returns; a
gather is an all-reduce of a zero-filled global buffer into
which each rank wrote its rows (adding zeros is exact, so the gather is
bit for bit).

    from gridgcn_torch.parallel.launch import launch
    launch(fn, 2, "cpu")          # 2 workers on localhost, each fn(...)
    mesh = make_mesh(2, devices=mesh_devices("cpu", 2))   # in a worker

`init_distributed` joins the group that `torchrun` (or any launcher that
sets `MASTER_ADDR`, `MASTER_PORT`, `RANK` and `WORLD_SIZE`) describes.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600.0


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum t over the group's ranks in place. Under gloo a CUDA tensor is
    summed in a host copy and copied back: the result is then in t when
    this returns, on the current stream."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D data-parallel mesh: the process group, its
    size, this process's rank and device."""
    group: dist.ProcessGroup
    size: int
    rank: int
    device: torch.device

    def rows(self, n: int) -> tuple[int, int]:
        """This rank's contiguous rows [r0, r1) of a global batch of n; n
        must divide by the mesh size, as a sharded JAX batch must."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not shard over "
                             f"{self.size} devices")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of t (a new tensor; no gradient)."""
        return all_reduce_(t.detach().clone(), self.group)

    def sum_all(self, tensors: Sequence[torch.Tensor]) -> list:
        """The sums over the ranks of same-dtype tensors, in one
        all-reduce of their concatenation, each copied out into a tensor
        of its own (a reduction over a view at an odd offset may take
        another kernel path, and so another summation order, than over
        an allocation of its own: with one rank the sums are then the
        inputs bit for bit)."""
        flat = all_reduce_(torch.cat([t.detach().reshape(-1)
                                      for t in tensors]), self.group)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view_as(t).clone())
            i += t.numel()
        return out


    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The global [n, ...] tensor whose rows rows(n) are each rank's
        `local`, on every rank: an all-reduce of zeros and the rows."""
        r0, r1 = self.rows(n)
        out = local.new_zeros((n, *local.shape[1:]))
        out[r0:r1] = local
        return all_reduce_(out, self.group)


def mesh_devices(device, n: int) -> list[torch.device]:
    """The devices of an n-rank mesh for a `--device` choice: cuda:0 ..
    cuda:n-1 (raises when fewer cards exist, as JAX's `make_mesh` does when
    fewer devices exist), or the CPU n times."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise ValueError(f"requested a {n}-device mesh but only {have} "
                         f"CUDA devices are available")
    return [torch.device("cuda", i) for i in range(n)]


def backend_for(devices: Sequence) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    distinct = len({(d.type, d.index) for d in devs}) == len(devs)
    if all(d.type == "cuda" for d in devs) and distinct:
        return "nccl"
    return "gloo"


def init_distributed(devices: Sequence, timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group that the environment describes
    (`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`, as `torchrun` sets
    them): NCCL when `devices` (one per rank) are distinct cards, else
    gloo. A no-op without that environment or when a group exists;
    returns whether a group exists after the call."""
    if dist.is_initialized():
        return True
    env = os.environ
    if not all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                  "WORLD_SIZE")):
        return False
    world = int(env["WORLD_SIZE"])
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    backend = backend_for(devices)
    rank = int(env["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(torch.device(devices[rank]))
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
                             f"{env['MASTER_PORT']}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The data-parallel mesh over every process of the group, this rank's
    device `devices[rank]` (default: its card under NCCL, else the CPU).
    Raises when more devices are asked for than there are processes; a
    mesh spans every process."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the workers with "
                           "gridgcn_torch.parallel.launch or torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if num_devices is None else num_devices
    if n > world:
        raise ValueError(f"requested a {n}-device mesh but only {world} "
                         f"devices are available")
    if n < world:
        raise ValueError(f"a {n}-device mesh in a group of {world} "
                         f"processes: a mesh spans every process")
    if devices is None:
        devices = (mesh_devices("cuda", world)
                   if dist.get_backend() == "nccl"
                   else mesh_devices("cpu", world))
    if len(devices) < world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    return Mesh(group=dist.group.WORLD, size=world, rank=rank,
                device=torch.device(devices[rank]))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous rows of every entry of a global batch dict
    (numpy arrays or tensors, every entry batch-leading)."""
    n = len(next(iter(batch.values())))
    r0, r1 = mesh.rows(n)
    return {k: v[r0:r1] for k, v in batch.items()}


def fetch_global(x: torch.Tensor, mesh: Optional[Mesh] = None,
                 n: Optional[int] = None) -> np.ndarray:
    """A value on the host as numpy: without a mesh the tensor itself;
    with one, the global [n, ...] array whose rows rows(n) are each rank's
    `x` (the JAX package's fetch of a sharded array), on every rank."""
    if mesh is not None:
        x = mesh.gather_rows(x, n if n is not None else len(x) * mesh.size)
    return x.detach().cpu().numpy()
