"""A data-parallel mesh over `torch.distributed` (the JAX package's
`parallel/mesh.py`).

The JAX package runs one program over a 1-D device mesh: GSPMD splits the
batch over the chips and inserts the reductions. The port runs one process
per device instead, joined by a process group: gloo on the CPU, NCCL
between distinct cards, and gloo again when several ranks share one card
(NCCL refuses that). A `Mesh` is that group seen from one rank: its size,
its rank, its device, and the collectives the data-parallel paths use.
Under gloo a CUDA tensor goes through the host (`all_reduce_`), so a
collective has completed when it returns; a gather of rows is an
all-reduce of a zero-filled global buffer into which each rank wrote its
rows (adding zeros is exact, so the gather is bit for bit).

The resident spatial tiers add a 2-D mesh and two differentiable
collectives. `make_mesh2d(data, space)` lays the ranks out as rows of
`space` (rank = row·space + col): each row is one scene's ring of slabs
(`SPACE_AXIS`), each column a data group (`DATA_AXIS`), and `mesh.axis(name)`
is the 1-D mesh along either axis, on which the helpers above work.
`all_gather` (JAX's `all_gather(..., tiled=True)`) and `shift` (a
`ppermute` by ±1 along the ring, the wrapped end zeroed) move bytes
exactly (`dist.all_gather` and `batch_isend_irecv` of byte views); their
backward passes are JAX's transposes: the cotangents summed over the
ranks with this rank's chunk kept, and the reverse shift.

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
DATA_AXIS = "data"
# scene batches ride DATA_AXIS of a 2-D mesh, each scene's slabs SPACE_AXIS
SPACE_AXIS = "space"


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


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on t goes through the host: a CUDA tensor
    under gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


@dataclasses.dataclass
class Mesh:
    """One rank's view of a mesh: the process group, its size, this
    process's rank and device. `ranks` are the group's members' global
    ranks in group order (None: the whole world's); a 2-D mesh
    (`make_mesh2d`) also holds its 1-D meshes along each axis, `axes`,
    and their sizes, `shape`."""
    group: dist.ProcessGroup
    size: int
    rank: int
    device: torch.device
    ranks: Optional[tuple] = None
    axes: Optional[dict] = None
    shape: Optional[dict] = None

    @property
    def axis_names(self) -> tuple:
        return (DATA_AXIS,) if self.shape is None else tuple(self.shape)

    def axis(self, name: str) -> "Mesh":
        """The 1-D mesh along `name`: this rank and the ranks that share
        its other coordinate (a 1-D mesh is its own DATA_AXIS)."""
        if self.axes is None:
            if name != DATA_AXIS:
                raise ValueError(f"a 1-D mesh has no {name!r} axis; build "
                                 "a 2-D mesh with make_mesh2d")
            return self
        return self.axes[name]

    def global_rank(self, r: int) -> int:
        return r if self.ranks is None else self.ranks[r]

    def rows(self, n: int) -> tuple[int, int]:
        """This rank's contiguous rows [r0, r1) of a global batch of n; n
        must divide by the mesh size, as a sharded JAX batch must."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not shard over "
                             f"{self.size} devices")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of t (a new tensor; no gradient). A
        one-rank mesh sums nothing and needs no process group."""
        if self.size == 1:
            return t.detach().clone()
        return all_reduce_(t.detach().clone(), self.group)

    def sum_all(self, tensors: Sequence[torch.Tensor]) -> list:
        """The sums over the ranks of same-dtype tensors, in one
        all-reduce of their concatenation, each copied out into a tensor
        of its own (a reduction over a view at an odd offset may take
        another kernel path, and so another summation order, than over
        an allocation of its own: with one rank the sums are then the
        inputs bit for bit)."""
        if self.size == 1:
            return [t.detach().clone() for t in tensors]
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


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """t's bytes as uint8 [len(t), bytes per row], a view of t's storage."""
    return t.reshape(t.shape[0], -1).view(torch.uint8)


def all_gather_exact(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's x [n, ...] concatenated in rank order, [size·n, ...],
    on every rank: `dist.all_gather` of the bytes, so bit for bit and of
    any dtype."""
    if mesh.size == 1:
        return x.clone()
    staged = _staged(x, mesh.group)
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather([_bytes(p) for p in parts], _bytes(src),
                    group=mesh.group)
    out = torch.cat(parts)
    return out.to(x.device) if staged else out


def shift_exact(x: torch.Tensor, mesh: Mesh, direction: int) -> torch.Tensor:
    """The ring shift of the JAX package's `_shift`: rank r gets rank
    r − direction's x (direction ±1), and the rank whose sender would wrap
    around the ring gets zeros. A `batch_isend_irecv` of x's bytes."""
    if direction not in (1, -1):
        raise ValueError(f"direction must be ±1, got {direction}")
    n, r = mesh.size, mesh.rank
    staged = n > 1 and _staged(x, mesh.group)
    src = (x.cpu() if staged else x).contiguous()
    out = torch.zeros_like(src)
    ops = []
    if 0 <= r + direction < n:
        ops.append(dist.P2POp(dist.isend, _bytes(src),
                              mesh.global_rank(r + direction), mesh.group))
    if 0 <= r - direction < n:
        ops.append(dist.P2POp(dist.irecv, _bytes(out),
                              mesh.global_rank(r - direction), mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(x.device) if staged else out


class _AllGather(torch.autograd.Function):
    """`all_gather_exact`, differentiable: each rank's loss may read every
    rank's rows, so the backward sums the cotangents over the ranks in
    their own dtype and keeps this rank's chunk, as JAX's transpose
    (a reduce-scatter) does."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return all_gather_exact(x, mesh)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        if m.size > 1:
            g = all_reduce_(g.clone(memory_format=torch.contiguous_format),
                            m.group)
        return g[m.rank * ctx.n:(m.rank + 1) * ctx.n], None


class _Shift(torch.autograd.Function):
    """`shift_exact`, differentiable: the backward is the reverse shift,
    its wrapped end zeroed too (JAX's transpose of the ppermute and the
    select)."""

    @staticmethod
    def forward(ctx, x, mesh, direction):
        ctx.mesh, ctx.direction = mesh, direction
        return shift_exact(x, mesh, direction)

    @staticmethod
    def backward(ctx, g):
        return shift_exact(g, ctx.mesh, -ctx.direction), None, None


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`jax.lax.all_gather(x, axis, tiled=True)` over a 1-D mesh, with its
    gradient."""
    return _AllGather.apply(x, mesh)


def shift(x: torch.Tensor, mesh: Mesh, direction: int) -> torch.Tensor:
    """The ring shift by ±1 over a 1-D mesh (`shift_exact`), with its
    gradient."""
    return _Shift.apply(x, mesh, direction)


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


def make_mesh2d(data: int, space: int,
                devices: Optional[Sequence] = None) -> Mesh:
    """The 2-D (scene × slab) mesh over every process of the group: rank
    r = row·space + col sits in row r // space (one scene's ring of
    `space` slabs, SPACE_AXIS) and column r % space (a data group,
    DATA_AXIS). Every rank creates every row's and column's process group,
    in the same order. Raises as the JAX package's does when data·space
    exceeds the devices, and when it is not the whole group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the workers with "
                           "gridgcn_torch.parallel.launch or torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    need = data * space
    have = world if devices is None else min(world, len(devices))
    if need > have:
        raise ValueError(f"requested a {data}x{space} mesh but only {have} "
                         f"devices are available")
    if need < world:
        raise ValueError(f"a {data}x{space} mesh in a group of {world} "
                         f"processes: a mesh spans every process")
    flat = make_mesh(world, devices)
    rows = [tuple(range(i * space, (i + 1) * space)) for i in range(data)]
    cols = [tuple(range(j, need, space)) for j in range(space)]
    row_groups = [dist.new_group(list(r)) for r in rows]
    col_groups = [dist.new_group(list(c)) for c in cols]
    row, col = divmod(rank, space)
    dev = flat.device
    axes = {DATA_AXIS: Mesh(col_groups[col], data, row, dev, ranks=cols[col]),
            SPACE_AXIS: Mesh(row_groups[row], space, col, dev,
                             ranks=rows[row])}
    return dataclasses.replace(flat, axes=axes,
                               shape={DATA_AXIS: data, SPACE_AXIS: space})


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
