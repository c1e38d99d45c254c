"""The data axis and its collectives (counterpart of the JAX ``parallel/mesh.py``).

Where JAX runs one SPMD program over a ``Mesh`` whose ``data`` axis splits the
batch, the port runs one process a device, each on its contiguous slice of
the global batch, and a :class:`Mesh` holds the process group and the
``data`` axis size. A mesh without a group is a world of one: every
collective below is then the identity.

What JAX's sharded jit gives implicitly, the port's data-parallel step does
explicitly, so that the step over ``n`` ranks equals the step of one rank on
the whole batch:

- the replicated state: ``broadcast_module`` from rank 0 at the start;
- the gradient all-reduce: ``all_reduce_gradients`` averages over the ranks,
  so every loss is written as a rank's share whose mean over the ranks is
  the whole-batch loss. A mean over images is that already, the shards being
  equal; a sum over samples divided by their count divides by the count of
  the whole batch over ``n`` (``global_sum`` and ``shards``);
- live BatchNorm's moments over the whole batch (``global_moments``, a
  differentiable all-reduce, so the backward is the whole-batch backward);
- gathered outputs in rank order (``all_gather_rows``).

The step opens :func:`data_parallel` around its forward and backward; the
losses and the norms read :func:`active_mesh`. The tensor split of the
margin head over a ``model`` axis, and JAX's ``batch_sharding``,
``replicated`` and ``shard_map_compat``, have no counterpart here.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import process_device

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("pfr_data_parallel", default=None)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data`` axis of ``size`` ranks: this process's ``rank`` and
    ``device``, and the process group (``None`` in a world of one)."""

    size: int = 1
    rank: int = 0
    group: Any = None
    device: torch.device = torch.device("cpu")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.size}

    def rows(self, n: int) -> slice:
        """This rank's rows ``[r n / size, (r + 1) n / size)`` of ``n``."""
        if n % self.size:
            raise ValueError(f"batch of {n} rows does not split over a data axis of "
                             f"{self.size}")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A ``data`` axis over the process group: ``shape (-1,)`` takes every
    rank; another size must equal the group's. Only the ``data`` axis
    exists."""

    shape: tuple[int, ...] = (-1,)
    axes: tuple[str, ...] = ("data",)

    def build(self, device: str | torch.device = "cuda") -> Mesh:
        if tuple(self.axes) != ("data",) or len(self.shape) != 1:
            raise ValueError(f"axes {self.axes}: the port has only a ('data',) axis "
                             "(no tensor split over a 'model' axis)")
        grouped = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if grouped else 1
        size = world if self.shape[0] == -1 else int(self.shape[0])
        if size != world:
            raise ValueError(f"a data axis of {size} over a group of {world} processes")
        rank = dist.get_rank() if grouped else 0
        return Mesh(size, rank, dist.group.WORLD if grouped else None,
                    process_device(device, rank))


def create_mesh(shape: Sequence[int] = (-1,), axes: Sequence[str] = ("data",),
                device: str | torch.device = "cuda") -> Mesh:
    """The ``data`` axis over every process of the group (``-1``)."""
    return MeshSpec(tuple(shape), tuple(axes)).build(device)


def local_mesh(device: str | torch.device = "cuda") -> Mesh:
    return create_mesh(device=device)


def shard_batch(batch, mesh: Mesh | None, axis: str = "data"):
    """This rank's contiguous rows of every array in a dict, list or tuple of
    arrays (numpy or torch), as ``NamedSharding(P("data"))`` splits a global
    batch; ``ValueError`` when a batch does not split evenly."""
    if axis != "data":
        raise ValueError(f"axis {axis!r}: the port has only the 'data' axis")
    if mesh is None:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return batch[mesh.rows(len(batch))]


@contextlib.contextmanager
def data_parallel(mesh: Mesh | None):
    """Within: the losses and live norms of this thread take the mesh's
    whole-batch counts and moments."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.group is not None else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Mesh | None:
    """The mesh of the enclosing :func:`data_parallel` (with a group), else None."""
    return _ACTIVE.get()


def shards() -> int:
    """The ranks of the active mesh (1 outside one)."""
    mesh = active_mesh()
    return 1 if mesh is None else mesh.size


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A count summed over the ranks of the active mesh, without gradient
    (``x`` itself outside one)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.group)
    return x


def global_moments(x: torch.Tensor, dims: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """``E[x]`` and ``E[x^2]`` over ``dims`` of the whole batch of the active
    mesh (equal shards), through a differentiable all-reduce of the sums."""
    from torch.distributed.nn.functional import all_reduce

    mesh = active_mesh()
    count = float(np.prod([x.shape[d] for d in dims]) * mesh.size)
    sums = torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims)])
    sums = all_reduce(sums, group=mesh.group)
    return sums[0] / count, sums[1] / count


def all_reduce_gradients(params: Iterable[torch.nn.Parameter], mesh: Mesh | None) -> None:
    """Average every parameter's ``.grad`` over the mesh's ranks, in one
    flattened all-reduce (``None`` gradients stay ``None`` on every rank)."""
    if mesh is None or mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.size)
    for g, synced in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(synced)


def all_reduce_mean(values: dict[str, float], mesh: Mesh | None,
                    device: torch.device) -> dict[str, float]:
    """Floats averaged over the ranks (the whole-batch metrics of a step)."""
    if mesh is None or mesh.group is None or not values:
        return values
    t = torch.tensor(list(values.values()), dtype=torch.float64, device=device)
    dist.all_reduce(t, group=mesh.group)
    return dict(zip(values, (t / mesh.size).tolist()))


def broadcast_module(module: torch.nn.Module, mesh: Mesh | None) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if mesh is None or mesh.group is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)


def all_gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along dim 0 in rank order."""
    if mesh is None or mesh.group is None:
        return x
    if x.dtype == torch.bool:   # gloo has no bool collectives
        return all_gather_rows(x.to(torch.uint8), mesh).bool()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)
