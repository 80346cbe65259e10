"""The mesh: one ``torch.distributed`` process group whose ranks split every
batch and shard every embedding table by row (counterpart of
``recommender_system_tpu/parallel/mesh.py``).

``make_mesh(data, model=1, group=None)`` returns a ``Mesh``: the group, its
size ``n``, this rank, and the data and model sizes. The table rule is the
JAX package's ``param_shardings`` with ``column_sharding=False``: a
``table_d{d}`` parameter (and its optimizer state) is split by row over all
ranks (``EmbeddingCollection.shard``), everything else is replicated and
its gradient summed over ranks (``Trainer``).

Rows are split as the JAX package splits its lane-packed stacks. A dim-d
stack there has ``R`` wide rows of ``P = pack_factor(d)`` logical rows each,
``R`` rounded up to a multiple of 512, and shard ``s`` of ``n`` owns wide
rows ``[s R/n, (s+1) R/n)``. So here the logical table is padded with zero
rows to ``R P`` rows under a mesh, and rank ``s`` holds rows
``[s R P/n, (s+1) R P/n)``: every row lands on the shard that owns it in the
JAX package (``shard_rows``).

The collectives that carry gradients are autograd functions:

- ``all_reduce_sum``: the sum over ranks, whose backward sums the incoming
  gradients over ranks too. For a value each rank goes on to use on its own
  rows (BatchNorm's batch moments).
- ``replicated_sum``: the sum over ranks, whose backward passes the gradient
  through. For a value that only the loss reads, which every rank computes
  whole (DIEN's auxiliary loss).
- ``gather_rows``: every rank's rows concatenated in rank order, whose
  backward keeps this rank's slice of the gradient (the loss is computed
  whole on every rank, so each rank holds the whole gradient).

The model axis (``model > 1``: MMOE's expert sharding and the column
sharding of wide stacks) comes with a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..convert import pack_factor

# the JAX package rounds a stack's wide rows up to a multiple of this
STACK_ROW_MULTIPLE = 512


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A process group as a ('data', 'model') mesh; see the module docstring.
    ``device`` is where this rank's tensors lie."""

    group: dist.ProcessGroup
    n: int
    rank: int
    data: int
    model: int
    device: torch.device

    def shard_batch(self, batch):
        """This rank's rows of a global batch: ``B / n`` consecutive rows of
        every leaf (a dict of arrays or tensors, or one), as the JAX
        package's ``batch_sharding`` gives device ``rank`` its block."""
        def take(v):
            b = v.shape[0]
            if b % self.n:
                raise ValueError(f"a global batch of {b} rows does not split over "
                                 f"{self.n} ranks")
            per = b // self.n
            return v[self.rank * per:(self.rank + 1) * per]

        if isinstance(batch, Mapping):
            return {k: take(v) for k, v in batch.items()}
        return take(batch)

    def shard_rows(self, total: int, dim: int) -> Tuple[int, int]:
        """``(rows a shard, padded rows)`` of a ``table_d{dim}`` of ``total``
        logical rows: the JAX package's stack of ``R`` wide rows of
        ``pack_factor(dim)`` each, split evenly. Raises where ``n`` does not
        divide ``R``, as the JAX package's exchange does."""
        P = pack_factor(dim)
        R = _ceil_div(_ceil_div(total, P), STACK_ROW_MULTIPLE) * STACK_ROW_MULTIPLE
        if R % self.n:
            raise ValueError(f"a stack of {R} wide rows does not split over {self.n} "
                             f"ranks; stacks are rounded to {STACK_ROW_MULTIPLE}-row "
                             f"multiples: use a power-of-two mesh <= {STACK_ROW_MULTIPLE}")
        return R * P // self.n, R * P

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """In-place sum over ranks, no autograd; returns ``tensor``."""
        dist.all_reduce(tensor, group=self.group)
        return tensor

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's ``tensor`` concatenated on axis 0 in rank order, no
        autograd."""
        parts = [torch.empty_like(tensor) for _ in range(self.n)]
        dist.all_gather(parts, tensor.contiguous(), group=self.group)
        return torch.cat(parts)


def make_mesh(data: Optional[int] = None, model: int = 1,
              group: Optional[dist.ProcessGroup] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """A ('data', 'model') mesh over a process group.

    ``group=None`` takes the default group, which must be initialised
    (``parallel.launch.initialize``), with NCCL on the card (this rank's
    current device) or gloo on the CPU. A group the caller passes is taken
    as it is, with its tensors on ``device`` (default: the card's current
    device for NCCL, else the CPU): four gloo ranks sharing one card pass
    theirs. ``data`` defaults to the group's size; ``data * model`` must
    equal it. ``model > 1`` raises ``NotImplementedError``."""
    if model != 1:
        raise NotImplementedError(
            "a model axis (model > 1: MMOE's expert sharding and the column sharding "
            "of wide stacks) comes with a later slice of the port; use model=1")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.launch.initialize, or torch.distributed)")
    passed = group is not None
    group = group if passed else dist.group.WORLD
    backend = dist.get_backend(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group carries CUDA tensors, not {device}")
    if not passed and backend == "gloo" and device.type != "cpu":
        raise ValueError("gloo carries CUDA tensors through host memory: pass the "
                         "group to make_mesh to use it on the card")
    n = dist.get_world_size(group)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"a mesh of data={data} x model={model} needs a group of "
                         f"{data * model} ranks, not {n}")
    return Mesh(group=group, n=n, rank=dist.get_rank(group), data=data, model=model,
                device=device)


def shard_table(table: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a logical ``[total, dim]`` table (or state of its
    shape), zero-padded to the JAX package's stack rows first."""
    total, dim = table.shape
    per, padded = mesh.shard_rows(total, dim)
    lo = mesh.rank * per
    out = torch.zeros(per, dim, dtype=table.dtype, device=mesh.device)
    hi = min(lo + per, total)
    if hi > lo:
        out[:hi - lo] = table[lo:hi].to(mesh.device)
    return out


def unshard_table(shard: torch.Tensor, total: int, mesh: Mesh) -> torch.Tensor:
    """The logical ``[total, dim]`` table from every rank's shard (a
    collective: every rank calls it and gets the whole table)."""
    return mesh.all_gather(shard)[:total]


def rank_seed(seed: int, rank: int) -> int:
    """The dropout generator's seed of ``rank`` under ``seed``."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.clone()), None


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.b = mesh, x.shape[0]
        return mesh.all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.mesh.rank * ctx.b
        return grad[lo:lo + ctx.b], None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over ranks; its backward sums the gradients over ranks."""
    return _AllReduceSum.apply(x, mesh)


def replicated_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over ranks of a value only the whole loss reads; its backward
    passes the gradient through."""
    return _ReplicatedSum.apply(x, mesh)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows in rank order; its backward keeps this rank's
    slice."""
    return _GatherRows.apply(x, mesh)
