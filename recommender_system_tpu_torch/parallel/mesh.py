"""The mesh: one ``torch.distributed`` process group laid out as a
('data', 'model') grid, whose ranks split every batch and shard the
embedding tables and MMOE's experts (counterpart of
``recommender_system_tpu/parallel/mesh.py``).

``make_mesh(data, model=1, group=None)`` returns a ``Mesh``: the group, its
size ``n``, this rank, the data and model sizes and, with ``model > 1``, the
two axis groups through this rank. Ranks lie row-major, rank ``d * model +
m``, as the JAX package reshapes its devices to ``[data, model]``. Every
rank holds its ``B / n`` consecutive rows of each global batch.

The placement rule (``sharding_rule``) is the JAX package's ``_rule``,
one ``Placement`` a parameter (and each optimizer state of its shape):

- ``"columns"``: a ``table_d{d}`` with ``d >= COLUMN_SHARD_MIN_DIM`` when
  ``model > 1``, the step is the plain one without the explicit lookup
  (``column_sharding``) and the JAX stack's lanes split over 'model' (its
  ``[R, 128]`` stack where rows are packed, ``[R, d]`` where they are
  not): rows over 'data', columns over 'model'. The JAX package splits
  the lanes of its lane-packed stack, so at dim 64 (two logical rows a
  wide row) a wide row's two logical rows land on two model ranks; the
  port keeps logical ``[rows, d]`` tables and splits their columns, padded
  with zero columns to a multiple of ``model`` (``column_width``). A pad
  column's gradient is zero, so no optimizer moves it. A stack whose lanes
  do not split (DeepFM's ``table_d65`` at ``model=2``: 65 lanes) is
  row-sharded, as the JAX rule row-shards it.
- ``"rows"``: every other table, split by row over all ``n`` ranks.
- ``"experts"``: MMOE's ``experts [D, H, E]`` and ``expert_bias [H, E]``,
  the last (expert) axis split over 'model' when ``model > 1``, under the
  fused step too.
- Everything else is replicated; its gradient is summed over all ranks
  (``Trainer``).

Rows are split as the JAX package splits its lane-packed stacks. A dim-d
stack there has ``R`` wide rows of ``P = pack_factor(d)`` logical rows each,
``R`` rounded up to a multiple of 512, and shard ``s`` of ``n`` owns wide
rows ``[s R/n, (s+1) R/n)``. So here the logical table is padded with zero
rows to ``R P`` rows under a mesh, and rank ``s`` holds rows
``[s R P/n, (s+1) R P/n)``: every row lands on the shard that owns it in the
JAX package (``shard_rows``). A column-sharded table's row blocks are the
same over ``data`` parts.

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
- ``gather_peers``: the rows of every rank of this rank's model group
  (its data group's rows), whose backward sums the peers' gradients of
  this rank's rows (a reduce-scatter, through one all-to-all).
- ``peers_to_rows``: this rank's slice of a last axis (its experts, or its
  columns) on every model peer's rows -> the whole last axis on this
  rank's rows, one all-to-all; its backward sends each peer the gradient
  of its slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..convert import pack_factor

# the JAX package rounds a stack's wide rows up to a multiple of this
STACK_ROW_MULTIPLE = 512
# tables at least this wide are column-sharded over 'model' (the JAX rule)
COLUMN_SHARD_MIN_DIM = 64
_LANES = 128


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A process group as a ('data', 'model') mesh; see the module docstring.
    ``device`` is where this rank's tensors lie; ``axes`` the two axis
    groups through this rank with ``model > 1`` (``data_axis``,
    ``model_axis``)."""

    group: dist.ProcessGroup
    n: int
    rank: int
    data: int
    model: int
    device: torch.device
    axes: Optional[Tuple["Mesh", "Mesh"]] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def data_axis(self) -> "Mesh":
        """The ranks that share this rank's model index, in data order: the
        group over which an expert's gradient is summed and a column shard's
        rows are exchanged (the whole mesh when ``model == 1``)."""
        return self if self.axes is None else self.axes[0]

    @property
    def model_axis(self) -> "Mesh":
        """The ranks that share this rank's data index, in model order (its
        model peers, which hold its data group's rows between them)."""
        if self.axes is None:
            raise ValueError("a mesh with model == 1 has no model axis")
        return self.axes[1]

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

    def shard_rows(self, total: int, dim: int, parts: Optional[int] = None
                   ) -> Tuple[int, int]:
        """``(rows a shard, padded rows)`` of a ``table_d{dim}`` of ``total``
        logical rows split in ``parts`` blocks (default ``n``): the JAX
        package's stack of ``R`` wide rows of ``pack_factor(dim)`` each,
        split evenly. Raises where ``parts`` does not divide ``R``, as the
        JAX package's exchange does."""
        parts = self.n if parts is None else parts
        P = pack_factor(dim)
        R = _ceil_div(_ceil_div(total, P), STACK_ROW_MULTIPLE) * STACK_ROW_MULTIPLE
        if R % parts:
            raise ValueError(f"a stack of {R} wide rows does not split over {parts} "
                             f"ranks; stacks are rounded to {STACK_ROW_MULTIPLE}-row "
                             f"multiples: use a power-of-two mesh <= {STACK_ROW_MULTIPLE}")
        return R * P // parts, R * P

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """In-place sum over ranks, no autograd; returns ``tensor``."""
        dist.all_reduce(tensor, group=self.group)
        return tensor

    def all_gather(self, tensor: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``tensor`` concatenated on ``dim`` in rank order, no
        autograd."""
        parts = [torch.empty_like(tensor) for _ in range(self.n)]
        dist.all_gather(parts, tensor.contiguous(), group=self.group)
        return torch.cat(parts, dim)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """One ``all_to_all_single`` of equal blocks on axis 0: block ``s``
        goes to rank ``s``, and block ``s`` of the result came from rank
        ``s``; no autograd."""
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send.contiguous(), group=self.group)
        return recv


def make_mesh(data: Optional[int] = None, model: int = 1,
              group: Optional[dist.ProcessGroup] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """A ('data', 'model') mesh over a process group.

    ``group=None`` takes the default group, which must be initialised
    (``parallel.launch.initialize``), with NCCL on the card (this rank's
    current device) or gloo on the CPU. A group the caller passes is taken
    as it is, with its tensors on ``device`` (default: the card's current
    device for NCCL, else the CPU): four gloo ranks sharing one card pass
    theirs. ``data`` defaults to the group's size over ``model``;
    ``data * model`` must equal it. With ``model > 1`` the axis groups are
    made with ``dist.new_group``, which every process of the default group
    calls: every process calls ``make_mesh`` alike."""
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
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide a group of {n} ranks")
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"a mesh of data={data} x model={model} needs a group of "
                         f"{data * model} ranks, not {n}")
    rank = dist.get_rank(group)
    axes = None
    if model > 1:
        ranks = dist.get_process_group_ranks(group)
        d, m = divmod(rank, model)
        # ranks sharing a model index (one group a column), then those
        # sharing a data index (one group a row), made in the same order on
        # every process
        columns = [dist.new_group([ranks[i * model + j] for i in range(data)],
                                  backend=backend) for j in range(model)]
        rows = [dist.new_group([ranks[i * model + j] for j in range(model)],
                               backend=backend) for i in range(data)]
        axes = (Mesh(group=columns[m], n=data, rank=d, data=data, model=1, device=device),
                Mesh(group=rows[d], n=model, rank=m, data=model, model=1, device=device))
    return Mesh(group=group, n=n, rank=rank, data=data, model=model, device=device,
                axes=axes)


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


def column_width(dim: int, model: int) -> int:
    """The columns of a ``table_d{dim}`` a model rank holds: ``dim`` split
    over ``model``, padded with zero columns where it does not divide."""
    return _ceil_div(dim, model)


def column_sharded(total: int, dim: int, mesh: Mesh) -> bool:
    """The JAX rule's test for a ``table_d{dim}`` of ``total`` rows under
    the plain step: at least ``COLUMN_SHARD_MIN_DIM`` wide on a mesh with a
    model axis, the JAX stack's lanes (128 where rows are packed, else
    ``dim``) split over 'model' and its wide rows over 'data'."""
    if dim < COLUMN_SHARD_MIN_DIM or mesh.model == 1:
        return False
    P = pack_factor(dim)
    lanes = _LANES if P > 1 else dim
    R = _ceil_div(_ceil_div(total, P), STACK_ROW_MULTIPLE) * STACK_ROW_MULTIPLE
    return lanes % mesh.model == 0 and R % mesh.data == 0


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a parameter of single-device ``shape`` (and each optimizer state
    of that shape) lies on a mesh: ``kind`` ``"rows"``, ``"columns"`` or
    ``"experts"`` (see the module docstring)."""

    kind: str
    shape: Tuple[int, ...]

    def shard(self, whole: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        """This rank's part of the single-device tensor ``whole``."""
        if self.kind == "rows":
            return shard_table(whole, mesh)
        if self.kind == "columns":
            total, dim = self.shape
            per, _ = mesh.shard_rows(total, dim, mesh.data)
            width = column_width(dim, mesh.model)
            lo, c0 = mesh.data_index * per, mesh.model_index * width
            out = torch.zeros(per, width, dtype=whole.dtype, device=mesh.device)
            block = whole[lo:lo + per, c0:c0 + width]
            out[:block.shape[0], :block.shape[1]] = block.to(mesh.device)
            return out
        if self.kind == "experts":
            part = self.shape[-1] // mesh.model
            return whole.narrow(-1, mesh.model_index * part, part).to(
                mesh.device, copy=True).contiguous()
        raise ValueError(f"unknown placement {self.kind!r}")

    def unshard(self, part: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        """The single-device tensor from every rank's part (a collective:
        every rank calls it and gets the whole tensor)."""
        if self.kind == "rows":
            return unshard_table(part, self.shape[0], mesh)
        if self.kind == "columns":
            total, dim = self.shape
            wide = mesh.model_axis.all_gather(part, dim=1)
            return mesh.data_axis.all_gather(wide)[:total, :dim]
        if self.kind == "experts":
            return mesh.model_axis.all_gather(part, dim=-1)
        raise ValueError(f"unknown placement {self.kind!r}")


def table_sharding(shape: Tuple[int, ...]) -> Placement:
    """A table split by row over every rank."""
    return Placement("rows", tuple(shape))


def wide_table_sharding(shape: Tuple[int, ...]) -> Placement:
    """A wide table: rows over 'data', columns over 'model'."""
    return Placement("columns", tuple(shape))


def expert_sharding(shape: Tuple[int, ...], mesh: Mesh) -> Placement:
    """Expert parallelism: the last (expert) axis split over 'model'; raises
    where ``model`` does not divide the experts."""
    if shape[-1] % mesh.model:
        raise ValueError(f"{shape[-1]} experts do not split over a model axis of "
                         f"{mesh.model}")
    return Placement("experts", tuple(shape))


def _table_dim(name: str) -> Optional[int]:
    key = name.rsplit(".", 1)[-1]
    if key.startswith("table_d") and key[len("table_d"):].isdigit():
        return int(key[len("table_d"):])
    return None


def is_embedding_table_path(name: str) -> bool:
    """True for a parameter (or optimizer state) name whose last part is a
    ``table_d{dim}``."""
    return _table_dim(name) is not None


def is_expert_path(name: str) -> bool:
    """True for MMOE's expert tensors (``experts``, ``expert_bias``)."""
    return name.rsplit(".", 1)[-1] in ("experts", "expert_bias")


def sharding_rule(name: str, shape: Tuple[int, ...], mesh: Mesh,
                  column_sharding: bool = True) -> Optional[Placement]:
    """The JAX package's ``_rule`` for a parameter of single-device
    ``shape``: a placement, or None where it is replicated."""
    if is_embedding_table_path(name) and len(shape) == 2:
        if column_sharding and column_sharded(shape[0], _table_dim(name), mesh):
            return wide_table_sharding(shape)
        return table_sharding(shape)
    if is_expert_path(name) and len(shape) >= 2 and mesh.model > 1:
        return expert_sharding(shape, mesh)
    return None


def param_shardings(params: Mapping[str, torch.Tensor], mesh: Mesh,
                    column_sharding: bool = True) -> Dict[str, Placement]:
    """Each parameter's placement by name (``model.named_parameters()``),
    the replicated ones left out. ``column_sharding=False`` splits every
    table by row, as the fused step and the explicit lookup need."""
    out = {}
    for name, tensor in params.items():
        placement = sharding_rule(name, tuple(tensor.shape), mesh, column_sharding)
        if placement is not None:
            out[name] = placement
    return out


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


class _GatherPeers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        mine = axis.all_to_all(grad)  # block s: peer s's gradient of this rank's rows
        return mine.reshape((axis.n, -1) + grad.shape[1:]).sum(0), None


class _PeersToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, axis):
        ctx.axis = axis
        M = axis.n
        got = axis.all_to_all(y)  # block s: peer s's slice on this rank's rows
        got = got.reshape((M, -1) + y.shape[1:])
        return got.movedim(0, -2).reshape(got.shape[1:-1] + (M * y.shape[-1],))

    @staticmethod
    def backward(ctx, grad):
        M = ctx.axis.n
        parts = grad.reshape(grad.shape[:-1] + (M, -1)).movedim(-2, 0)
        return ctx.axis.all_to_all(parts.reshape((-1,) + parts.shape[2:])), None


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


def gather_peers(x: torch.Tensor, axis: Mesh) -> torch.Tensor:
    """``[b, ...]`` on each rank of ``axis`` (a mesh's ``model_axis``) ->
    every rank's rows in rank order, ``[n b, ...]``; its backward sums the
    ranks' gradients of this rank's rows."""
    return _GatherPeers.apply(x, axis)


def peers_to_rows(y: torch.Tensor, axis: Mesh) -> torch.Tensor:
    """``[n b, ..., c]``, this rank's slice of a last axis on every rank's
    rows of ``axis`` (in rank order) -> ``[b, ..., n c]``, every rank's
    slice on this rank's rows (slice s at ``[s c, (s+1) c)``); its backward
    sends each rank the gradient of its slice."""
    return _PeersToRows.apply(y, axis)
