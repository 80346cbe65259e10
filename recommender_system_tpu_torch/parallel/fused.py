"""The all-to-all exchange over row-sharded tables: the lookup and the fused
sparse update (counterpart of ``recommender_system_tpu/parallel/fused.py``).

A table's rows are split in contiguous blocks (``Mesh.shard_rows``): rank
``s`` holds ``K`` rows, global rows ``[s K, (s+1) K)``. Each rank owns a
stream of global row ids, its slice of the global stream (its rows of the
batch, in the JAX package's order), and exchanges it with the owners:

1. ``_route``: a stable sort by owner gives each entry its slot in its
   owner's bucket; an entry past the bucket's capacity ``cap`` overflows.
2. The buckets ``[n, cap]`` go out with one ``dist.all_to_all_single``;
   empty slots carry id -1 (and a zero cotangent).
3. The owner serves (or updates) its rows; an empty slot is read as local
   row 0, and its answer is never used (its zero cotangent changes no row).

``alltoall_take`` is the lookup: the rows come back with a second
all-to-all, overflowed entries as zero rows, and its backward routes the
cotangents to the owners and scatter-adds them into the shard with
``scatter_add_sorted`` (the sorted scatter-add kernel on the card).
``sharded_fused_update`` sends ids and cotangents and the owner applies the
fused rule (``cfg.apply``: the sparse Adagrad, SGD or lazy Adam kernel) to
its shard with rebased ids. Both count the overflow as a device tensor; no
step reads a value on the host.

``column_take`` is the lookup on a column-sharded table (rows over
'data', columns over 'model'): the ids of a rank's model peers go through
the same exchange over the ranks that hold the same columns, at full
capacity, and a second all-to-all over the model peers gives each rank the
whole width of its rows.

The capacity is ``ceil(capacity_factor * S / n)`` for a stream of ``S``
entries a rank, at most ``S``; ``capacity_factor=None`` is the full
capacity ``S``, which drops nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..ops.embedding_grad import scatter_add_sorted
from ..ops.stream_sort import sort_ids
from .mesh import Mesh, peers_to_rows

# an id past every owner: the padding of a stream split over the ranks
_SENTINEL = 2 ** 31 - 1
_EMPTY = -1


def _capacity(S: int, n: int, capacity_factor: Optional[float]) -> int:
    """Entries a rank takes from each source in a stream of ``S`` a rank."""
    if capacity_factor is None:
        return max(1, S)
    return max(1, min(int(math.ceil(capacity_factor * S / n)), S))


def _route(owner: torch.Tensor, n: int, cap: int):
    """Owner-bucket a stream: ``(order, sowner, slot, ok, overflow)``.
    ``order`` sorts the stream by owner (stable), ``slot`` is each sorted
    entry's rank in its bucket, or ``cap`` where it overflows or its owner is
    out of range (a pad); ``overflow`` counts the entries of real owners past
    ``cap``."""
    S = owner.shape[0]
    sowner, order = torch.sort(owner, stable=True)
    starts = torch.searchsorted(sowner, torch.arange(n, device=owner.device, dtype=owner.dtype))
    clamped = sowner.clamp(0, n - 1)
    pos = torch.arange(S, device=owner.device) - starts[clamped]
    valid = sowner < n
    ok = (pos < cap) & valid
    overflow = torch.sum(valid & ~ok)
    slot = torch.where(ok, pos, cap)
    return order, clamped, slot, ok, overflow


def _pad_stream(lids: torch.Tensor, ct: Optional[torch.Tensor], n: int):
    """A global stream padded to a multiple of ``n`` with ids no rank owns
    and zero cotangents, so that it splits evenly over the ranks."""
    rem = (-lids.shape[0]) % n
    if rem:
        lids = torch.cat([lids, lids.new_full((rem,), _SENTINEL)])
        if ct is not None:
            ct = torch.cat([ct, ct.new_zeros((rem,) + ct.shape[1:])])
    return lids, ct


def stream_slice(lids: torch.Tensor, ct: Optional[torch.Tensor], mesh: Mesh):
    """This rank's even slice of a global stream (padded first), as the JAX
    package's ``shard_map`` splits it."""
    lids, ct = _pad_stream(lids, ct, mesh.n)
    S = lids.shape[0] // mesh.n
    sl = slice(mesh.rank * S, (mesh.rank + 1) * S)
    return lids[sl], (None if ct is None else ct[sl])


def _bucket(values: torch.Tensor, sowner: torch.Tensor, slot: torch.Tensor, n: int,
            cap: int, fill) -> torch.Tensor:
    """Sorted entries into send buckets ``[n * cap, ...]``, ``fill`` where
    empty; an entry at slot ``cap`` lands in a column that is cut off."""
    buf = values.new_full((n, cap + 1) + values.shape[1:], fill)
    buf[sowner, slot] = values
    return buf[:, :cap].reshape((n * cap,) + values.shape[1:]).contiguous()


def _exchange(send: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One ``all_to_all_single`` of equal buckets: row block ``s`` goes to
    rank ``s``, and block ``s`` of the result came from rank ``s``."""
    return mesh.all_to_all(send)


@dataclasses.dataclass
class _Plan:
    """One stream's routing: the sort, the slots, and the local rows each
    received slot reads."""

    mesh: Mesh
    cap: int
    order: torch.Tensor
    sowner: torch.Tensor
    slot: torch.Tensor
    ok: torch.Tensor
    overflow: torch.Tensor
    local: torch.Tensor      # [n * cap] rows of this rank's shard
    num_rows: int


def plan_exchange(rows: torch.Tensor, owner: torch.Tensor, to_local, num_rows: int,
                  mesh: Mesh, cap: int) -> _Plan:
    """Route ``rows [S]`` (global ids, owned by ``owner``) into buckets of
    ``cap`` and send them to their owners, who map them to local rows with
    ``to_local``."""
    order, sowner, slot, ok, overflow = _route(owner, mesh.n, cap)
    sent = _bucket(rows[order].to(torch.int32), sowner, slot, mesh.n, cap, _EMPTY)
    recv = _exchange(sent, mesh).to(torch.int64)
    local = torch.where(recv >= 0, to_local(recv), 0).clamp(0, num_rows - 1)
    return _Plan(mesh, cap, order, sowner, slot, ok, overflow, local, num_rows)


class _Take(torch.autograd.Function):
    """Forward: serve the received rows and send them back. Backward: send
    the cotangents to the owners and scatter-add them into the shard."""

    @staticmethod
    def forward(ctx, shard, plan: _Plan):
        ctx.plan = plan
        served = shard.index_select(0, plan.local)
        back = _exchange(served, plan.mesh).reshape(plan.mesh.n, plan.cap, -1)
        got = back[plan.sowner, plan.slot.clamp(max=plan.cap - 1)]
        got = torch.where(plan.ok[:, None], got, torch.zeros((), dtype=got.dtype,
                                                                 device=got.device))
        return torch.empty_like(got).index_copy_(0, plan.order, got)

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        sent = _bucket(grad.contiguous().index_select(0, plan.order), plan.sowner,
                       plan.slot, plan.mesh.n, plan.cap, 0.0)
        ct = _exchange(sent, plan.mesh)
        slid, order = sort_ids(plan.local)
        return scatter_add_sorted(slid, order, ct, plan.num_rows), None


def alltoall_take(shard: torch.Tensor, rows: torch.Tensor, mesh: Mesh,
                  capacity_factor: Optional[float] = 2.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exchange lookup on a block-sharded table (a collective).

    ``shard [K, d]`` is this rank's block, ``rows [S]`` this rank's global
    row ids (every rank passes a stream of the same length). Returns
    ``([S, d], overflow)``: overflowed ids read zero rows and are counted
    (a 0-d int64 tensor on the device). Differentiable with respect to
    ``shard``: the gradient of an overflowed id is dropped."""
    K = shard.shape[0]
    rows = rows.reshape(-1).to(torch.int64)
    lo = mesh.rank * K
    cap = _capacity(rows.shape[0], mesh.n, capacity_factor)
    plan = plan_exchange(rows, rows // K, lambda r: r - lo, K, mesh, cap)
    return _Take.apply(shard, plan), plan.overflow


def column_take(shard: torch.Tensor, rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The lookup on a column-sharded table (a collective over a mesh with
    a model axis).

    ``shard [K, c]`` is this rank's block: rows ``[d K, (d+1) K)`` of its
    data index ``d``, columns ``[m c, (m+1) c)`` of its model index ``m``.
    ``rows [S]`` are this rank's global row ids (every rank passes as many).
    The model peers' ids are gathered (the data group's rows), exchanged
    over the ranks that share this column slice by row block at full
    capacity (exact, as the JAX package's GSPMD gather), and each peer gets
    back this rank's columns of its rows. Returns ``[S, model * c]``, the
    padded width. Differentiable with respect to ``shard``: the backward
    sends each owner the cotangents of its columns and scatter-adds them
    into its shard with ``scatter_add_sorted``; nothing is dropped."""
    K = shard.shape[0]
    peers, along = mesh.model_axis, mesh.data_axis
    ids = peers.all_gather(rows.reshape(-1).to(torch.int64))
    lo = along.rank * K
    plan = plan_exchange(ids, ids // K, lambda r: r - lo, K, along,
                         _capacity(ids.shape[0], along.n, None))
    return peers_to_rows(_Take.apply(shard, plan), peers)


def sharded_fused_update(cfg, shard: torch.Tensor, slots, lids: torch.Tensor,
                         ct: torch.Tensor, mesh: Mesh, *, step: Optional[int] = None,
                         scalars: Optional[torch.Tensor] = None,
                         capacity_factor: Optional[float] = 2.0) -> torch.Tensor:
    """One fused sparse step on a block-sharded table (a collective).

    ``cfg``: ``FusedAdagrad``, ``FusedSGD`` or ``FusedAdam``
    (``training.harness``); ``shard [K, d]`` and its ``slots`` are this
    rank's, updated in place; ``lids [S]`` and ``ct [S, d]`` are this rank's
    slice of the update stream. Each owner applies ``cfg.apply`` to its
    shard over the entries it received, ids rebased; entries past the
    capacity are dropped and counted; ``step`` and ``scalars`` go to
    ``cfg.apply`` (the step's scalars read from ``scalars`` where given).
    Returns the overflow (a 0-d int64
    tensor on the device). Every entry under capacity gets the single-card
    update: a row's cotangents from all ranks are summed before the rule."""
    K = shard.shape[0]
    lids = lids.reshape(-1).to(torch.int64)
    lo = mesh.rank * K
    cap = _capacity(lids.shape[0], mesh.n, capacity_factor)
    plan = plan_exchange(lids, lids // K, lambda r: r - lo, K, mesh, cap)
    sent = _bucket(ct.index_select(0, plan.order), plan.sowner, plan.slot, mesh.n,
                   plan.cap, 0.0)
    cfg.apply(shard, slots, plan.local, _exchange(sent, mesh).contiguous(), step=step,
              scalars=scalars)
    return plan.overflow
