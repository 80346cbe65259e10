"""The mod-sharded lookup: all-to-all id exchange and local gather
(counterpart of ``recommender_system_tpu/parallel/embedding.py``).

Tables are **mod-sharded**: global row ``r`` lives on shard ``r % n`` at
local row ``r // n`` (``mod_shard_table``; hashed ids are uniform, so the
shards balance). ``alltoall_lookup`` is one rank's part of the lookup:

1. bucket this rank's ids by owner (a stable sort),
2. exchange the buckets with ``dist.all_to_all_single``, each bounded by
   ``cap = ceil(capacity_factor * B / n)`` (ids past it overflow and read
   zero rows),
3. gather from the local shard,
4. exchange the rows back and undo the sort.

It is differentiable with respect to the shard: the backward sends the
cotangents to the owners and scatter-adds them into the shard. The routing
is ``parallel/fused.py``'s, with the mod rule for owners and local rows.
``sharded_lookup`` drives it from a global batch of ids, and
``gspmd_lookup`` is the same exchange over a block-sharded table at full
capacity, which drops nothing: what the GSPMD gather of the JAX package
computes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .fused import _Take, alltoall_take, plan_exchange
from .mesh import Mesh


def mod_shard_table(table: np.ndarray, num_shards: int) -> np.ndarray:
    """``[V, d] -> [num_shards, ceil(V/n), d]`` with row r at
    ``[r % n, r // n]``, zeros elsewhere."""
    V, d = table.shape
    rows_per = math.ceil(V / num_shards)
    out = np.zeros((num_shards, rows_per, d), table.dtype)
    for s in range(num_shards):
        rows = np.arange(s, V, num_shards)
        out[s, : len(rows)] = table[rows]
    return out


def unshard_table(sharded: np.ndarray, vocab: int) -> np.ndarray:
    """Inverse of ``mod_shard_table``."""
    n, rows_per, d = sharded.shape
    out = np.zeros((vocab, d), sharded.dtype)
    for s in range(n):
        rows = np.arange(s, vocab, n)
        out[rows] = sharded[s, : len(rows)]
    return out


def _lookup_capacity(B: int, n: int, capacity_factor: float) -> int:
    """The JAX package's bucket bound for ``B`` ids a rank."""
    cap = int(math.ceil(capacity_factor * B / n))
    return min(cap, B) if B >= n else B


def alltoall_lookup(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                    capacity_factor: float = 2.0) -> torch.Tensor:
    """One rank's part of the mod-sharded lookup (a collective): embed this
    rank's ``ids [B]`` (every rank passes as many) from its ``table_shard
    [rows_per, d]``. Returns ``[B, d]``; ids past a destination's capacity
    read zero vectors and their gradients are dropped."""
    ids = ids.reshape(-1).to(torch.int64)
    n, B = mesh.n, ids.shape[0]
    plan = plan_exchange(ids, ids % n, lambda r: r // n, table_shard.shape[0], mesh,
                         _lookup_capacity(B, n, capacity_factor))
    return _Take.apply(table_shard, plan)


def sharded_lookup(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                   capacity_factor: float = 2.0) -> torch.Tensor:
    """The driver: this rank's shard of a mod-sharded table
    (``mod_shard_table(table, n)[rank]``) and the global ``ids [B]``, of
    which each rank looks up its block -> the global ``[B, d]`` on every
    rank (a collective)."""
    mine = alltoall_lookup(table_shard, mesh.shard_batch(ids), mesh, capacity_factor)
    return mesh.all_gather(mine)


def gspmd_lookup(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The JAX package's GSPMD gather: ``table [V, d]`` split in blocks of
    ``ceil(V / n)`` rows, each rank looking up its block of the global
    ``ids [B]`` through the block exchange at full capacity, so nothing is
    dropped -> the global ``[B, d]`` on every rank (a collective)."""
    per = -(-table.shape[0] // mesh.n)
    shard = torch.zeros(per, table.shape[1], dtype=table.dtype, device=mesh.device)
    block = table[mesh.rank * per:(mesh.rank + 1) * per]
    shard[:block.shape[0]] = block.to(mesh.device)
    mine, _ = alltoall_take(shard, mesh.shard_batch(ids), mesh, capacity_factor=None)
    return mesh.all_gather(mine)
