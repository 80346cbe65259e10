"""Sorted update streams for the sparse row kernels
(counterpart of ``recommender_system_tpu/ops/stream_sort.py``).

``fused_adagrad_apply`` and ``scatter_add_sorted`` take the lookup's ids as a
sorted stream ``(slid, order)``: the sorted ids and the permutation into the
original order, ``slid == lids[order]``.

- ``sort_ids`` is the generic way: a stable sort of the ids.
- ``blocked_sort`` uses what the lookup site knows statically. Column ``f``
  of a ``[B, F]`` id matrix reads one table, whose rows
  ``[offset, offset + vocab)`` are fixed, and the tables lie in the stack in
  offset order. So per-column sorted blocks, concatenated in offset order,
  are sorted as a whole, and each key packs the offset-relative id and the
  position in its block into one integer: one single-array sort per block.

The JAX package packs the key into int31; the port packs it into int64, so
its budget is 63 bits. Where the JAX package returns a result, the port
returns the same ``(slid, order)``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def _bits(n: int) -> int:
    return max(int(n - 1).bit_length(), 1)


def sort_ids(lids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The generic sorted stream: a stable sort of ``lids [N]`` -> int64
    ``(slid, order)``."""
    slid, order = torch.sort(lids.reshape(-1).to(torch.int64), stable=True)
    return slid, order


class SortLayout(nn.Module):
    """The static part of a ``blocked_sort`` of ``[B, F]`` ids, and the sort.

    Columns are grouped by table range: ``G`` groups of ``c`` columns each,
    in offset order. The group offsets ``[G]`` and columns ``[G, c]`` are
    non-persistent buffers, so ``.to()`` moves them with the module that
    holds the layout. ``SortLayout.of(col_ranges)`` builds one, or returns
    None where the blocks would not be sorted as a whole.

    ``layout(rows)`` returns int64 ``(slid [B*F], order [B*F])`` with
    ``slid`` nondecreasing and ``slid == rows.reshape(-1)[order]``, or None
    where the key would need more than 63 bits; then ``sort_ids`` is the way.
    """

    def __init__(self, c: int, span: int, offsets, cols):
        super().__init__()
        self.c, self.span = c, span
        self.register_buffer("offsets", torch.tensor(offsets, dtype=torch.int64),
                             persistent=False)
        self.register_buffer("cols", torch.tensor(cols, dtype=torch.int64),
                             persistent=False)

    @classmethod
    def of(cls, col_ranges: Sequence[Tuple[int, int]]) -> Optional["SortLayout"]:
        """The layout of ``col_ranges[f] = (offset, vocab)``, or None for
        partially overlapping ranges or shared-table groups of unequal
        size."""
        groups: dict = {}
        for f, rng in enumerate(col_ranges):
            groups.setdefault((int(rng[0]), int(rng[1])), []).append(f)
        ranges = sorted(groups)
        for (o1, v1), (o2, _v2) in zip(ranges, ranges[1:]):
            if o1 + v1 > o2:
                return None
        sizes = {len(cols) for cols in groups.values()}
        if len(sizes) != 1:
            return None
        return cls(sizes.pop(), max(v for _o, v in ranges),
                   [o for o, _v in ranges], [groups[r] for r in ranges])

    def forward(self, rows: torch.Tensor) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        B, F = rows.shape
        c = self.c
        G = F // c
        idx_bits = _bits(B * c)
        if _bits(self.span) + idx_bits > 63:
            return None
        # blocks [G, c*B]: group g holds columns cols[g] (offset order); the
        # block-local index j = b*c + ci is the original flat index b*F + cols[g, ci]
        rel = (rows.to(torch.int64)[:, self.cols.reshape(-1)].reshape(B, G, c)
               - self.offsets[None, :, None])
        local = (torch.arange(B, dtype=torch.int64, device=rows.device)[:, None, None] * c
                 + torch.arange(c, dtype=torch.int64, device=rows.device)[None, None, :])
        keys = (rel << idx_bits) | local
        # keys are unique (they hold the index), so an unstable sort is exact
        skeys = torch.sort(keys.permute(1, 0, 2).reshape(G, -1), dim=1).values
        slid = (skeys >> idx_bits) + self.offsets[:, None]
        j = skeys & ((1 << idx_bits) - 1)
        order = (j // c) * F + torch.gather(self.cols, 1, j % c)
        return slid.reshape(-1), order.reshape(-1)


def blocked_sort(rows: torch.Tensor, col_ranges: Sequence[Tuple[int, int]],
                 ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Sort a ``[B, F]`` resolved-id matrix into one sorted stream.

    ``col_ranges[f] = (offset, vocab)`` is the table range of column f (the
    ids lie in it: the lookup clamps them). Returns ``SortLayout``'s
    ``(slid, order)``, or None where the layout does not allow it or the
    key would need more than 63 bits. A lookup site that sorts every step
    keeps its ``SortLayout`` instead, on the ids' device.
    """
    if rows.dim() == 1:
        rows = rows[:, None]
    if rows.dim() != 2:
        return None
    B, F = rows.shape
    if len(col_ranges) != F or B * F == 0:
        return None
    layout = SortLayout.of(col_ranges)
    return None if layout is None else layout.to(rows.device)(rows)
