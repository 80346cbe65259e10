"""The embedding lookup's backward as a sorted scatter-add
(counterpart of ``recommender_system_tpu/ops/embedding_grad.py``).

``take_fast(table, rows)`` is the row gather whose backward sorts the ids
(or takes them presorted) and runs ``scatter_add_sorted``: the
``scatter_add_rows`` kernel of ``csrc/sparse_rows.cu`` into a zero-filled
``[rows, dim]`` gradient. Without it the backward of ``table[rows]`` would
be PyTorch's own ``index_put_``.

``scatter_add_chunked_ref`` is the kernel's sum in the kernel's order, in
plain PyTorch: what the card holds ``scatter_add_rows`` to bitwise, and
what ``fused_adagrad_rows`` sums before its update.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernels
from .dispatch import use_kernel
from .stream_sort import sort_ids


def scatter_add_dense_ref(ids: torch.Tensor, grads: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """Plain version: ``zeros(num_rows, d).index_add_(0, ids, grads)`` in
    float32."""
    out = torch.zeros(num_rows, grads.shape[-1], dtype=torch.float32,
                      device=grads.device)
    return out.index_add_(0, ids, grads.to(torch.float32))


def scatter_add_chunked_ref(slid: torch.Tensor, order: torch.Tensor,
                            ct: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``scatter_add_dense_ref``'s sums from the sorted stream ``(slid,
    order)``, added in ``scatter_add_rows``' order, float32 ``[num_rows,
    dim]``:

    - a segment (a row's positions) shorter than ``SPARSE_CHUNK``: its
      cotangents in stream order, from 0;
    - a longer one is cut at the multiples of ``SPARSE_CHUNK`` into pieces,
      each summed so; share ``q`` of ``SPARSE_SHARES`` (8) adds the pieces
      ``q, q + 8, ...`` in order from 0, and the row's sum is
      ``((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7))``.
    """
    chunk, shares = kernels.SPARSE_CHUNK, kernels.SPARSE_SHARES
    n, dim = slid.shape[0], ct.shape[1]
    out = torch.zeros(num_rows, dim, dtype=torch.float32, device=ct.device)
    if n == 0:
        return out
    vals = ct.to(torch.float32)[order]
    first = torch.ones(n, dtype=torch.bool, device=slid.device)
    first[1:] = slid[1:] != slid[:-1]
    seg_of = torch.cumsum(first, 0) - 1
    seg_start = first.nonzero().squeeze(1)
    seg_len = torch.diff(seg_start, append=seg_start.new_tensor([n]))
    is_long = seg_len >= chunk
    # pieces: every segment start, and the multiples of the chunk inside a
    # long segment
    cut = first.clone()
    multiples = torch.arange(chunk, max(n, chunk), chunk, device=slid.device)
    cut[multiples[is_long[seg_of[multiples]]]] = True
    piece_start = cut.nonzero().squeeze(1)
    piece_len = torch.diff(piece_start, append=piece_start.new_tensor([n]))
    sums = torch.zeros(piece_start.numel(), dim, dtype=torch.float32, device=ct.device)
    for i in range(int(piece_len.max())):
        live = piece_len > i
        sums[live] = sums[live] + vals[piece_start[live] + i]
    piece_seg = seg_of[piece_start]
    short = ~is_long[piece_seg]
    out[slid[piece_start[short]]] = sums[short]
    for seg in is_long.nonzero().squeeze(1).tolist():
        pieces = sums[piece_seg == seg]
        pad = -pieces.shape[0] % shares
        pieces = torch.cat([pieces, pieces.new_zeros(pad, dim)]).view(-1, shares, dim)
        acc = torch.zeros(shares, dim, dtype=torch.float32, device=ct.device)
        for block in pieces:
            acc = acc + block
        out[slid[seg_start[seg]]] = (((acc[0] + acc[1]) + (acc[2] + acc[3]))
                                     + ((acc[4] + acc[5]) + (acc[6] + acc[7])))
    return out


def scatter_add_sorted(slid: torch.Tensor, order: torch.Tensor,
                       ct: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Dense ``[num_rows, dim]`` float32 sum of the cotangents ``ct [N, dim]``
    by row, from the sorted stream ``(slid, order)`` (``slid == lids[order]``).

    On CUDA tensors the kernel runs (``scatter_add_sorted.launches`` counts
    it, and ``.long_launches`` the long path's pass 2, which every launch
    runs); on CPU tensors, ``scatter_add_dense_ref``."""
    if not use_kernel(slid, order, ct):
        return scatter_add_dense_ref(slid, ct[order], num_rows)
    out = torch.zeros(num_rows, ct.shape[1], dtype=torch.float32, device=ct.device)
    scratch = kernels.sparse_rows_scratch(ct.shape[0], ct.shape[1], ct.device)
    kernels.launch_scatter_add(out, slid, order, ct, *scratch)
    scatter_add_sorted.launches += 1
    scatter_add_sorted.long_launches += 1
    return out


scatter_add_sorted.launches = 0
scatter_add_sorted.long_launches = 0


class _TakeFast(torch.autograd.Function):
    """Forward: the row gather. Backward: the sorted scatter-add."""

    @staticmethod
    def forward(ctx, table, rows, slid, order):
        ctx.save_for_backward(rows, slid, order)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, rows)

    @staticmethod
    def backward(ctx, grad):
        rows, slid, order = ctx.saved_tensors
        if slid is None:
            slid, order = sort_ids(rows)
        dtable = scatter_add_sorted(slid, order, grad.contiguous(), ctx.num_rows)
        return dtable, None, None, None


def take_fast(table: torch.Tensor, rows: torch.Tensor,
              presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              ) -> torch.Tensor:
    """``table[rows]`` for ``rows [N]`` -> ``[N, dim]``, whose backward is
    ``scatter_add_sorted`` over ``presorted`` (the sorted stream of
    ``rows``) or over a stable sort of ``rows``."""
    slid, order = presorted if presorted is not None else (None, None)
    return _TakeFast.apply(table, rows, slid, order)
