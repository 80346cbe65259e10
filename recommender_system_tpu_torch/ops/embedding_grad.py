"""The embedding lookup's backward as a sorted scatter-add
(counterpart of ``recommender_system_tpu/ops/embedding_grad.py``).

``take_fast(table, rows)`` is the row gather whose backward sorts the ids
(or takes them presorted) and runs ``scatter_add_sorted``: the
``scatter_add_rows`` kernel of ``csrc/sparse_rows.cu`` into a zero-filled
``[rows, dim]`` gradient. Without it the backward of ``table[rows]`` would
be PyTorch's own ``index_put_``.
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


def scatter_add_sorted(slid: torch.Tensor, order: torch.Tensor,
                       ct: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Dense ``[num_rows, dim]`` float32 sum of the cotangents ``ct [N, dim]``
    by row, from the sorted stream ``(slid, order)`` (``slid == lids[order]``).

    On CUDA tensors the kernel runs (``scatter_add_sorted.launches`` counts
    it); on CPU tensors, ``scatter_add_dense_ref``."""
    if not use_kernel(slid, order, ct):
        return scatter_add_dense_ref(slid, ct[order], num_rows)
    out = torch.zeros(num_rows, ct.shape[1], dtype=torch.float32, device=ct.device)
    kernels.launch_scatter_add(out, slid, order, ct)
    scatter_add_sorted.launches += 1
    return out


scatter_add_sorted.launches = 0


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
