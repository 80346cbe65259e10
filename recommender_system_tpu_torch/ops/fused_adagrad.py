"""Fused sparse Adagrad: the embedding backward is the optimizer update
(counterpart of ``recommender_system_tpu/ops/fused_adagrad.py``).

The lookup's cotangents ``ct [N, dim]`` and their rows ``lids [N]`` go
straight into one kernel (``fused_adagrad_rows`` in ``csrc/sparse_rows.cu``)
that, per touched row, sums the row's cotangents and applies optax-exact
Adagrad in place. No dense table gradient is built and untouched rows are
never read. Tables are logical ``[rows, dim]``; the TPU's lane packing is
not carried over.

The JAX kernel rounds the cotangents to bfloat16 before its one-hot matrix
product, a TPU matrix-unit artifact; here they stay float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernels
from .dispatch import use_kernel
from .stream_sort import sort_ids


def fused_adagrad_ref(table: torch.Tensor, acc: torch.Tensor,
                      lids: torch.Tensor, ct: torch.Tensor, lr: float,
                      eps: float = 1e-7) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the dense scatter-added gradient ``G`` (duplicate ids
    summed before squaring), then ``acc + G*G`` and
    ``table - lr * G * rsqrt(acc + eps)`` where the new ``acc > 0``.
    Returns new ``(table, acc)``; untouched rows come back bitwise equal."""
    g = torch.zeros_like(table).index_add_(0, lids, ct.to(table.dtype))
    new_acc = acc + g * g
    inv = torch.where(new_acc > 0, torch.rsqrt(new_acc + eps), 0.0)
    return table - lr * g * inv, new_acc


def fused_adagrad_apply(table: torch.Tensor, acc: torch.Tensor,
                        lids: torch.Tensor, ct: torch.Tensor, *, lr: float,
                        eps: float = 1e-7,
                        presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-place sparse Adagrad: updates ``table`` and ``acc`` (both float32
    ``[rows, dim]``) where they lie, as the JAX kernel's
    ``input_output_aliases`` does, and returns them.

    ``lids [N]`` are the rows of the cotangents ``ct [N, dim]`` (in range:
    the lookup clamps them); ``presorted`` is their sorted stream
    ``(slid, order)`` from ``blocked_sort``, else they are sorted here. On
    CUDA tensors the kernel runs (``fused_adagrad_apply.launches`` counts
    it); on CPU tensors, ``fused_adagrad_ref``.
    """
    with torch.no_grad():
        if not use_kernel(table, acc, lids, ct):
            new_table, new_acc = fused_adagrad_ref(table, acc, lids, ct, lr, eps)
            table.copy_(new_table)
            acc.copy_(new_acc)
            return table, acc
        slid, order = presorted if presorted is not None else sort_ids(lids)
        kernels.launch_fused_adagrad(table, acc, slid, order, ct, float(lr), float(eps))
    fused_adagrad_apply.launches += 1
    return table, acc


fused_adagrad_apply.launches = 0
