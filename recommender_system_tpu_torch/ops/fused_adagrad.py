"""Fused sparse optimizers: the embedding backward is the optimizer update
(counterpart of ``recommender_system_tpu/ops/fused_adagrad.py``).

The lookup's cotangents ``ct [N, dim]`` and their rows ``lids [N]`` go
straight into one kernel of ``csrc/sparse_rows.cu`` that, per touched row,
sums the row's cotangents and applies the update in place:

- ``fused_adagrad_apply`` (``fused_adagrad_rows``): optax-exact Adagrad;
- ``fused_sgd_apply`` (``fused_sgd_rows``): ``param -= lr * G``, optax.sgd;
- ``fused_adam_apply`` (``fused_adam_rows``): lazy Adam, a row updated only
  where its summed gradient is non-zero in some column.

No dense table gradient is built and untouched rows are never read. Tables
are logical ``[rows, dim]``; the TPU's lane packing is not carried over.

The JAX kernels round the cotangents to bfloat16 before their one-hot
matrix product, a TPU matrix-unit artifact; here they stay float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import kernels
from .dispatch import use_kernel
from .stream_sort import sort_ids


def _dense_grad(table: torch.Tensor, lids: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """The dense scatter-added gradient ``G [rows, dim]`` in float32."""
    return torch.zeros_like(table).index_add_(0, lids, ct.to(table.dtype))


def fused_adagrad_ref(table: torch.Tensor, acc: torch.Tensor,
                      lids: torch.Tensor, ct: torch.Tensor, lr: float,
                      eps: float = 1e-7) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the dense scatter-added gradient ``G`` (duplicate ids
    summed before squaring), then ``acc + G*G`` and
    ``table - lr * G * rsqrt(acc + eps)`` where the new ``acc > 0``.
    Returns new ``(table, acc)``; untouched rows come back bitwise equal."""
    g = _dense_grad(table, lids, ct)
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
        if ct.shape[0] == 0:
            return table, acc
        slid, order = presorted if presorted is not None else sort_ids(lids)
        kernels.launch_fused_adagrad(table, acc, slid, order, ct, float(lr), float(eps))
    fused_adagrad_apply.launches += 1
    return table, acc


fused_adagrad_apply.launches = 0


def fused_sgd_ref(table: torch.Tensor, lids: torch.Tensor, ct: torch.Tensor,
                  lr: float) -> torch.Tensor:
    """Plain version: ``table - lr * G`` (``optax.sgd`` on the dense
    scatter-added gradient). Returns the new table; untouched rows come back
    bitwise equal."""
    return table - lr * _dense_grad(table, lids, ct)


def fused_sgd_apply(table: torch.Tensor, lids: torch.Tensor, ct: torch.Tensor, *,
                    lr: float,
                    presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    ) -> torch.Tensor:
    """In-place sparse SGD, ``table[row] -= lr * sum(ct of that row)``, on a
    float32 ``[rows, dim]`` table; returns it. Arguments as
    ``fused_adagrad_apply``'s. On CUDA tensors the kernel runs
    (``fused_sgd_apply.launches`` counts it); on CPU tensors,
    ``fused_sgd_ref``."""
    with torch.no_grad():
        if not use_kernel(table, lids, ct):
            table.copy_(fused_sgd_ref(table, lids, ct, lr))
            return table
        if ct.shape[0] == 0:
            return table
        slid, order = presorted if presorted is not None else sort_ids(lids)
        kernels.launch_fused_sgd(table, slid, order, ct, float(lr))
    fused_sgd_apply.launches += 1
    return table


fused_sgd_apply.launches = 0


def adam_bias_corrections(step: int, b1: float, b2: float) -> Tuple[float, float]:
    """The reciprocal bias corrections at time ``step + 1``,
    ``1 / (1 - b**t)``, in float32 as the JAX package's ``fused_adam_apply``
    computes them."""
    t = np.float32(step + 1)
    one = np.float32(1.0)
    return (float(one / (one - np.float32(b1) ** t)),
            float(one / (one - np.float32(b2) ** t)))


def fused_adam_ref(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                   lids: torch.Tensor, ct: torch.Tensor, lr: float, step: int,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: lazy Adam on the dense scatter-added gradient ``G``.
    A row is touched where ``G`` is non-zero in any of its columns; a
    touched row gets ``m = b1 m + (1-b1) G``, ``v = b2 v + (1-b2) G G`` and
    ``table - lr (m bc1) / (sqrt(v bc2) + eps)`` in every column, an
    untouched row keeps all three bitwise. Returns new ``(table, m, v)``."""
    g = _dense_grad(table, lids, ct)
    touched = (g != 0).any(dim=1, keepdim=True)
    bc1, bc2 = adam_bias_corrections(step, b1, b2)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    update = lr * (m_new * bc1) / (torch.sqrt(v_new * bc2) + eps)
    return (torch.where(touched, table - update, table),
            torch.where(touched, m_new, m),
            torch.where(touched, v_new, v))


def fused_adam_apply(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     lids: torch.Tensor, ct: torch.Tensor, *, lr: float, step: int,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """In-place lazy sparse Adam on a float32 ``[rows, dim]`` table and its
    moments ``m``, ``v`` of the same shape; returns them. ``step`` counts
    from 0 (bias corrections at ``step + 1``). Other arguments as
    ``fused_adagrad_apply``'s. On CUDA tensors the kernel runs
    (``fused_adam_apply.launches`` counts it); on CPU tensors,
    ``fused_adam_ref``."""
    with torch.no_grad():
        if not use_kernel(table, m, v, lids, ct):
            for t, new in zip((table, m, v),
                              fused_adam_ref(table, m, v, lids, ct, lr, step, b1, b2, eps)):
                t.copy_(new)
            return table, m, v
        if ct.shape[0] == 0:
            return table, m, v
        slid, order = presorted if presorted is not None else sort_ids(lids)
        bc1, bc2 = adam_bias_corrections(step, b1, b2)
        kernels.launch_fused_adam(table, m, v, slid, order, ct, lr=float(lr), b1=b1, b2=b2,
                                  eps=eps, bc1=bc1, bc2=bc2)
    fused_adam_apply.launches += 1
    return table, m, v


fused_adam_apply.launches = 0
