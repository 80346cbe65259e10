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

The step's scalars (``lr``, and Adam's reciprocal bias corrections) come
as host numbers (``lr``, Adam's ``step``) or as ``scalars``, a float32
tensor on the table's device holding ``(lr,)`` or ``(lr, bc1, bc2)``
(``adam_scalars``); the kernels read them from device memory, so a captured
CUDA graph of training steps reads each step's values from the buffer the
host fills before the replay. The plain versions take the same forms.

The JAX kernels round the cotangents to bfloat16 before their one-hot
matrix product, a TPU matrix-unit artifact; here they stay float32.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .dispatch import use_kernel
from .stream_sort import sort_ids


def step_scalars(values: Sequence[float], device: torch.device) -> torch.Tensor:
    """Host numbers as a float32 ``[n]`` tensor on ``device``; on a card one
    asynchronous copy from pinned memory, so no step waits for it."""
    host = torch.tensor([float(v) for v in values], dtype=torch.float32)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _hyper(table: torch.Tensor, scalars: Optional[torch.Tensor],
           host: Optional[Sequence[float]]) -> torch.Tensor:
    """The step's scalars on the table's device: ``scalars`` as given, or
    the host numbers ``host`` copied there."""
    if scalars is not None:
        return scalars
    if host is None:
        raise TypeError("give the step's scalars as host numbers (lr, and Adam's step) "
                        "or as the scalars tensor")
    return step_scalars(host, table.device)


def _dense_grad(table: torch.Tensor, lids: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """The dense scatter-added gradient ``G [rows, dim]`` in float32."""
    return torch.zeros_like(table).index_add_(0, lids, ct.to(table.dtype))


def fused_adagrad_ref(table: torch.Tensor, acc: torch.Tensor,
                      lids: torch.Tensor, ct: torch.Tensor, lr: Optional[float] = None,
                      eps: float = 1e-7, *, scalars: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the dense scatter-added gradient ``G`` (duplicate ids
    summed before squaring), then ``acc + G*G`` and
    ``table - lr * G * rsqrt(acc + eps)`` where the new ``acc > 0``, with
    ``lr`` a host number or ``scalars[0]``. Returns new ``(table, acc)``;
    untouched rows come back bitwise equal."""
    if scalars is not None:
        lr = scalars[0]
    g = _dense_grad(table, lids, ct)
    new_acc = acc + g * g
    inv = torch.where(new_acc > 0, torch.rsqrt(new_acc + eps), 0.0)
    return table - lr * g * inv, new_acc


def fused_adagrad_apply(table: torch.Tensor, acc: torch.Tensor,
                        lids: torch.Tensor, ct: torch.Tensor, *,
                        lr: Optional[float] = None, eps: float = 1e-7,
                        scalars: Optional[torch.Tensor] = None,
                        presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-place sparse Adagrad: updates ``table`` and ``acc`` (both float32
    ``[rows, dim]``) where they lie, as the JAX kernel's
    ``input_output_aliases`` does, and returns them.

    ``lids [N]`` are the rows of the cotangents ``ct [N, dim]`` (in range:
    the lookup clamps them); ``presorted`` is their sorted stream
    ``(slid, order)`` from ``blocked_sort``, else they are sorted here. The
    learning rate is ``lr`` or ``scalars`` (``[lr]`` on the table's
    device). On CUDA tensors the kernel runs (``fused_adagrad_apply.launches``
    counts it, and ``.long_launches`` the long path's pass 2, which every
    launch runs: a row of at least ``kernels.SPARSE_CHUNK`` positions is
    summed in chunks); on CPU tensors, ``fused_adagrad_ref``.
    """
    with torch.no_grad():
        hyper = _hyper(table, scalars, None if lr is None else (lr,))
        if not use_kernel(table, acc, lids, ct, hyper):
            new_table, new_acc = fused_adagrad_ref(table, acc, lids, ct, eps=eps,
                                                   scalars=hyper)
            table.copy_(new_table)
            acc.copy_(new_acc)
            return table, acc
        if ct.shape[0] == 0:
            return table, acc
        slid, order = presorted if presorted is not None else sort_ids(lids)
        scratch = kernels.sparse_rows_scratch(ct.shape[0], ct.shape[1], ct.device)
        kernels.launch_fused_adagrad(table, acc, slid, order, ct, hyper, float(eps), *scratch)
    fused_adagrad_apply.launches += 1
    fused_adagrad_apply.long_launches += 1
    return table, acc


fused_adagrad_apply.launches = 0
fused_adagrad_apply.long_launches = 0


def fused_sgd_ref(table: torch.Tensor, lids: torch.Tensor, ct: torch.Tensor,
                  lr: Optional[float] = None, *,
                  scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``table - lr * G`` (``optax.sgd`` on the dense
    scatter-added gradient), ``lr`` a host number or ``scalars[0]``.
    Returns the new table; untouched rows come back bitwise equal."""
    if scalars is not None:
        lr = scalars[0]
    return table - lr * _dense_grad(table, lids, ct)


def fused_sgd_apply(table: torch.Tensor, lids: torch.Tensor, ct: torch.Tensor, *,
                    lr: Optional[float] = None, scalars: Optional[torch.Tensor] = None,
                    presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    ) -> torch.Tensor:
    """In-place sparse SGD, ``table[row] -= lr * sum(ct of that row)``, on a
    float32 ``[rows, dim]`` table; returns it. Arguments as
    ``fused_adagrad_apply``'s. On CUDA tensors the kernel runs
    (``fused_sgd_apply.launches`` counts it, and ``.long_launches`` the
    long path's pass 2, as ``fused_adagrad_apply``'s); on CPU tensors,
    ``fused_sgd_ref``."""
    with torch.no_grad():
        hyper = _hyper(table, scalars, None if lr is None else (lr,))
        if not use_kernel(table, lids, ct, hyper):
            table.copy_(fused_sgd_ref(table, lids, ct, scalars=hyper))
            return table
        if ct.shape[0] == 0:
            return table
        slid, order = presorted if presorted is not None else sort_ids(lids)
        scratch = kernels.sparse_rows_scratch(ct.shape[0], ct.shape[1], ct.device)
        kernels.launch_fused_sgd(table, slid, order, ct, hyper, *scratch)
    fused_sgd_apply.launches += 1
    fused_sgd_apply.long_launches += 1
    return table


fused_sgd_apply.launches = 0
fused_sgd_apply.long_launches = 0


def adam_bias_corrections(step: int, b1: float, b2: float) -> Tuple[float, float]:
    """The reciprocal bias corrections at time ``step + 1``,
    ``1 / (1 - b**t)``, in float32 as the JAX package's ``fused_adam_apply``
    computes them."""
    t = np.float32(step + 1)
    one = np.float32(1.0)
    return (float(one / (one - np.float32(b1) ** t)),
            float(one / (one - np.float32(b2) ** t)))


def adam_scalars(lr: float, step: int, b1: float, b2: float) -> Tuple[float, float, float]:
    """Lazy Adam's scalars at ``step``, in the order its kernel reads them:
    ``(lr, bc1, bc2)``, the bias corrections reciprocal."""
    return (lr, *adam_bias_corrections(step, b1, b2))


def fused_adam_ref(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                   lids: torch.Tensor, ct: torch.Tensor, lr: Optional[float] = None,
                   step: Optional[int] = None, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, *, scalars: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: lazy Adam on the dense scatter-added gradient ``G``.
    A row is touched where ``G`` is non-zero in any of its columns; a
    touched row gets ``m = b1 m + (1-b1) G``, ``v = b2 v + (1-b2) G G`` and
    ``table - lr (m bc1) / (sqrt(v bc2) + eps)`` in every column, an
    untouched row keeps all three bitwise. ``lr``, ``bc1`` and ``bc2`` are
    ``adam_scalars(lr, step, b1, b2)`` or ``scalars``' three values.
    Returns new ``(table, m, v)``."""
    if scalars is not None:
        lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]
    else:
        bc1, bc2 = adam_bias_corrections(step, b1, b2)
    g = _dense_grad(table, lids, ct)
    touched = (g != 0).any(dim=1, keepdim=True)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    update = lr * (m_new * bc1) / (torch.sqrt(v_new * bc2) + eps)
    return (torch.where(touched, table - update, table),
            torch.where(touched, m_new, m),
            torch.where(touched, v_new, v))


def fused_adam_apply(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     lids: torch.Tensor, ct: torch.Tensor, *, lr: Optional[float] = None,
                     step: Optional[int] = None, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8, scalars: Optional[torch.Tensor] = None,
                     presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """In-place lazy sparse Adam on a float32 ``[rows, dim]`` table and its
    moments ``m``, ``v`` of the same shape; returns them. ``step`` counts
    from 0 (bias corrections at ``step + 1``); ``scalars`` (``[lr, bc1,
    bc2]`` on the table's device, ``adam_scalars``) replaces ``lr`` and
    ``step``. Other arguments as ``fused_adagrad_apply``'s. On CUDA tensors
    the kernel runs (``fused_adam_apply.launches`` counts it, and
    ``.long_launches`` the long path's pass 2, as ``fused_adagrad_apply``'s;
    a long row whose summed gradient is zero in every column keeps its
    param, m and v there too); on CPU tensors, ``fused_adam_ref``."""
    with torch.no_grad():
        hyper = _hyper(table, scalars, None if lr is None or step is None
                       else adam_scalars(lr, step, b1, b2))
        if not use_kernel(table, m, v, lids, ct, hyper):
            for t, new in zip((table, m, v), fused_adam_ref(table, m, v, lids, ct, b1=b1,
                                                            b2=b2, eps=eps, scalars=hyper)):
                t.copy_(new)
            return table, m, v
        if ct.shape[0] == 0:
            return table, m, v
        slid, order = presorted if presorted is not None else sort_ids(lids)
        scratch = kernels.sparse_rows_scratch(ct.shape[0], ct.shape[1], ct.device)
        kernels.launch_fused_adam(table, m, v, slid, order, ct, hyper, *scratch, b1=b1, b2=b2,
                                  eps=eps)
    fused_adam_apply.launches += 1
    fused_adam_apply.long_launches += 1
    return table, m, v


fused_adam_apply.launches = 0
fused_adam_apply.long_launches = 0
