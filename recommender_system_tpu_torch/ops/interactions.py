"""Plain PyTorch interaction ops (counterparts of
``recommender_system_tpu/ops/interactions.py``).

The pairwise ops take the pairs ``i < j`` in ``numpy.triu_indices`` order,
as the JAX package does, so that a pair's position (and PNN's outer-product
kernel slice) is the same in both packages. They gather the pairs with
``index_select`` along one axis (a ``[F, F]`` pair of axes flattened
first), whose backward is an ``index_add_``; the JAX package's advanced
indexing, ``x[:, row, col]``, would sort its indices in the backward on the
card, which took 45 % of FFM's step there (``PERF.md``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def fm_interaction(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Second-order FM term on a dense or one-hot input:
    ``0.5 * sum((x v)^2 - x^2 v^2, axis=-1)``.

    Args: x ``[B, D]``, v ``[D, k]``. Returns ``[B, 1]``.
    """
    xv = x @ v
    x2v2 = (x * x) @ (v * v)
    return 0.5 * torch.sum(xv * xv - x2v2, dim=-1, keepdim=True)


def bi_interaction(embeds: torch.Tensor) -> torch.Tensor:
    """NFM bi-interaction pooling over stacked field embeddings:
    ``0.5 * ((sum_f e_f)^2 - sum_f e_f^2)``, the row-sum over all pairwise
    element-wise products.

    Args: embeds ``[B, F, k]``. Returns ``[B, k]``.
    """
    sum_sq = torch.square(torch.sum(embeds, dim=1))
    sq_sum = torch.sum(torch.square(embeds), dim=1)
    return 0.5 * (sum_sq - sq_sum)


@functools.lru_cache(maxsize=None)
def _pair_indices(num_fields: int, device: torch.device):
    """The pairs ``i < j`` of ``num_fields`` fields, rows and columns as
    int64 tensors on ``device``; made once, so that a training step copies
    nothing from the host (a copy from pageable memory would wait for the
    card). Made outside inference mode, so that a first call under
    ``torch.inference_mode`` (a Scorer's) leaves tensors that autograd can
    still use."""
    row, col = np.triu_indices(num_fields, k=1)
    with torch.inference_mode(False):
        return (torch.as_tensor(row, dtype=torch.int64, device=device),
                torch.as_tensor(col, dtype=torch.int64, device=device))


@functools.lru_cache(maxsize=None)
def _pair_cells(num_fields: int, device: torch.device):
    """The cells ``(i, j)`` and ``(j, i)`` of the pairs ``i < j`` in a
    flattened ``[F, F]`` pair of axes, as int64 tensors on ``device``."""
    row, col = _pair_indices(num_fields, device)
    with torch.inference_mode(False):
        return row * num_fields + col, col * num_fields + row


def pairwise_inner(embeds: torch.Tensor) -> torch.Tensor:
    """All-pairs inner products ``<e_i, e_j>``, ``i < j`` (PNN's IPNN): one
    batched gram product ``e @ e^T``, its upper triangle taken out.

    Args: embeds ``[B, F, k]``. Returns ``[B, F(F-1)/2]``.
    """
    B, F, _ = embeds.shape
    gram = torch.bmm(embeds, embeds.transpose(1, 2)).reshape(B, F * F)
    return gram.index_select(1, _pair_cells(F, embeds.device)[0])


def pairwise_product(embeds: torch.Tensor) -> torch.Tensor:
    """All-pairs element-wise products ``e_i * e_j``, ``i < j``, kept as a
    sequence (AFM).

    Args: embeds ``[B, F, k]``. Returns ``[B, P, k]``, P = F(F-1)/2.
    """
    row, col = _pair_indices(embeds.shape[1], embeds.device)
    return embeds.index_select(1, row) * embeds.index_select(1, col)


def pairwise_outer(embeds: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """PNN's kernel-weighted outer products,
    ``out[b, p] = sum_ij e_row[b, p, i] W[j, p, i] e_col[b, p, j]``.

    The contraction over ``i`` comes first (``[B, P, k]``), then the dot
    with ``e_col``, so no ``[B, P, k, k]`` tensor is formed: at PNN's
    ``mode="both"`` with FGCNN (P = 3,403) and a batch of 8,192 it would
    take 7 GB.

    Args: embeds ``[B, F, k]``, kernel ``[k, P, k]`` (the JAX package's
    layout). Returns ``[B, P]``.
    """
    row, col = _pair_indices(embeds.shape[1], embeds.device)
    p = embeds.index_select(1, row)  # [B, P, k]
    q = embeds.index_select(1, col)  # [B, P, k]
    pw = torch.einsum("bpi,jpi->bpj", p, kernel)  # [B, P, k]
    return torch.sum(pw * q, dim=-1)


def ffm_interaction(field_embeds: torch.Tensor) -> torch.Tensor:
    """Field-aware FM second-order term, ``sum_{i<j} <v_{i,j}, v_{j,i}>``,
    where ``field_embeds[b, i, j]`` is feature i's factor vector toward
    field j.

    Args: field_embeds ``[B, F, F, k]``. Returns ``[B, 1]``.
    """
    B, F, _, k = field_embeds.shape
    ij, ji = _pair_cells(F, field_embeds.device)
    cells = field_embeds.reshape(B, F * F, k)
    vi = cells.index_select(1, ij)  # feature i toward field j
    vj = cells.index_select(1, ji)  # feature j toward field i
    return torch.sum(vi * vj, dim=(-1, -2))[:, None]


def cross_network(x0: torch.Tensor, weights: torch.Tensor,
                  biases: torch.Tensor) -> torch.Tensor:
    """DCN cross network: ``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l``.

    Rank-1 cross per layer, ``x_l . w_l`` a per-row scalar. The plain version
    of the ``cross_fused`` kernel (``ops/kernels.py``).

    Args: x0 ``[B, D]``, weights ``[L, D]``, biases ``[L, D]``. Returns ``[B, D]``.
    """
    x = x0
    for w, b in zip(weights, biases):
        x = x0 * (x @ w)[:, None] + b + x
    return x
