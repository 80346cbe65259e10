"""Plain PyTorch interaction ops (counterparts of
``recommender_system_tpu/ops/interactions.py``)."""
from __future__ import annotations

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
