"""Plain PyTorch interaction ops (counterparts of
``recommender_system_tpu/ops/interactions.py``)."""
from __future__ import annotations

import torch


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
