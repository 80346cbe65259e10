"""Losses (counterpart of ``recommender_system_tpu/training/losses.py``;
binary cross entropy only so far)."""
from __future__ import annotations

from typing import Optional

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable binary cross entropy from logits (mean scalar);
    with ``weights``, the weighted sum over ``max(sum(weights), 1)``."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    # softplus as log(exp(x) + 1), as jax.nn.softplus computes it
    per = torch.logaddexp(logits, torch.zeros_like(logits)) - labels * logits
    if weights is not None:
        w = weights.reshape(-1).to(logits.dtype)
        return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(per)
