"""Losses (counterpart of ``recommender_system_tpu/training/losses.py``:
binary cross entropy so far; and ``default_loss``, the JAX package's
``Trainer`` default from ``training/harness.py``, with ``logits_of``, how
``Trainer.predict`` and ``Scorer`` read a model's outputs)."""
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


def logits_of(outputs) -> torch.Tensor:
    """A model's logits from its outputs, as the JAX package's ``predict``
    and ``Scorer`` take them: the first element of a tuple (an auxiliary
    loss dropped), per-task logits concatenated on the last axis."""
    if isinstance(outputs, tuple):
        outputs = outputs[0]
    if isinstance(outputs, list):
        outputs = torch.cat(outputs, dim=-1)
    return outputs


def default_loss(outputs, labels: torch.Tensor, batch=None) -> torch.Tensor:
    """The ``Trainer``'s loss of a model's outputs: a ``(logits, aux)``
    tuple gives ``bce + aux`` (DIEN's auxiliary loss); a list of per-task
    logits needs ``[B, T]`` labels and gives the mean of the per-task BCEs;
    anything else is one logit per row and gives plain BCE. ``batch`` is
    unused (a custom ``loss_fn(outputs, labels, batch)`` may read it)."""
    if isinstance(outputs, tuple):
        logits, aux = outputs
        return bce_with_logits(logits, labels) + aux
    if isinstance(outputs, list):
        labels = torch.as_tensor(labels)
        if labels.dim() != 2 or labels.shape[-1] != len(outputs):
            raise ValueError(
                f"multi-task model with {len(outputs)} outputs needs labels "
                f"of shape [B, {len(outputs)}], got {tuple(labels.shape)}")
        total = 0.0
        for t, logit in enumerate(outputs):
            total = total + bce_with_logits(logit, labels[..., t])
        return total / len(outputs)
    return bce_with_logits(outputs, labels)
