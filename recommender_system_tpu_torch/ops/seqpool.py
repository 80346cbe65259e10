"""Masked variable-length sequence pooling and weighting
(counterpart of ``recommender_system_tpu/ops/seqpool.py``).

Every op is a static-shape masked reduction over ``[B, T, k]``; a mask is
``[B, T]`` bool.
"""
from __future__ import annotations

import torch

# the reference's padding score, finite: a row with no valid position gets
# uniform softmax weights, not NaN
NEG_INF = -(2.0 ** 32) + 1


def length_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """``[B]`` lengths -> ``[B, maxlen]`` bool mask (``tf.sequence_mask``)."""
    pos = torch.arange(maxlen, device=lengths.device)[None, :]
    return pos < lengths.reshape(-1, 1)


def id_mask(ids: torch.Tensor) -> torch.Tensor:
    """Mask-zero semantics: id 0 is padding."""
    return ids != 0


def sequence_pooling(seq_embeds: torch.Tensor, mask: torch.Tensor,
                     mode: str = "mean", eps: float = 1e-8) -> torch.Tensor:
    """Masked sum, mean or max over the time axis: ``[B, T, k]`` -> ``[B, k]``.
    Mean divides by the true length (+ ``eps``); max pads with ``NEG_INF``."""
    m = mask.to(seq_embeds.dtype)[..., None]  # [B, T, 1]
    if mode == "max":
        neg = (1.0 - m) * NEG_INF
        return torch.amax(seq_embeds + neg, dim=1)
    s = torch.sum(seq_embeds * m, dim=1)
    if mode == "sum":
        return s
    if mode == "mean":
        lengths = torch.sum(m, dim=1)  # [B, 1]
        return s / (lengths + eps)
    raise ValueError(f"mode must be sum|mean|max, got {mode}")


def weighted_sequence(seq_embeds: torch.Tensor, weights: torch.Tensor,
                      mask: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Per-position weights ``[B, T]``, softmax-normalised over the valid
    steps with ``normalize``, applied to ``[B, T, k]``."""
    if normalize:
        w = torch.softmax(torch.where(mask, weights, NEG_INF), dim=1)
    else:
        w = torch.where(mask, weights, 0.0)
    return seq_embeds * w[..., None]


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Softmax over ``axis`` with invalid positions scored ``NEG_INF``."""
    return torch.softmax(torch.where(mask, scores, NEG_INF), dim=axis)
