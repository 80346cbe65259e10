"""Collaborative filtering: ItemCF and UserCF over pairwise similarity
matrices (counterpart of ``recommender_system_tpu/models/cf.py``).

The similarities are computed with torch in float64 on the device (the
card unless another is named): Euclidean distances from broadcast squared
norms and one Gram product, Pearson correlations from one Gram product of
the centred rows. They come back as numpy arrays, as the JAX package's.

Recommendations rank candidates by score, descending; ties keep the lower
index first (a stable sort), as the JAX package's ``sorted`` does. Scores
that differ from the JAX package's by float64 rounding (within 1e-12) may
therefore come out in the other order where two of them lie that close.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.dispatch import DeviceLike, resolve_device


def _on_device(matrix, device: DeviceLike) -> torch.Tensor:
    return torch.as_tensor(np.asarray(matrix, np.float64), device=resolve_device(device))


def _euclidean(m: torch.Tensor) -> torch.Tensor:
    sq = (m * m).sum(1)
    return torch.sqrt(torch.clamp(sq[:, None] + sq[None, :] - 2 * m @ m.T, min=0.0))


def _pearson(m: torch.Tensor) -> torch.Tensor:
    centered = m - m.mean(1, keepdim=True)
    cov = centered @ centered.T
    std = torch.sqrt((centered * centered).sum(1))
    denom = std[:, None] * std[None, :]
    return torch.where(denom > 0, cov / torch.where(denom > 0, denom, 1.0), 0.0)


def euclidean_sim(matrix, device: DeviceLike = None) -> np.ndarray:
    """Pairwise Euclidean distances between rows (lower = more similar)."""
    return _euclidean(_on_device(matrix, device)).cpu().numpy()


def pearson_sim(matrix, device: DeviceLike = None) -> np.ndarray:
    """Pairwise Pearson correlation between rows (higher = more similar;
    0 where a row is constant)."""
    return _pearson(_on_device(matrix, device)).cpu().numpy()


def _sim(m: torch.Tensor, t: str) -> torch.Tensor:
    if t == "euc":
        return _euclidean(m)
    if t == "pea":
        return _pearson(m)
    raise ValueError("t must be 'euc' or 'pea'")


def top_k(candidates: Sequence[Tuple], k: int) -> List:
    """Top-k ``(name, score)`` pairs by score, descending, ties in their
    given order."""
    return sorted(candidates, key=lambda c: -c[1])[:k]


def _ranked(names: list, score: torch.Tensor, keep: torch.Tensor, k: int) -> List:
    """The ``k`` best ``(name, score)`` among the kept positions: score
    descending, ties by position (a stable sort)."""
    idx = torch.nonzero(keep).reshape(-1)
    order = torch.sort(-score[idx], stable=True).indices[:k]
    picked = idx[order].cpu().tolist()
    values = score[idx[order]].cpu().tolist()
    return [(names[i], v) for i, v in zip(picked, values)]


class ItemCF:
    """Item-based CF: recommend the unseen items most similar to the ones
    the user consumed (by mean distance for ``"euc"``, mean correlation for
    ``"pea"``)."""

    def __init__(self, users: list, items: list, matrix, t: str = "euc",
                 device: DeviceLike = None):
        self.users, self.items = users, items
        self.matrix = _on_device(matrix, device)
        self.t = t
        self.item_sim = _sim(self.matrix.T, t)

    def recommend(self, user, k: int) -> List:
        u = self.users.index(user)
        consumed = self.matrix[u] > 0
        score = self.item_sim[:, consumed].mean(1)
        if self.t == "euc":  # distance to the consumed set; smaller = better
            score = -score
        return _ranked(self.items, score, ~consumed, k)


class UserCF:
    """User-based CF: score the unseen items by the ``k1`` most similar
    users' interactions (weighted by 1 / distance for ``"euc"``, by the
    correlation for ``"pea"``)."""

    def __init__(self, users: list, items: list, matrix, t: str = "euc",
                 device: DeviceLike = None):
        self.users, self.items = users, items
        self.matrix = _on_device(matrix, device)
        self.t = t
        self.user_sim = _sim(self.matrix, t)

    def recommend(self, user, k1: int, k2: int) -> List:
        u = self.users.index(user)
        n = len(self.users)
        sim = self.user_sim[u]
        weight = 1.0 / torch.clamp(sim, min=1e-12) if self.t == "euc" else sim
        others = torch.arange(n, device=sim.device) != u
        idx = torch.nonzero(others).reshape(-1)
        order = torch.sort(-weight[idx], stable=True).indices[:k1]
        neighbors, w = idx[order], weight[idx[order]]
        score = torch.zeros(len(self.items), dtype=torch.float64, device=sim.device)
        for j in range(neighbors.shape[0]):  # in neighbour order, as the JAX loop sums
            score = score + self.matrix[neighbors[j]] * w[j]
        return _ranked(self.items, score, self.matrix[u] == 0, k2)
