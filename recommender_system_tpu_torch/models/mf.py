"""Matrix factorization by masked gradient descent (counterpart of
``recommender_system_tpu/models/mf.py``).

``r ~= P Q^T`` over the observed (``r > 0``) entries: each step moves ``P``
and ``Q`` down the gradient of ``||mask * (R - P Q^T)||^2`` plus
``beta / 2`` times each row's squared norm weighted by the entries it takes
part in, in plain PyTorch f32 on the device (the card unless another is
named). ``P`` and ``Q`` start from ``np.random.default_rng(seed).random``,
drawn as the JAX package draws them. The loop stops where the loss moves by
less than 1e-10 or falls below 1e-3, reading it every step as the JAX loop
does.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops.dispatch import DeviceLike, resolve_device


def _loss(p: torch.Tensor, q: torch.Tensor, r: torch.Tensor, mask: torch.Tensor,
          beta: float) -> torch.Tensor:
    err = mask * (r - p @ q.T)
    # only the entries that take part are regularised
    reg = 0.5 * beta * (torch.sum((p * p).sum(1)[:, None] * mask)
                        + torch.sum((q * q).sum(1)[None, :] * mask))
    return torch.sum(err * err) + reg


def matrix_factorization(
    r: np.ndarray,
    latent_dim: int = 2,
    steps: int = 5000,
    lr: float = 0.0002,
    beta: float = 0.02,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, List[float]]:
    """Returns ``(P [n_users, k], Q [n_items, k], loss history)``, the loss
    after each step."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    r = torch.as_tensor(np.asarray(r, np.float32), device=device)
    mask = (r > 0).to(torch.float32)
    p = torch.as_tensor(rng.random((r.shape[0], latent_dim)), dtype=torch.float32,
                        device=device)
    q = torch.as_tensor(rng.random((r.shape[1], latent_dim)), dtype=torch.float32,
                        device=device)
    losses = []
    prev = None
    for _ in range(steps):
        pg, qg = p.requires_grad_(True), q.requires_grad_(True)
        gp, gq = torch.autograd.grad(_loss(pg, qg, r, mask, beta), (pg, qg))
        with torch.no_grad():
            p, q = p - lr * gp, q - lr * gq
            cur = float(_loss(p, q, r, mask, beta))
        losses.append(cur)
        if prev is not None and abs(prev - cur) < 1e-10:
            break
        if cur < 1e-3:
            break
        prev = cur
    return p.cpu().numpy(), q.cpu().numpy(), losses


def recommend(user_idx: int, p: np.ndarray, q: np.ndarray, consumed_mask,
              items: list, k: int, device: DeviceLike = None) -> list:
    """The ``k`` unseen items of the highest latent dot product, descending,
    ties by item order."""
    device = resolve_device(device)
    scores = torch.as_tensor(np.asarray(p[user_idx]), device=device) @ \
        torch.as_tensor(np.asarray(q), device=device).T
    unseen = ~torch.as_tensor(np.asarray(consumed_mask, bool), device=device)
    idx = torch.nonzero(unseen).reshape(-1)
    order = torch.sort(-scores[idx], stable=True).indices[:k]
    return [(items[i], float(v)) for i, v in zip(idx[order].cpu().tolist(),
                                                 scores[idx[order]].cpu().tolist())]
