"""Logistic regression with minibatch gradient descent and three stop rules
(counterpart of ``recommender_system_tpu/models/lr.py``).

Plain PyTorch on the device (the card unless another is named): ``theta``
in f32, the cost ``mean(softplus(z) - y z)`` of ``z = X theta`` over the
whole set, and its gradient on each minibatch. The minibatches come from
``np.random.default_rng(seed)`` exactly as the JAX package draws them (a
permutation walked in steps of ``batch_size``, a new one where fewer than
``batch_size`` rows are left), so both packages see the same batches. The
loop stops after ``thresh`` steps (``STOP_ITER``), where the cost moves by
less than ``thresh`` (``STOP_COST``), or where the minibatch gradient's
norm falls below ``thresh`` (``STOP_GRAD``). It reads the cost every step,
as the JAX loop does.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.dispatch import DeviceLike, resolve_device

STOP_ITER = "iter"
STOP_COST = "cost"
STOP_GRAD = "grad"


def _with_intercept(X: np.ndarray) -> np.ndarray:
    return np.concatenate([np.ones((len(X), 1), X.dtype), X], axis=1)


def _cost(theta: torch.Tensor, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logits = X @ theta
    return torch.mean(F.softplus(logits) - y * logits)


def fit_logistic_regression(
    X: np.ndarray,
    y: np.ndarray,
    batch_size: int = 16,
    lr: float = 0.001,
    stop_type: str = STOP_ITER,
    thresh: float = 5000,
    add_intercept: bool = True,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, List[float]]:
    """Returns ``(theta, cost history)``: the cost before the first step and
    after each one."""
    device = resolve_device(device)
    X = np.asarray(X)
    if add_intercept:
        X = _with_intercept(X)
    X = torch.as_tensor(np.asarray(X, np.float32), device=device)
    y = torch.as_tensor(np.asarray(y, np.float32), device=device)
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    theta = torch.zeros(X.shape[1], dtype=torch.float32, device=device)
    costs = [float(_cost(theta, X, y))]
    i, k = 0, 0
    perm = rng.permutation(n)
    while True:
        sel = perm[k: k + batch_size]
        if len(sel) < batch_size:
            perm = rng.permutation(n)
            k = 0
            sel = perm[:batch_size]
        k += batch_size
        rows = torch.as_tensor(sel, device=device)
        t = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_cost(t, X[rows], y[rows]), t)
        theta = theta - lr * g
        costs.append(float(_cost(theta, X, y)))
        i += 1
        if stop_type == STOP_ITER and i >= thresh:
            break
        if stop_type == STOP_COST and abs(costs[-1] - costs[-2]) < thresh:
            break
        if stop_type == STOP_GRAD and float(torch.linalg.norm(g)) < thresh:
            break
    return theta.cpu().numpy(), costs


def predict_proba(theta: np.ndarray, X: np.ndarray, add_intercept: bool = True,
                  device: DeviceLike = None) -> np.ndarray:
    """``sigmoid(X theta)`` on the device, as a numpy array."""
    device = resolve_device(device)
    X = np.asarray(X)
    if add_intercept:
        X = _with_intercept(X)
    z = torch.as_tensor(X, device=device) @ torch.as_tensor(np.asarray(theta), device=device)
    return torch.sigmoid(z).cpu().numpy()
