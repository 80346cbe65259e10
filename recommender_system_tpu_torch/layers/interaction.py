"""Parametric interaction modules (counterparts of
``recommender_system_tpu/layers/interaction.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.dispatch import DeviceLike, resolve_device
from ..ops.kernels import cross_fused, fm_fused


class FMLayer(nn.Module):
    """Full FM, first and second order, on a dense or one-hot input
    ``[B, D]``: ``w0 + x.w1 + 0.5 sum((x v)^2 - x^2 v^2)`` -> the raw logit
    ``[B, 1]``, through the ``fm_fused`` kernel on CUDA (its plain version
    on the CPU).

    Parameters ``w0 [1]`` (zeros), ``w1 [D, 1]`` and ``v [D, factor_dim]``
    (both ``normal(0, init_std)``, drawn from ``generator`` in that order).
    ``use_pallas`` is accepted for the JAX package's signature and ignored:
    the kernel always runs on the card. Runs on the card unless ``device``
    names another."""

    def __init__(self, in_features: int, factor_dim: int, init_std: float = 0.05,
                 use_pallas: Optional[bool] = None, *, device: DeviceLike = None,
                 generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.w0 = nn.Parameter(torch.zeros(1, device=device))
        self.w1 = nn.Parameter(
            (torch.randn(in_features, 1, generator=generator, device=generator.device)
             * init_std).to(device))
        self.v = nn.Parameter(
            (torch.randn(in_features, factor_dim, generator=generator,
                         device=generator.device) * init_std).to(device))

    def forward(self, x):
        return fm_fused(x, self.w1, self.v) + self.w0


class CrossNet(nn.Module):
    """DCN cross network stack: the L-layer recurrence in one ``cross_fused``
    kernel launch on CUDA. Parameters ``weights`` and ``biases`` are
    ``[L, D]``, drawn as ``normal(0, init_std)``."""

    def __init__(self, in_features: int, num_layers: int,
                 init_std: float = 0.05, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        shape = (num_layers, in_features)
        self.weights = nn.Parameter(
            (torch.randn(shape, generator=generator, device=generator.device)
             * init_std).to(device))
        self.biases = nn.Parameter(
            (torch.randn(shape, generator=generator, device=generator.device)
             * init_std).to(device))

    def forward(self, x):
        return cross_fused(x, self.weights, self.biases)
