"""Parametric interaction modules (counterparts of
``recommender_system_tpu/layers/interaction.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import cross_fused


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
