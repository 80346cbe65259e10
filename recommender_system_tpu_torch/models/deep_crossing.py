"""DeepCrossing: the field embeddings and dense features, a stack of
residual units and a linear head (counterpart of
``recommender_system_tpu/models/deep_crossing.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.core import dense
from ..layers.embedding import EmbeddingCollection
from ..layers.interaction import ResBlock
from ..ops.dispatch import DeviceLike, resolve_device
from ..utils.features import FeatureColumn


class DeepCrossing(nn.Module):
    """``forward(batch, generator=None) -> logits [B, 1]`` for a dict of
    tensors on the model's device (``generator`` is accepted for the
    Trainer's call and unused: DeepCrossing has no dropout). Each of the
    ``num_res_blocks`` units ``res_{i}`` is ``ResBlock(hidden_units)``.
    Runs on the card unless ``device`` names another; parameters are drawn
    from ``generator``."""

    def __init__(self, feature_columns: Sequence[FeatureColumn],
                 hidden_units: Sequence[int] = (256, 128), num_res_blocks: int = 3, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.embeddings = EmbeddingCollection(feature_columns, device=device,
                                              generator=generator)
        width = self.embeddings.output_dim
        self.num_res_blocks = num_res_blocks
        for i in range(num_res_blocks):
            self.add_module(f"res_{i}", ResBlock(width, hidden_units, device=device,
                                                 generator=generator))
        self.head = dense(width, 1, device=device, generator=generator)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        x = self.embeddings(batch).concat_flat()
        for i in range(self.num_res_blocks):
            x = getattr(self, f"res_{i}")(x)
        return self.head(x)
