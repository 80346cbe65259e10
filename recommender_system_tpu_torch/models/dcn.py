"""DCN (Deep & Cross Network): explicit cross features + deep tower
(counterpart of ``recommender_system_tpu/models/dcn.py``).

``x0`` is the flattened embeddings and dense features; the cross stack and
the deep tower both read it, and ``head`` maps their concatenation to one
logit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.core import DNN, dense
from ..layers.embedding import EmbeddingCollection
from ..layers.interaction import CrossNet
from ..ops.dispatch import DeviceLike, resolve_device
from ..utils.features import FeatureColumn


class DCN(nn.Module):
    """``forward(batch) -> logits [B, 1]`` for a dict of tensors on the
    model's device. Runs on the card unless ``device`` names another;
    parameters are drawn from ``generator``."""

    def __init__(self, feature_columns: Sequence[FeatureColumn],
                 cross_layers: int = 6,
                 hidden_units: Sequence[int] = (256, 128, 64),
                 activation: str = "relu", dropout_rate: float = 0.0,
                 dnn_dtype: Optional[torch.dtype] = None, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.embeddings = EmbeddingCollection(feature_columns, device=device,
                                              generator=generator)
        width = self.embeddings.output_dim
        self.cross = CrossNet(width, cross_layers, device=device,
                              generator=generator)
        self.deep = DNN(width, hidden_units, activation=activation,
                        dropout_rate=dropout_rate, dtype=dnn_dtype,
                        device=device, generator=generator)
        self.head = dense(width + self.deep.out_features, 1, device=device,
                          generator=generator)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        """``generator`` draws the deep tower's dropout masks in train mode."""
        x0 = self.embeddings(batch).concat_flat()
        cross_out = self.cross(x0)
        deep_out = self.deep(x0, generator=generator)
        return self.head(torch.cat([cross_out, deep_out], dim=-1))
