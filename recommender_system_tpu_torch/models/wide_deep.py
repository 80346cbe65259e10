"""Wide&Deep: a linear (wide) memorisation term and a DNN (deep) over the
field embeddings (counterpart of ``recommender_system_tpu/models/wide_deep.py``).

The wide term is ``UnifiedEmbedding``'s linear logit (each id's weight is
the last column of its ``table_d{d+1}`` row), the deep term a tower over
the flattened embeddings and dense features; the logit is their mean,
``0.5 * (wide + deep)``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.core import DNN
from ..layers.embedding import UnifiedEmbedding
from ..ops.dispatch import DeviceLike, resolve_device
from ..utils.features import FeatureColumn, split_columns


class WideDeep(nn.Module):
    """``forward(batch, generator=None) -> logits [B, 1]`` for a dict of
    tensors on the model's device; ``generator`` draws the deep tower's
    dropout masks in train mode. Runs on the card unless ``device`` names
    another; parameters are drawn from ``generator``. ``dnn_dtype`` is None
    (float32) or ``torch.bfloat16`` for the deep tower's hidden layers."""

    def __init__(self, feature_columns: Sequence[FeatureColumn],
                 hidden_units: Sequence[int] = (256, 128, 64),
                 activation: str = "relu", dropout_rate: float = 0.0,
                 dnn_dtype: Optional[torch.dtype] = None, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.unified = UnifiedEmbedding(feature_columns, device=device,
                                        generator=generator)
        # concat_flat()'s width: the d-wide embeddings (the table rows are
        # d+1 wide) and the dense columns
        sparse, varlen, dense = split_columns(tuple(feature_columns))
        width = (sum(fc.embedding_dim for fc in (*sparse, *varlen))
                 + sum(fc.dimension for fc in dense))
        self.deep = DNN(width, hidden_units, activation=activation,
                        dropout_rate=dropout_rate, output_dim=1, dtype=dnn_dtype,
                        device=device, generator=generator)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        emb, wide = self.unified(batch)
        deep = self.deep(emb.concat_flat(), generator=generator)
        return 0.5 * (wide + deep)
