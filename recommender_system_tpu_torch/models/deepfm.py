"""DeepFM: an FM and a deep tower over shared field embeddings
(counterpart of ``recommender_system_tpu/models/deepfm.py``).

The logit is ``linear + sum(bi_interaction(stacked)) + deep(concat(stacked
flattened, dense))``: ``UnifiedEmbedding`` gives the first-order term and
the ``[B, F, k]`` field embeddings from one gather.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.core import DNN
from ..layers.embedding import UnifiedEmbedding
from ..ops.dispatch import DeviceLike, resolve_device
from ..ops.interactions import bi_interaction
from ..utils.features import FeatureColumn, split_columns


class DeepFM(nn.Module):
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
        sparse, _, dense = split_columns(tuple(feature_columns))
        width = (sum(fc.embedding_dim for fc in sparse)
                 + sum(fc.dimension for fc in dense))
        self.deep = DNN(width, hidden_units, activation=activation,
                        dropout_rate=dropout_rate, output_dim=1, dtype=dnn_dtype,
                        device=device, generator=generator)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        emb, linear = self.unified(batch)
        stacked = emb.sparse_stack()  # [B, F, k]
        fm_logit = torch.sum(bi_interaction(stacked), dim=-1, keepdim=True)
        deep_in = stacked.reshape(stacked.shape[0], -1)
        if emb.dense is not None:
            deep_in = torch.cat([deep_in, emb.dense], dim=-1)
        return linear + fm_logit + self.deep(deep_in, generator=generator)
