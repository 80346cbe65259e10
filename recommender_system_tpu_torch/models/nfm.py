"""NFM (Neural Factorization Machine): bi-interaction pooling and a deep
tower (counterpart of ``recommender_system_tpu/models/nfm.py``).

The field embeddings are pooled by ``bi_interaction`` to ``[B, k]``, the
dense features appended, a BatchNorm (Flax's, momentum 0.9) normalises the
result and a DNN maps it to one logit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.core import DNN, BatchNorm
from ..layers.embedding import EmbeddingCollection
from ..ops.dispatch import DeviceLike, resolve_device
from ..ops.interactions import bi_interaction
from ..utils.features import FeatureColumn, split_columns


class NFM(nn.Module):
    """``forward(batch, generator=None) -> logits [B, 1]`` for a dict of
    tensors on the model's device; ``generator`` draws the deep tower's
    dropout masks in train mode. In train mode the BatchNorm normalises with
    the batch and moves its running statistics. Runs on the card unless
    ``device`` names another; parameters are drawn from ``generator``.
    ``dnn_dtype`` is None (float32) or ``torch.bfloat16`` for the deep
    tower's hidden layers."""

    def __init__(self, feature_columns: Sequence[FeatureColumn],
                 hidden_units: Sequence[int] = (256, 128, 64),
                 activation: str = "relu", dropout_rate: float = 0.0,
                 dnn_dtype: Optional[torch.dtype] = None, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.embeddings = EmbeddingCollection(feature_columns, device=device,
                                              generator=generator)
        sparse, _, dense = split_columns(tuple(feature_columns))
        width = sparse[0].embedding_dim + sum(fc.dimension for fc in dense)
        self.bn = BatchNorm(width, device=device)
        self.deep = DNN(width, hidden_units, activation=activation,
                        dropout_rate=dropout_rate, output_dim=1, dtype=dnn_dtype,
                        device=device, generator=generator)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        emb = self.embeddings(batch)
        pooled = bi_interaction(emb.sparse_stack())  # [B, k]
        if emb.dense is not None:
            pooled = torch.cat([pooled, emb.dense], dim=-1)
        return self.deep(self.bn(pooled), generator=generator)
