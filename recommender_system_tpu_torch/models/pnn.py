"""PNN (Product-based Neural Network): inner and/or kernel-weighted outer
products of the field embeddings, optionally with FGCNN's generated fields,
and a deep tower (counterpart of ``recommender_system_tpu/models/pnn.py``).

The tower reads ``[flat embeddings | inner products | outer products |
dense features]`` in that order. ``mode`` is ``"inner"``, ``"outer"`` or
``"both"``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.core import DNN
from ..layers.embedding import EmbeddingCollection
from ..layers.interaction import FGCNN, OuterProductLayer
from ..ops.dispatch import DeviceLike, resolve_device
from ..ops.interactions import pairwise_inner
from ..utils.features import FeatureColumn, split_columns

MODES = ("inner", "outer", "both")


class PNN(nn.Module):
    """``forward(batch, generator=None) -> logits [B, 1]`` for a dict of
    tensors on the model's device; ``generator`` draws the deep tower's
    dropout masks in train mode. The sparse columns share one embedding
    dim. Runs on the card unless ``device`` names another; parameters are
    drawn from ``generator``. ``dnn_dtype`` is None (float32) or
    ``torch.bfloat16`` for the deep tower's hidden layers."""

    def __init__(self, feature_columns: Sequence[FeatureColumn], mode: str = "inner",
                 use_fgcnn: bool = False, hidden_units: Sequence[int] = (256, 128, 64),
                 activation: str = "relu", dropout_rate: float = 0.0,
                 dnn_dtype: Optional[torch.dtype] = None, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"PNN's mode is one of {MODES}, not {mode!r}")
        device = resolve_device(device)
        self.mode = mode
        self.embeddings = EmbeddingCollection(feature_columns, device=device,
                                              generator=generator)
        sparse, _, dense = split_columns(tuple(feature_columns))
        fields, k = len(sparse), sparse[0].embedding_dim
        self.fgcnn = (FGCNN(fields, k, device=device, generator=generator)
                      if use_fgcnn else None)
        if use_fgcnn:
            fields += self.fgcnn.out_fields
        pairs = fields * (fields - 1) // 2
        width = fields * k + sum(fc.dimension for fc in dense)
        if mode in ("inner", "both"):
            width += pairs
        self.outer = None
        if mode in ("outer", "both"):
            self.outer = OuterProductLayer(fields, k, device=device, generator=generator)
            width += pairs
        self.deep = DNN(width, hidden_units, activation=activation,
                        dropout_rate=dropout_rate, output_dim=1, dtype=dnn_dtype,
                        device=device, generator=generator)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        emb = self.embeddings(batch)
        embeds = emb.sparse_stack()  # [B, F, k]
        if self.fgcnn is not None:
            embeds = torch.cat([embeds, self.fgcnn(embeds)], dim=1)
        parts = [embeds.reshape(embeds.shape[0], -1)]
        if self.mode in ("inner", "both"):
            parts.append(pairwise_inner(embeds))
        if self.outer is not None:
            parts.append(self.outer(embeds))
        if emb.dense is not None:
            parts.append(emb.dense)
        return self.deep(torch.cat(parts, dim=-1), generator=generator)
