"""AFM (Attentional Factorization Machine): attention over the pairwise
element-wise products of the field embeddings (counterpart of
``recommender_system_tpu/models/afm.py``).

The pairs ``e_i * e_j`` are pooled by attention (``mode="att"``), by their
mean (``"avg"``) or by their maximum (``"max"``); ``head`` maps the pooled
vector to a logit. ``use_linear`` (on by default, the paper's AFM) adds
``UnifiedEmbedding``'s first-order logit, each id's weight the last column
of its ``table_d{d+1}`` row.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.core import dense
from ..layers.embedding import EmbeddingCollection, UnifiedEmbedding
from ..layers.interaction import AFMAttention
from ..ops.dispatch import DeviceLike, resolve_device
from ..ops.interactions import pairwise_product
from ..utils.features import FeatureColumn, split_columns

MODES = ("att", "avg", "max")


class AFM(nn.Module):
    """``forward(batch, generator=None) -> logits [B, 1]`` for a dict of
    tensors on the model's device (``generator`` is accepted for the
    Trainer's call and unused). The sparse columns share one embedding dim.
    Runs on the card unless ``device`` names another; parameters are drawn
    from ``generator``."""

    def __init__(self, feature_columns: Sequence[FeatureColumn], mode: str = "att",
                 attention_units: int = 8, use_linear: bool = True, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"AFM's mode is one of {MODES}, not {mode!r}")
        device = resolve_device(device)
        self.mode = mode
        if use_linear:
            self.unified = UnifiedEmbedding(feature_columns, device=device,
                                            generator=generator)
        else:
            self.embeddings = EmbeddingCollection(feature_columns, device=device,
                                                  generator=generator)
        self.use_linear = use_linear
        k = split_columns(tuple(feature_columns))[0][0].embedding_dim
        self.attention = (AFMAttention(k, attention_units, device=device,
                                       generator=generator) if mode == "att" else None)
        self.head = dense(k, 1, device=device, generator=generator)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        if self.use_linear:
            emb, linear = self.unified(batch)
        else:
            emb, linear = self.embeddings(batch), None
        pairs = pairwise_product(emb.sparse_stack())  # [B, P, k]
        if self.mode == "avg":
            pooled = torch.mean(pairs, dim=1)
        elif self.mode == "max":
            pooled = torch.amax(pairs, dim=1)
        else:
            pooled = self.attention(pairs)
        logit = self.head(pooled)
        return logit if linear is None else logit + linear
