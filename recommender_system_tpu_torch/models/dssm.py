"""DSSM: two-tower retrieval over one shared embedding collection
(counterpart of ``recommender_system_tpu/models/dssm.py``).

One ``EmbeddingCollection`` holds the user and the item columns' tables; each
tower looks up only its own columns (``forward(batch, columns=...)``), so a
table both towers read (an item table that the user's history shares) is
gathered at one site per tower and, in a fused step, updated as one stream.
Each tower is a relu ``DNN``; its output is L2-normalised. The loss lives in
``training/losses.py`` (``inbatch_softmax_loss``, ``sampled_softmax_loss``),
passed to the ``Trainer`` as ``loss_fn``; ``serving.RetrievalIndex`` serves
the towers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.core import DNN
from ..layers.embedding import EmbeddingCollection, EmbedOutputs
from ..ops.dispatch import DeviceLike, resolve_device
from ..utils.features import FeatureColumn, split_columns


def _input_width(columns: Sequence[FeatureColumn]) -> int:
    sparse, varlen, dense = split_columns(tuple(columns))
    return (sum(fc.embedding_dim for fc in (*sparse, *varlen))
            + sum(fc.dimension for fc in dense))


def _tower_input(emb: EmbedOutputs, columns: Sequence[FeatureColumn]) -> torch.Tensor:
    """The tower's input, in the JAX package's order (transplanted weights
    depend on it): the single-valued embeddings, the pooled varlen columns,
    the dense columns."""
    names = {c.name for c in columns}
    parts = [v for n, v in emb.sparse.items() if n in names]
    parts += [v for n, v in emb.pooled.items() if n in names]
    if emb.dense is not None:
        parts.append(emb.dense)
    return torch.cat(parts, dim=-1)


class DSSM(nn.Module):
    """``forward(batch, generator=None) -> (u [B, d], v [B, d])``, the user
    and item embeddings of a batch on the model's device;
    ``user_embedding(batch)`` and ``item_embedding(batch)`` compute one
    tower each (the retrieval index's entry points). Parameters:
    ``embeddings`` over user then item columns, ``user_tower`` and
    ``item_tower`` (``dense_{i}``), drawn from ``generator``. Runs on the
    card unless ``device`` names another. ``dnn_dtype`` is None (float32)
    or ``torch.bfloat16`` for the towers."""

    def __init__(self, user_columns: Sequence[FeatureColumn],
                 item_columns: Sequence[FeatureColumn],
                 user_hidden_units: Sequence[int] = (64, 32),
                 item_hidden_units: Sequence[int] = (64, 32),
                 embedding_l2_normalize: bool = True,
                 dnn_dtype: Optional[torch.dtype] = None, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.user_columns = tuple(user_columns)
        self.item_columns = tuple(item_columns)
        self.embedding_l2_normalize = embedding_l2_normalize
        self.embeddings = EmbeddingCollection(self.user_columns + self.item_columns,
                                              device=device, generator=generator)
        self.user_tower = DNN(_input_width(self.user_columns), user_hidden_units,
                              activation="relu", dtype=dnn_dtype, device=device,
                              generator=generator)
        self.item_tower = DNN(_input_width(self.item_columns), item_hidden_units,
                              activation="relu", dtype=dnn_dtype, device=device,
                              generator=generator)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if self.embedding_l2_normalize:
            x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        return x

    def user_embedding(self, batch, generator: Optional[torch.Generator] = None):
        emb = self.embeddings(batch, columns=self.user_columns)
        return self._normalize(self.user_tower(_tower_input(emb, self.user_columns),
                                               generator=generator))

    def item_embedding(self, batch, generator: Optional[torch.Generator] = None):
        emb = self.embeddings(batch, columns=self.item_columns)
        return self._normalize(self.item_tower(_tower_input(emb, self.item_columns),
                                               generator=generator))

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        return (self.user_embedding(batch, generator=generator),
                self.item_embedding(batch, generator=generator))
