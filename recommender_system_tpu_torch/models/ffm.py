"""FFM (Field-aware Factorization Machine; counterpart of
``recommender_system_tpu/models/ffm.py``).

Each sparse feature's field-aware factors (one k-vector toward each of the
``n_fields`` fields) are one embedding of dim ``n_fields * k``, named
``ffm_{name}`` and stacked in ``field_embeddings.table_d{n_fields * k}``, so
one gather serves them and no one-hot is built. A dense column takes part
with its factors ``dense_factors[d]`` (normal, std 1e-4) scaled by its
value. The logit is ``LinearEmbedding``'s first-order term (its dim-1
tables in ``linear.linear_tables.table_d1``) plus
``sum_{i<j} <v_{i,j}, v_{j,i}>`` (``ffm_interaction``). The model has two
embedding collections, so a fused step updates two tables.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.embedding import EmbeddingCollection, LinearEmbedding
from ..ops.dispatch import DeviceLike, resolve_device
from ..ops.interactions import ffm_interaction
from ..utils.features import FeatureColumn, split_columns


class FFM(nn.Module):
    """``forward(batch, generator=None) -> logits [B, 1]`` for a dict of
    tensors on the model's device (``generator`` is accepted for the
    Trainer's call and unused). Sparse and dense columns only. Runs on the
    card unless ``device`` names another; parameters are drawn from
    ``generator``."""

    def __init__(self, feature_columns: Sequence[FeatureColumn], factor_dim: int = 4, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        sparse, varlen, dense = split_columns(tuple(feature_columns))
        if varlen:
            raise ValueError("FFM supports sparse + dense columns only")
        device = resolve_device(device)
        self.n_dense = sum(fc.dimension for fc in dense)
        self.n_fields = len(sparse) + self.n_dense
        self.factor_dim = factor_dim
        self.linear = LinearEmbedding(feature_columns, device=device, generator=generator)
        ffm_cols = [dataclasses.replace(fc, embedding_dim=self.n_fields * factor_dim,
                                        embedding_name=f"ffm_{fc.embedding_name}")
                    for fc in sparse]
        self._n_sparse = len(sparse)
        self._dense_names = [fc.name for fc in dense]
        self.field_embeddings = EmbeddingCollection(ffm_cols, device=device,
                                                    generator=generator)
        self.dense_factors = (nn.Parameter(
            (torch.randn(self.n_dense, self.n_fields, factor_dim, generator=generator,
                         device=generator.device) * 1e-4).to(device))
            if self.n_dense else None)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        linear = self.linear(batch)
        emb = self.field_embeddings(batch)
        B = linear.shape[0]
        field_embeds = [emb.sparse_stack()
                        .reshape(B, self._n_sparse, self.n_fields, self.factor_dim)]
        if self.dense_factors is not None:
            values = torch.cat([batch[n].reshape(B, -1) for n in self._dense_names],
                               dim=-1).to(torch.float32)  # [B, n_dense]
            field_embeds.append(values[:, :, None, None] * self.dense_factors[None])
        stacked = torch.cat(field_embeds, dim=1)  # [B, F, F, k]
        return linear + ffm_interaction(stacked)
