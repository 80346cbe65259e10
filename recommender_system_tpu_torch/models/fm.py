"""FM (Factorization Machine) over typed feature columns (counterpart of
``recommender_system_tpu/models/fm.py``).

The first-order term is ``UnifiedEmbedding``'s linear logit; the second
order is the bi-interaction of the gathered factor vectors, which over a
one-hot input equals ``sum_{i<j} <v_i, v_j>``, so no one-hot matrix is
built. A dense column takes part with its own factor vector scaled by its
value, ``x_d * v_d`` (``dense_factors``, normal with std 1e-4).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.embedding import UnifiedEmbedding
from ..ops.dispatch import DeviceLike, resolve_device
from ..ops.interactions import bi_interaction
from ..utils.features import FeatureColumn, split_columns


class FM(nn.Module):
    """``forward(batch, generator=None) -> logits [B, 1]`` for a dict of
    tensors on the model's device (``generator`` is accepted for the
    Trainer's call and unused: FM has no dropout). ``factor_dim`` 0 takes
    the sparse columns' embedding dim. Runs on the card unless ``device``
    names another; parameters are drawn from ``generator``."""

    def __init__(self, feature_columns: Sequence[FeatureColumn], factor_dim: int = 0, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.unified = UnifiedEmbedding(feature_columns, device=device,
                                        generator=generator)
        sparse, varlen, dense = split_columns(tuple(feature_columns))
        n_dense = sum(fc.dimension for fc in dense)
        k = factor_dim or (sparse + varlen)[0].embedding_dim
        self.dense_factors = (nn.Parameter(
            (torch.randn(n_dense, k, generator=generator, device=generator.device)
             * 1e-4).to(device)) if n_dense else None)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        emb, linear = self.unified(batch)
        # the sparse fields in the JAX package's order, then the pooled
        # varlen columns
        fields = [emb.sparse_stack()]
        fields += [v[:, None, :] for v in emb.pooled.values()]
        if emb.dense is not None:
            fields.append(emb.dense[:, :, None] * self.dense_factors[None, :, :])  # [B, D, k]
        stacked = torch.cat(fields, dim=1)  # [B, F_total, k]
        return linear + torch.sum(bi_interaction(stacked), dim=-1, keepdim=True)
