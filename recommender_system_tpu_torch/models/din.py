"""DIN (Deep Interest Network): target attention over behaviour sequences
(counterpart of ``recommender_system_tpu/models/din.py``).

Behaviour features are varlen columns named ``hist_<target>`` that share the
target's table; their mask comes from the ids (id 0 is padding) or from a
length column. The attention's pooled history, the query and the other
features go through a BatchNorm and a Dice tower to one logit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.core import DNN, BatchNorm
from ..layers.embedding import EmbeddingCollection
from ..layers.sequence import DinAttention
from ..ops.dispatch import DeviceLike, resolve_device
from ..utils.features import FeatureColumn, split_columns


class DIN(nn.Module):
    """``forward(batch, generator=None) -> logits [B, 1]`` for a dict of
    tensors on the model's device; ``generator`` draws dropout masks in train
    mode. Runs on the card unless ``device`` names another; parameters are
    drawn from ``generator``. ``dnn_dtype`` is None (float32) or
    ``torch.bfloat16`` for the deep tower (the attention kernel computes in
    f32)."""

    def __init__(self, feature_columns: Sequence[FeatureColumn],
                 behavior_feature_list: Sequence[str] = ("item_id",),
                 att_hidden_units: Sequence[int] = (80, 40),
                 att_activation: str = "sigmoid",
                 hidden_units: Sequence[int] = (256, 128, 64),
                 activation: str = "dice", dropout_rate: float = 0.0,
                 dnn_dtype: Optional[torch.dtype] = None, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.behavior_feature_list = tuple(behavior_feature_list)
        self.hist_names = tuple(f"hist_{n}" for n in self.behavior_feature_list)
        self.embeddings = EmbeddingCollection(feature_columns, device=device,
                                              generator=generator)
        sparse, varlen, dense = split_columns(tuple(feature_columns))
        dims = {fc.name: fc.embedding_dim for fc in (*sparse, *varlen)}
        key_dim = sum(dims[n] for n in self.behavior_feature_list)
        self.attention = DinAttention(key_dim, att_hidden_units, att_activation,
                                      dtype=dnn_dtype, device=device,
                                      generator=generator)
        width = (sum(fc.embedding_dim for fc in sparse
                     if fc.name not in self.behavior_feature_list)
                 + sum(fc.embedding_dim for fc in varlen if fc.name not in self.hist_names)
                 + 2 * key_dim + sum(fc.dimension for fc in dense))
        self.bn = BatchNorm(width, device=device)
        self.deep = DNN(width, hidden_units, activation=activation,
                        dropout_rate=dropout_rate, output_dim=1, dtype=dnn_dtype,
                        device=device, generator=generator)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        emb = self.embeddings(batch)
        query = torch.cat([emb.sparse[n] for n in self.behavior_feature_list], dim=-1)
        keys = torch.cat([emb.varlen_raw[h] for h in self.hist_names], dim=-1)
        mask = emb.varlen_mask[self.hist_names[0]]
        att_pooled = self.attention(query, keys, mask, generator=generator)  # [B, K]
        # the JAX package's concat order; transplanted weights depend on it
        parts = [v for n, v in emb.sparse.items() if n not in self.behavior_feature_list]
        parts += [v for n, v in emb.pooled.items() if n not in self.hist_names]
        parts += [att_pooled, query]
        if emb.dense is not None:
            parts.append(emb.dense)
        x = self.bn(torch.cat(parts, dim=-1))
        return self.deep(x, generator=generator)
