"""DIEN (Deep Interest Evolution Network): GRU interest extraction, an
auxiliary loss, target attention and AUGRU interest evolution
(counterpart of ``recommender_system_tpu/models/dien.py``).

1. The behaviour embeddings go through a GRU (``interest_gru``), one
   interest state a step.
2. With ``use_negsampling``, the auxiliary loss holds each state against the
   next clicked item and a sampled one (``neg_hist_<name>``) through
   ``AuxiliaryNet``.
3. The target attention (``DinAttention(return_score=True)``, the attention
   kernel on the card) scores the states against the query, projected to
   the state width by ``query_proj`` when ``gru_hidden`` differs from the
   key width.
4. An AUGRU (``augru``) gated by those scores evolves the states; its final
   state joins the deep input.

``forward`` returns ``(logits [B, 1], aux_loss)``; the ``Trainer``'s
``default_loss`` adds the two. Under a mesh (``mesh``, which the ``Trainer``
sets) ``aux_loss`` is the global batch's, the same on every rank.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.core import DNN, PredictionLayer, dense
from ..layers.embedding import EmbeddingCollection
from ..layers.sequence import AUGRULayer, DinAttention, GRULayer
from ..ops.dispatch import DeviceLike, resolve_device
from ..parallel.mesh import Mesh, replicated_sum
from ..utils.features import FeatureColumn, split_columns


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(exp(x) + 1)``, as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, x.new_zeros(()))


class AuxiliaryNet(nn.Module):
    """Per-step click classifier of the auxiliary loss: a sigmoid tower
    (``dense_0``, ``dense_1``; 100-50) over ``concat(state, item)``, then a
    linear ``out`` -> logits ``[B, T]``. ``dtype`` (None or bfloat16)
    computes the tower in that dtype, as Flax's Dense with ``dtype``; ``out``
    computes in f32."""

    def __init__(self, in_features: int, hidden_units: Sequence[int] = (100, 50),
                 dtype: Optional[torch.dtype] = None, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.hidden_units = tuple(hidden_units)
        self.dtype = dtype
        width = in_features
        for i, units in enumerate(self.hidden_units):
            self.add_module(f"dense_{i}", dense(width, units, device=device,
                                                generator=generator))
            width = units
        self.out = dense(width, 1, device=device, generator=generator)

    def forward(self, states: torch.Tensor, item_embeds: torch.Tensor) -> torch.Tensor:
        x = torch.cat([states, item_embeds], dim=-1)
        for i in range(len(self.hidden_units)):
            layer = getattr(self, f"dense_{i}")
            if self.dtype is None:
                x = torch.sigmoid(layer(x))
            else:
                x = torch.sigmoid(F.linear(x.to(self.dtype), layer.weight.to(self.dtype),
                                           layer.bias.to(self.dtype)))
        return self.out(x.to(torch.float32))[..., 0]


class DIEN(nn.Module):
    """``forward(batch, generator=None) -> (logits [B, 1], aux_loss)`` for a
    dict of tensors on the model's device; ``aux_loss`` is a 0-d f32 tensor,
    zero without ``use_negsampling``. ``gru_hidden=0`` takes the key width
    (the behaviour embeddings' summed dims). ``generator`` draws dropout
    masks in train mode. Runs on the card unless ``device`` names another;
    parameters are drawn from ``generator``. ``dnn_dtype`` is None (float32)
    or ``torch.bfloat16`` for the GRU's and AUGRU's gate products, the
    auxiliary tower and the deep tower (the attention kernel computes in
    f32)."""

    mesh: Optional[Mesh] = None

    def __init__(self, feature_columns: Sequence[FeatureColumn],
                 behavior_feature_list: Sequence[str] = ("item_id",),
                 gru_hidden: int = 0, att_hidden_units: Sequence[int] = (80, 40),
                 att_activation: str = "sigmoid", att_weight_normalization: bool = True,
                 hidden_units: Sequence[int] = (256, 128, 64), activation: str = "relu",
                 dropout_rate: float = 0.0, dnn_dtype: Optional[torch.dtype] = None,
                 use_negsampling: bool = False, *, device: DeviceLike = None,
                 generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.behavior_feature_list = tuple(behavior_feature_list)
        self.hist_names = tuple(f"hist_{n}" for n in self.behavior_feature_list)
        self.neg_names = tuple(f"neg_hist_{n}" for n in self.behavior_feature_list)
        self.use_negsampling = use_negsampling
        sparse, varlen, dense_cols = split_columns(tuple(feature_columns))
        varlen_names = {fc.name for fc in varlen}
        if use_negsampling and not all(n in varlen_names for n in self.neg_names):
            raise ValueError(
                f"use_negsampling=True but batch/columns lack {list(self.neg_names)}; "
                f"provide neg_hist_* varlen columns (e.g. "
                f"build_behavior_dataset(negsample=True)) or disable it")
        self.embeddings = EmbeddingCollection(feature_columns, device=device,
                                              generator=generator)
        dims = {fc.name: fc.embedding_dim for fc in (*sparse, *varlen)}
        key_dim = sum(dims[n] for n in self.hist_names)
        hidden = gru_hidden or key_dim
        self.interest_gru = GRULayer(key_dim, hidden, dtype=dnn_dtype, device=device,
                                     generator=generator)
        self.query_proj = (dense(sum(dims[n] for n in self.behavior_feature_list), hidden,
                                 device=device, generator=generator)
                           if hidden != key_dim else None)
        self.aux_net = (AuxiliaryNet(hidden + key_dim, dtype=dnn_dtype, device=device,
                                     generator=generator) if use_negsampling else None)
        self.attention = DinAttention(hidden, att_hidden_units, att_activation,
                                      weight_normalization=att_weight_normalization,
                                      return_score=True, dtype=dnn_dtype, device=device,
                                      generator=generator)
        self.augru = AUGRULayer(hidden, hidden, dtype=dnn_dtype, device=device,
                                generator=generator)
        skip = set(self.hist_names + self.neg_names)
        width = (sum(fc.embedding_dim for fc in sparse
                     if fc.name not in self.behavior_feature_list)
                 + sum(fc.embedding_dim for fc in varlen if fc.name not in skip)
                 + sum(dims[n] for n in self.behavior_feature_list) + hidden
                 + sum(fc.dimension for fc in dense_cols))
        self.deep = DNN(width, hidden_units, activation=activation,
                        dropout_rate=dropout_rate, output_dim=1, dtype=dnn_dtype,
                        device=device, generator=generator)
        self.prediction = PredictionLayer(device=device)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        emb = self.embeddings(batch)
        query = torch.cat([emb.sparse[n] for n in self.behavior_feature_list], dim=-1)
        keys = torch.cat([emb.varlen_raw[h] for h in self.hist_names], dim=-1)
        mask = emb.varlen_mask[self.hist_names[0]]  # [B, T]

        # 1. interest extraction
        states, _ = self.interest_gru(keys, mask=mask)
        att_query = query if self.query_proj is None else self.query_proj(query)

        # 2. the auxiliary loss: state t against the clicked item t+1 and a
        # sampled one, over the valid positions
        aux_loss = torch.zeros((), dtype=torch.float32, device=keys.device)
        if self.use_negsampling:
            neg_keys = torch.cat([emb.varlen_raw[n] for n in self.neg_names], dim=-1)
            h = states[:, :-1, :]
            m = mask[:, 1:].to(torch.float32)
            pos_logit = self.aux_net(h, keys[:, 1:, :])
            neg_logit = self.aux_net(h, neg_keys[:, 1:, :])
            ce = (_softplus(-pos_logit) + _softplus(neg_logit)) * m
            total, count = torch.sum(ce), torch.sum(m)
            if self.mesh is not None:  # the global batch's mean, as GSPMD's
                total, count = replicated_sum(torch.stack([total, count]), self.mesh)
            aux_loss = total / torch.clamp(count, min=1.0)

        # 3. attention scores over the interest states, 4. interest evolution
        att_scores = self.attention(att_query, states, mask, generator=generator)
        _, final_state = self.augru(states, att_scores, mask=mask)

        # the JAX package's concat order; transplanted weights depend on it
        skip = self.hist_names + self.neg_names
        parts = [v for n, v in emb.sparse.items() if n not in self.behavior_feature_list]
        parts += [v for n, v in emb.pooled.items() if n not in skip]
        parts += [query, final_state]
        if emb.dense is not None:
            parts.append(emb.dense)
        logit = self.deep(torch.cat(parts, dim=-1), generator=generator)
        return self.prediction(logit, logits=True), aux_loss
