"""Behaviour-sequence attention: DIN target attention
(counterpart of ``recommender_system_tpu/layers/sequence.py``'s
``DinAttention``).

``DinAttention(K, ...)`` takes ``query [B, K]``, ``keys [B, T, K]`` and
``mask [B, T]`` and returns the pooled ``[B, K]`` (or the weights ``[B, T]``
with ``return_score``). A scorer of exactly two hidden layers with a sigmoid
or relu activation runs as ``din_attention`` (the kernel on the card), with
the parameters ``w1 [4K, H1]``, ``b1``, ``w2 [H1, H2]``, ``b2``, ``w3 [H2, 1]``,
``b3`` kept in the JAX package's layout; any other scorer (dice, prelu,
another depth) is a ``DNN`` named ``local_activation_unit`` over
``concat([q, k, q-k, q*k])``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.attention import din_attention
from ..ops.seqpool import masked_softmax
from .core import DNN, glorot_uniform_


class DinAttention(nn.Module):
    """Target attention pooling over a behaviour sequence (see the module
    docstring). ``weight_normalization`` takes the masked softmax of the
    scores; without it invalid positions score 0."""

    def __init__(self, key_dim: int, hidden_units: Sequence[int] = (80, 40),
                 activation: str = "sigmoid", weight_normalization: bool = True,
                 return_score: bool = False, dtype: Optional[torch.dtype] = None, *,
                 device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.hidden_units = tuple(hidden_units)
        self.activation = activation
        self.weight_normalization = weight_normalization
        self.return_score = return_score
        self.dtype = dtype
        self.fusable = (len(self.hidden_units) == 2
                        and activation in ("sigmoid", "relu"))
        K = key_dim
        if self.fusable:
            h1, h2 = self.hidden_units
            for name, shape in (("w1", (4 * K, h1)), ("b1", (h1,)), ("w2", (h1, h2)),
                                ("b2", (h2,)), ("w3", (h2, 1)), ("b3", (1,))):
                t = torch.zeros(shape, device=device)
                if name.startswith("w"):
                    # the glorot limit is symmetric in the fans
                    with torch.no_grad():
                        glorot_uniform_(t, generator)
                self.register_parameter(name, nn.Parameter(t))
        else:
            self.local_activation_unit = DNN(
                4 * K, self.hidden_units, activation=activation, output_dim=1,
                dtype=dtype, device=device, generator=generator)

    def forward(self, query: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks of a non-fusable scorer in
        train mode (it has no dropout unless one is configured)."""
        if self.fusable:
            return din_attention(
                query, keys, mask, self.w1, self.b1, self.w2, self.b2, self.w3,
                self.b3, activation=self.activation,
                weight_normalization=self.weight_normalization,
                return_scores=self.return_score, dtype=self.dtype)
        q = query[:, None, :].expand_as(keys)  # tile over T
        att_in = torch.cat([q, keys, q - keys, q * keys], dim=-1)
        score = self.local_activation_unit(att_in, generator=generator)[..., 0]
        if self.weight_normalization:
            score = masked_softmax(score, mask, axis=-1)
        else:
            score = torch.where(mask, score, 0.0)
        if self.return_score:
            return score
        return torch.einsum("bt,btk->bk", score, keys)
