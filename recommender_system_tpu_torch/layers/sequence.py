"""Behaviour-sequence layers: DIN target attention and DIEN's recurrent
layers (counterparts of ``recommender_system_tpu/layers/sequence.py``'s
``DinAttention``, ``GRULayer`` and ``AUGRULayer``).

``DinAttention(K, ...)`` takes ``query [B, K]``, ``keys [B, T, K]`` and
``mask [B, T]`` and returns the pooled ``[B, K]`` (or the weights ``[B, T]``
with ``return_score``). A scorer of exactly two hidden layers with a sigmoid
or relu activation runs as ``din_attention`` (the kernel on the card), with
the parameters ``w1 [4K, H1]``, ``b1``, ``w2 [H1, H2]``, ``b2``, ``w3 [H2, 1]``,
``b3`` kept in the JAX package's layout; any other scorer (dice, prelu,
another depth) is a ``DNN`` named ``local_activation_unit`` over
``concat([q, k, q-k, q*k])``.

``GRULayer(D, H)`` and ``AUGRULayer(D, H)`` run ``ops/rnn.py``'s ``gru`` and
``augru`` on their parameters ``wx [D, 3H]``, ``wh [H, 3H]`` and ``bias
[3H]``, named and laid out as the JAX package's so that ``convert.py`` copies
them as they are. As there, ``wx`` is stored as drawn, uniform on ``[0,
2/sqrt(D))``, and ``wx - 1/sqrt(D)`` enters the cell.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.attention import din_attention
from ..ops.rnn import GRUParams, augru, gru, input_scale, orthogonal_blocks
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


class _Recurrent(nn.Module):
    """The parameters GRU and AUGRU share: ``wx [D, 3H]`` uniform on ``[0,
    2 scale)`` with ``scale = 1/sqrt(D)`` (the cell takes ``wx - scale``),
    ``wh [H, 3H]`` three orthogonal blocks, ``bias [3H]`` zeros, drawn from
    ``generator`` in that order. ``dtype`` casts the gate products'
    operands (``ops/rnn.py``)."""

    def __init__(self, input_dim: int, hidden: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.scale = input_scale(input_dim)
        self.wx = nn.Parameter((torch.rand(input_dim, 3 * hidden, generator=generator,
                                           device=generator.device)
                                * (2 * self.scale)).to(device))
        self.wh = nn.Parameter(orthogonal_blocks(generator, hidden, 3).to(device))
        self.bias = (nn.Parameter(torch.zeros(3 * hidden, device=device))
                     if use_bias else None)

    def params(self) -> GRUParams:
        return GRUParams(self.wx - self.scale, self.wh, self.bias)


class GRULayer(_Recurrent):
    """GRU over ``[B, T, D]`` -> (outputs ``[B, T, H]``, final ``[B, H]``)."""

    def forward(self, inputs: torch.Tensor, mask: Optional[torch.Tensor] = None):
        return gru(self.params(), inputs, mask=mask, dtype=self.dtype)


class AUGRULayer(_Recurrent):
    """Attention-gated GRU: ``att_scores [B, T]`` scales each step's update
    -> (outputs ``[B, T, H]``, final ``[B, H]``)."""

    def forward(self, inputs: torch.Tensor, att_scores: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
        return augru(self.params(), inputs, att_scores, mask=mask, dtype=self.dtype)
