"""Transformer building blocks: scaled embedding, sinusoidal position
encoding, multi-head attention, position-wise FFN, encoder and decoder
blocks (counterparts of ``recommender_system_tpu/layers/nlp.py``).

Module and parameter names follow Flax's (``q``, ``k``, ``v``, ``out``,
``in``, ``mha``, ``self_mha``, ``cross_mha``, ``ffn``, ``ln1``-``ln3``,
``table``), so that ``convert.load_jax_params`` maps each Flax parameter
onto its counterpart: the Dense layers are ``nn.Linear`` (weight ``[out,
in]``, the transpose of Flax's kernel), and ``LayerNorm`` is Flax's
``nn.LayerNorm`` exactly (epsilon 1e-6, the variance as ``E[x^2] - E[x]^2``
clipped at 0; Flax ``scale`` -> ``weight``).

Attention is computed as the JAX package computes it, with two products and
a softmax: masked logits take the finite ``NEG_INF``, so a row whose keys
are all padding attends uniformly instead of giving NaN. Dropout in train
mode draws its masks from the ``generator`` passed to ``forward``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.dispatch import resolve_device
from ..ops.seqpool import NEG_INF
from .core import dense, dropout


class LayerNorm(nn.Module):
    """Flax's ``nn.LayerNorm`` over the last axis: mean and fast variance
    ``E[x^2] - E[x]^2`` clipped at 0, ``(x - mean) * rsqrt(var + eps) *
    weight + bias``."""

    def __init__(self, features: int, epsilon: float = 1e-6, *, device: torch.device):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.weight) + self.bias


class ScaledEmbedding(nn.Module):
    """Token embedding scaled by ``sqrt(dim)``; ``attend`` is the tied
    output projection ``x @ table.T``."""

    def __init__(self, vocab_size: int, dim: int, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.dim = dim
        table = torch.empty(vocab_size, dim, device=generator.device)
        table.normal_(0.0, 0.02, generator=generator)
        self.table = nn.Parameter(table.to(device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.table[ids.long()] * math.sqrt(float(self.dim))

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.table.T


def sinusoidal_pe(max_len: int, dim: int, device=None) -> torch.Tensor:
    """The sinusoidal position encoding ``[max_len, dim]``, computed in
    float64 numpy and cast to float32, on the card unless ``device`` names
    another (raises without one)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / dim)
    pe = np.zeros((max_len, dim))
    pe[:, 0::2] = np.sin(angle[:, 0::2])
    pe[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.as_tensor(pe, dtype=torch.float32, device=resolve_device(device))


def causal_mask(T: int, device=None) -> torch.Tensor:
    """``[T, T]`` bool, True on and below the diagonal, on the card unless
    ``device`` names another (raises without one)."""
    return torch.tril(torch.ones(T, T, dtype=torch.bool, device=resolve_device(device)))


class MultiHeadAttention(nn.Module):
    """Scaled dot-product attention over ``num_heads`` heads of
    ``model_dim // num_heads``, with a key padding mask (``[B, Tk]``, True =
    valid) and, with ``causal``, the lower-triangular mask. ``in_features``
    and ``kv_features`` (default ``model_dim``) are the widths of the query
    and key/value inputs, which Flax infers from the first call."""

    def __init__(self, num_heads: int, model_dim: int, dropout_rate: float = 0.0,
                 causal: bool = False, in_features: Optional[int] = None,
                 kv_features: Optional[int] = None, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads, self.model_dim = num_heads, model_dim
        self.dropout_rate, self.causal = dropout_rate, causal
        q_in = in_features or model_dim
        kv_in = kv_features or model_dim
        for name, width in (("q", q_in), ("k", kv_in), ("v", kv_in)):
            self.add_module(name, dense(width, model_dim, device=device, generator=generator))
        self.out = dense(model_dim, model_dim, device=device, generator=generator)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, Tq, _ = q_in.shape
        Tk = kv_in.shape[1]
        H, dh = self.num_heads, self.model_dim // self.num_heads

        def proj(x, layer):
            return layer(x).reshape(x.shape[0], x.shape[1], H, dh).transpose(1, 2)

        q, k, v = proj(q_in, self.q), proj(kv_in, self.k), proj(kv_in, self.v)  # [B, H, T, dh]
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(float(dh))
        mask = torch.ones(B, 1, Tq, Tk, dtype=torch.bool, device=q_in.device)
        if key_padding_mask is not None:
            mask = mask & key_padding_mask[:, None, None, :].to(torch.bool)
        if self.causal:
            mask = mask & causal_mask(Tq, q_in.device)[None, None, :, :Tk]
        att = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        if self.training and self.dropout_rate > 0.0:
            att = dropout(att, self.dropout_rate, generator)
        out = torch.einsum("bhqk,bhkd->bhqd", att, v)
        return self.out(out.transpose(1, 2).reshape(B, Tq, self.model_dim))


class PositionWiseFFN(nn.Module):
    """``out(relu(in(x)))``; ``in_features`` defaults to ``model_dim``."""

    def __init__(self, hidden_dim: int, model_dim: int, in_features: Optional[int] = None, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.add_module("in", dense(in_features or model_dim, hidden_dim, device=device,
                                    generator=generator))
        self.out = dense(hidden_dim, model_dim, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(getattr(self, "in")(x)))


def _drop(module: nn.Module, x: torch.Tensor, rate: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    return dropout(x, rate, generator) if module.training and rate > 0.0 else x


class EncoderBlock(nn.Module):
    """Self-attention, add and norm, FFN, add and norm."""

    def __init__(self, num_heads: int, model_dim: int, ffn_dim: int,
                 dropout_rate: float = 0.1, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.mha = MultiHeadAttention(num_heads, model_dim, dropout_rate, device=device,
                                      generator=generator)
        self.ln1 = LayerNorm(model_dim, device=device)
        self.ffn = PositionWiseFFN(ffn_dim, model_dim, device=device, generator=generator)
        self.ln2 = LayerNorm(model_dim, device=device)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        att = self.mha(x, x, key_padding_mask=padding_mask, generator=generator)
        x = self.ln1(x + _drop(self, att, self.dropout_rate, generator))
        ffn = self.ffn(x)
        return self.ln2(x + _drop(self, ffn, self.dropout_rate, generator))


class DecoderBlock(nn.Module):
    """Causal self-attention, add and norm, attention over the encoder's
    output, add and norm, FFN, add and norm."""

    def __init__(self, num_heads: int, model_dim: int, ffn_dim: int,
                 dropout_rate: float = 0.1, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_mha = MultiHeadAttention(num_heads, model_dim, dropout_rate, causal=True,
                                           device=device, generator=generator)
        self.ln1 = LayerNorm(model_dim, device=device)
        self.cross_mha = MultiHeadAttention(num_heads, model_dim, dropout_rate,
                                            device=device, generator=generator)
        self.ln2 = LayerNorm(model_dim, device=device)
        self.ffn = PositionWiseFFN(ffn_dim, model_dim, device=device, generator=generator)
        self.ln3 = LayerNorm(model_dim, device=device)

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor,
                self_padding_mask: Optional[torch.Tensor] = None,
                enc_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.dropout_rate
        att = self.self_mha(x, x, key_padding_mask=self_padding_mask, generator=generator)
        x = self.ln1(x + _drop(self, att, rate, generator))
        cross = self.cross_mha(x, enc_out, key_padding_mask=enc_padding_mask,
                               generator=generator)
        x = self.ln2(x + _drop(self, cross, rate, generator))
        ffn = self.ffn(x)
        return self.ln3(x + _drop(self, ffn, rate, generator))
