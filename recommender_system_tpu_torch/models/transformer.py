"""Transformer: the encoder-decoder with tied embeddings, and an encoder
classifier (counterpart of ``recommender_system_tpu/models/transformer.py``).

Token embeddings scaled by ``sqrt(model_dim)`` plus the sinusoidal position
encoding (a buffer, not a parameter), N encoder blocks, a decoder of causal
self-attention and attention over the encoder, and the output projection
tied to the embedding table. ``TransformerClassifier`` pools the encoder's
output over the valid positions (id 0 pads; divided by ``max(count, 1)``)
into a dense head.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..layers.core import dense
from ..layers.nlp import DecoderBlock, EncoderBlock, ScaledEmbedding, sinusoidal_pe
from ..ops.dispatch import DeviceLike, resolve_device


class Transformer(nn.Module):
    """``forward(src_ids [B, S], tgt_ids [B, T], generator=None) -> logits
    [B, T, vocab_size]``; ``encode`` and ``decode`` as the JAX package's.
    Runs on the card unless ``device`` names another; parameters are drawn
    from ``generator``."""

    def __init__(self, vocab_size: int, model_dim: int = 128, num_heads: int = 8,
                 num_layers: int = 6, ffn_dim: int = 512, max_len: int = 128,
                 dropout_rate: float = 0.1, *, device: DeviceLike = None,
                 generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = num_layers
        self.embedding = ScaledEmbedding(vocab_size, model_dim, device=device,
                                         generator=generator)
        self.register_buffer("pe", sinusoidal_pe(max_len, model_dim, device), persistent=False)
        for i in range(num_layers):
            self.add_module(f"enc_{i}", EncoderBlock(num_heads, model_dim, ffn_dim,
                                                     dropout_rate, device=device,
                                                     generator=generator))
        for i in range(num_layers):
            self.add_module(f"dec_{i}", DecoderBlock(num_heads, model_dim, ffn_dim,
                                                     dropout_rate, device=device,
                                                     generator=generator))

    def encode(self, src_ids: torch.Tensor, generator: Optional[torch.Generator] = None):
        mask = src_ids != 0
        x = self.embedding(src_ids) + self.pe[None, :src_ids.shape[1]]
        for i in range(self.num_layers):
            x = getattr(self, f"enc_{i}")(x, padding_mask=mask, generator=generator)
        return x, mask

    def decode(self, tgt_ids: torch.Tensor, enc_out: torch.Tensor, enc_mask: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask = tgt_ids != 0
        x = self.embedding(tgt_ids) + self.pe[None, :tgt_ids.shape[1]]
        for i in range(self.num_layers):
            x = getattr(self, f"dec_{i}")(x, enc_out, self_padding_mask=mask,
                                          enc_padding_mask=enc_mask, generator=generator)
        return self.embedding.attend(x)

    def forward(self, src_ids: torch.Tensor, tgt_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        enc_out, enc_mask = self.encode(src_ids, generator)
        return self.decode(tgt_ids, enc_out, enc_mask, generator)


class TransformerClassifier(nn.Module):
    """``forward(token_ids [B, T], generator=None) -> logits [B,
    num_classes]``: the encoder, the mean over valid positions, a dense
    head. Runs on the card unless ``device`` names another; parameters are
    drawn from ``generator``."""

    def __init__(self, vocab_size: int, model_dim: int = 128, num_heads: int = 8,
                 num_layers: int = 2, ffn_dim: int = 256, max_len: int = 128,
                 num_classes: int = 1, dropout_rate: float = 0.1, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = num_layers
        self.embedding = ScaledEmbedding(vocab_size, model_dim, device=device,
                                         generator=generator)
        self.register_buffer("pe", sinusoidal_pe(max_len, model_dim, device), persistent=False)
        for i in range(num_layers):
            self.add_module(f"enc_{i}", EncoderBlock(num_heads, model_dim, ffn_dim,
                                                     dropout_rate, device=device,
                                                     generator=generator))
        self.head = dense(model_dim, num_classes, device=device, generator=generator)

    def forward(self, token_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask = token_ids != 0
        x = self.embedding(token_ids) + self.pe[None, :token_ids.shape[1]]
        for i in range(self.num_layers):
            x = getattr(self, f"enc_{i}")(x, padding_mask=mask, generator=generator)
        m = mask.to(x.dtype)[..., None]
        pooled = torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
        return self.head(pooled)
