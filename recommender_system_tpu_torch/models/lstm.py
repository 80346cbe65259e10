"""LSTM sequence classifier (counterpart of
``recommender_system_tpu/models/lstm.py``): token embedding, the LSTM of
``ops/rnn.py`` over the valid steps (id 0 pads), the last state, a dense
head.

Parameter names as Flax's: ``embedding [V, E]``, ``wx [E, 4H]``, ``wh [H,
4H]`` and ``bias [4H]`` in ``ops/rnn.py``'s gate order (i, f, c, o; the
forget quarter starts at 1), ``head`` a Dense.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..layers.core import dense, glorot_uniform_
from ..ops.dispatch import DeviceLike, resolve_device
from ..ops.rnn import LSTMParams, lstm


class LSTMClassifier(nn.Module):
    """``forward(token_ids [B, T], generator=None) -> logits [B,
    num_classes]``. Runs on the card unless ``device`` names another;
    parameters are drawn from ``generator``."""

    def __init__(self, vocab_size: int, embed_dim: int = 64, hidden: int = 64,
                 num_classes: int = 1, *, device: DeviceLike = None,
                 generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        draw = generator.device
        table = torch.empty(vocab_size, embed_dim, device=draw).normal_(
            0.0, 0.02, generator=generator)
        self.embedding = nn.Parameter(table.to(device))
        wx = torch.empty(embed_dim, 4 * hidden, device=draw)
        glorot_uniform_(wx, generator)
        self.wx = nn.Parameter(wx.to(device))
        wh = torch.empty(hidden, 4 * hidden, device=draw)
        nn.init.orthogonal_(wh, generator=generator)
        self.wh = nn.Parameter(wh.to(device))
        bias = torch.zeros(4 * hidden, device=device)
        bias[hidden:2 * hidden] = 1.0
        self.bias = nn.Parameter(bias)
        self.head = dense(hidden, num_classes, device=device, generator=generator)

    def forward(self, token_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embedding[token_ids.long()]
        _, (h_last, _) = lstm(LSTMParams(self.wx, self.wh, self.bias), x,
                              mask=token_ids != 0)
        return self.head(h_last)
