"""FNN: FM-pretrained embeddings feeding a DNN, trained in two stages
(counterpart of ``recommender_system_tpu/models/fnn.py``).

Stage 1 trains an ``FM``; ``init_from_fm`` copies its factor vectors into
the FNN's tables; stage 2 trains the FNN.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.core import DNN
from ..layers.embedding import EmbeddingCollection
from ..ops.dispatch import DeviceLike, resolve_device
from ..utils.features import FeatureColumn
from .fm import FM


class FNN(nn.Module):
    """``forward(batch, generator=None) -> logits [B, 1]``: a DNN over the
    flattened embeddings and dense features. ``generator`` draws the deep
    tower's dropout masks in train mode. Runs on the card unless ``device``
    names another; parameters are drawn from ``generator``. ``dnn_dtype`` is
    None (float32) or ``torch.bfloat16`` for the deep tower's hidden
    layers."""

    def __init__(self, feature_columns: Sequence[FeatureColumn],
                 hidden_units: Sequence[int] = (256, 128, 64),
                 activation: str = "relu", dropout_rate: float = 0.0,
                 dnn_dtype: Optional[torch.dtype] = None, *,
                 device: DeviceLike = None, generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.embeddings = EmbeddingCollection(feature_columns, device=device,
                                              generator=generator)
        self.deep = DNN(self.embeddings.output_dim, hidden_units, activation=activation,
                        dropout_rate=dropout_rate, output_dim=1, dtype=dnn_dtype,
                        device=device, generator=generator)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        return self.deep(self.embeddings(batch).concat_flat(), generator=generator)


@torch.no_grad()
def init_from_fm(fnn: FNN, fm: FM) -> FNN:
    """Copy the FM's trained factor vectors into ``fnn``, in place; returns
    ``fnn``.

    The FM keeps ``[v_1..v_d, w]`` in each row of its ``table_d{d+1}``; for
    every dim d that both models have, the FNN's ``table_d{d}`` takes the
    first d columns, row for row, and rows past the FM's are zeroed (as the
    JAX package's ``pack_stack`` pads them)."""
    src = fm.unified.embeddings
    for name, dst in fnn.embeddings.named_parameters(recurse=False):
        dim = int(name[len("table_d"):])
        key = f"table_d{dim + 1}"
        if not hasattr(src, key):
            continue
        logical = getattr(src, key)[:, :dim]
        if logical.shape[0] > dst.shape[0]:
            raise ValueError(f"the FM's {key} has {logical.shape[0]} rows, the FNN's "
                             f"{name} only {dst.shape[0]}")
        dst[:logical.shape[0]].copy_(logical)
        dst[logical.shape[0]:].zero_()
    return fnn
