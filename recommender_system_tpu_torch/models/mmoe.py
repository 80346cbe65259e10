"""MMOE: multi-gate mixture-of-experts multi-task model
(counterpart of ``recommender_system_tpu/models/mmoe.py``).

The shared bottom input is either the feature columns through an
``EmbeddingCollection`` (``concat_flat``) or, with no columns, a plain
dense ``[B, D]`` tensor; ``MMoELayer`` gives each task its input and a
``TowerLayer`` per task (``tower_{t}``) its logit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers.embedding import EmbeddingCollection
from ..layers.interaction import MMoELayer, TowerLayer
from ..ops.dispatch import DeviceLike, resolve_device
from ..utils.features import FeatureColumn


class MMOE(nn.Module):
    """``forward(batch, generator=None) -> [logits [B, 1]] * num_tasks``,
    which ``default_loss`` takes with ``[B, num_tasks]`` labels and
    ``Trainer.evaluate`` scores per task. ``batch`` is a dict of tensors
    when ``feature_columns`` is given, else a dense ``[B, in_features]``
    tensor (``in_features`` is then required: Flax infers it from the first
    input). Runs on the card unless ``device`` names another; parameters
    are drawn from ``generator``."""

    def __init__(self, num_tasks: int = 2, num_experts: int = 4, expert_units: int = 16,
                 tower_hidden_units: Sequence[int] = (8,),
                 feature_columns: Optional[Sequence[FeatureColumn]] = None, *,
                 in_features: Optional[int] = None, device: DeviceLike = None,
                 generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.num_tasks = num_tasks
        self.feature_columns = (tuple(feature_columns) if feature_columns is not None
                                else None)
        if self.feature_columns is not None:
            self.embeddings = EmbeddingCollection(self.feature_columns, device=device,
                                                  generator=generator)
            in_features = self.embeddings.output_dim
        elif in_features is None:
            raise ValueError("MMOE without feature_columns takes a dense [B, D] "
                             "input: pass in_features=D")
        self.mmoe = MMoELayer(in_features, num_experts, expert_units, num_tasks,
                              device=device, generator=generator)
        for t in range(num_tasks):
            self.add_module(f"tower_{t}", TowerLayer(expert_units, tower_hidden_units, 1,
                                                     device=device, generator=generator))

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        x = (self.embeddings(batch).concat_flat() if self.feature_columns is not None
             else batch)
        task_inputs = self.mmoe(x)
        return [getattr(self, f"tower_{t}")(task_inputs[t]) for t in range(self.num_tasks)]
