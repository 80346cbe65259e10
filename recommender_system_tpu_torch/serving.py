"""Serving entry point: fixed-size batched scoring
(counterpart of ``recommender_system_tpu/serving.py``'s ``Scorer``).

Requests of any length are padded to a multiple of the batch size
(``pad_to_batch``), scored in fixed-size batches under
``torch.inference_mode()`` and un-padded on the way out.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops.dispatch import DeviceLike, resolve_device
from .training.losses import logits_of
from .utils.datasets import pad_to_batch


class Scorer:
    """Scoring wrapper around a model.

    >>> scorer = Scorer(model, batch_size=1024)
    >>> probs = scorer(features)     # any number of rows -> numpy [n, 1]

    The model must already lie on ``device`` (the card unless another device
    is named); each call puts it in eval mode (BatchNorm on its running
    statistics), since a ``Trainer`` sharing it puts it in train mode.
    """

    def __init__(self, model: torch.nn.Module, batch_size: int = 1024,
                 apply_sigmoid: bool = True, device: DeviceLike = None):
        requested = resolve_device(device)
        devices = {t.device for t in (*model.parameters(), *model.buffers())}
        if len(devices) != 1:
            raise ValueError(f"model spread over devices {sorted(map(str, devices))}")
        (model_device,) = devices
        if (model_device.type != requested.type
                or requested.index not in (None, model_device.index)):
            raise ValueError(f"model lies on {model_device}, Scorer serves on {requested}")
        self.device = model_device
        self.model = model.eval()
        self.batch_size = batch_size
        self.apply_sigmoid = apply_sigmoid

    def _score(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = logits_of(self.model(batch))
        if self.apply_sigmoid:
            out = torch.sigmoid(out)
        return out

    def __call__(self, features: Dict[str, np.ndarray]) -> np.ndarray:
        n = len(next(iter(features.values())))
        Xp, _, _ = pad_to_batch(features, None, self.batch_size)
        total = len(next(iter(Xp.values())))
        self.model.eval()
        out = []
        with torch.inference_mode():
            for start in range(0, total, self.batch_size):
                xb = {k: torch.as_tensor(v[start: start + self.batch_size],
                                         device=self.device)
                      for k, v in Xp.items()}
                out.append(self._score(xb))
            scores = torch.cat(out).cpu().numpy()
        return scores[:n]
