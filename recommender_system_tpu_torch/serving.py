"""Serving entry points (counterpart of ``recommender_system_tpu/serving.py``):

- ``Scorer``: fixed-size batched scoring. Requests of any length are padded
  to a multiple of the batch size (``pad_to_batch``), scored in fixed-size
  batches under ``torch.inference_mode()`` and un-padded on the way out.
- ``RetrievalIndex``: exact top-k retrieval for a two-tower model (DSSM):
  the item catalog embedded once, each query's user embeddings scored
  against all of it by one matrix product and ``torch.topk``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .ops.dispatch import DeviceLike, resolve_device
from .training.losses import logits_of
from .utils.datasets import pad_to_batch


def _model_device(model: torch.nn.Module, device: DeviceLike, who: str) -> torch.device:
    """The device ``model`` lies on, which must be the one requested (the
    card unless another is named)."""
    requested = resolve_device(device)
    devices = {t.device for t in (*model.parameters(), *model.buffers())}
    if len(devices) != 1:
        raise ValueError(f"model spread over devices {sorted(map(str, devices))}")
    (model_device,) = devices
    if (model_device.type != requested.type
            or requested.index not in (None, model_device.index)):
        raise ValueError(f"model lies on {model_device}, {who} serves on {requested}")
    return model_device


def _on(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


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
        self.device = _model_device(model, device, "Scorer")
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
                xb = _on({k: v[start: start + self.batch_size] for k, v in Xp.items()},
                         self.device)
                out.append(self._score(xb))
            scores = torch.cat(out).cpu().numpy()
        return scores[:n]


class RetrievalIndex:
    """Exact top-k retrieval over an item catalog embedded once.

    >>> index = RetrievalIndex(dssm, catalog)          # catalog["item_id"]: [N]
    >>> item_ids, scores = index.query(user_batch, k=10)

    ``model`` exposes ``item_embedding(batch)`` and ``user_embedding(batch)``
    (DSSM) and must already lie on ``device`` (the card unless another is
    named). The catalog is embedded once, under ``torch.inference_mode()``
    in eval mode. Scores are inner products (DSSM's towers L2-normalise, so
    cosines); ``query`` scores every item by one ``torch.matmul`` and takes
    ``torch.topk`` of them. The model is read live, as ``Scorer`` reads it:
    a catalog embedded before training is stale after it.
    """

    def __init__(self, model: torch.nn.Module, item_batch: Dict[str, np.ndarray],
                 item_id_key: str = "item_id", device: DeviceLike = None):
        self.device = _model_device(model, device, "RetrievalIndex")
        self.model = model
        self.item_ids = np.asarray(item_batch[item_id_key])
        self.model.eval()
        with torch.inference_mode():
            self.item_embeddings = model.item_embedding(_on(item_batch, self.device))

    def query(self, user_batch: Dict[str, np.ndarray],
              k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """-> ``(item_ids [B, k], scores [B, k])`` as numpy, each row's best
        first."""
        self.model.eval()
        with torch.inference_mode():
            user_emb = self.model.user_embedding(_on(user_batch, self.device))
            scores = torch.matmul(user_emb, self.item_embeddings.T)
            top, idx = torch.topk(scores, k, dim=-1, sorted=True)
            top, idx = top.cpu().numpy(), idx.cpu().numpy()
        return self.item_ids[idx], top
