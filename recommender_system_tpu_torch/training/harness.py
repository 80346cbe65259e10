"""Training and evaluation driver (counterpart of
``recommender_system_tpu/training/harness.py``).

``Trainer`` trains a model of the port on the card (or on the CPU when told)
with a dense optimizer (``training/optim.py``: ``SGD``, ``Adagrad``,
``Adam``) and, optionally, a fused sparse embedding optimizer:
``FusedAdagrad``, ``FusedSGD`` or ``FusedAdam`` (lazy).

- plain step: autograd gives every parameter its gradient, the tables'
  through ``take_fast``'s backward (the sorted scatter-add kernel), and the
  dense optimizer updates them all;
- fused step: the embedding collections run in capture mode, so the tables
  never enter autograd; after ``backward()`` each table's captured lookups
  (one stream per ``table_d{d}``, its sites concatenated) go straight into
  the fused optimizer's kernel (``fused_adagrad_apply``,
  ``fused_sgd_apply`` or ``fused_adam_apply``), which updates the touched
  rows in place.

A table looked up at several sites (DIN's ``[B, 2]`` user and item group
and its ``[B, T]`` history) is one stream of all its sites, with no size
threshold. The train step runs the model in train mode, so BatchNorm and
Dice normalise with the batch and move their running statistics;
``predict`` and ``evaluate`` run it in eval mode.

Neither step reads a device value on the host, so a ``multi_step`` call of
K steps over batches already on the device runs without a synchronisation.
Unlike the JAX package's pure ``TrainState``, the parameters live in the
model and the optimizer state in the Trainer, both updated in place.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..layers.embedding import EmbeddingCollection
from ..ops.dispatch import DeviceLike, resolve_device
from ..ops.fused_adagrad import fused_adagrad_apply, fused_adam_apply, fused_sgd_apply
from ..utils import metrics as metrics_lib
from ..utils.datasets import iter_batches, pad_to_batch
from .losses import default_loss, logits_of
from .optim import Adam, DecayedWeights, LearningRate, learning_rate_at

_STACK_KEY_RE = re.compile(r"^table_d(\d+)$")


@dataclasses.dataclass(frozen=True)
class FusedAdagrad:
    """The fused sparse embedding optimizer: Adagrad on the touched rows of
    each ``table_d{d}``, in place (``ops/fused_adagrad.py``). Matches
    ``optax.adagrad`` on the dense scatter-added gradient.
    ``learning_rate`` is a float or a callable of the step."""

    learning_rate: LearningRate = 0.05
    eps: float = 1e-7
    initial_accumulator_value: float = 0.1

    def init_slots(self, table: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return (torch.full_like(table, self.initial_accumulator_value,
                                requires_grad=False),)

    def apply(self, table: torch.Tensor, slots: Tuple[torch.Tensor, ...],
              lids: torch.Tensor, ct: torch.Tensor, *, step: int,
              presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        fused_adagrad_apply(table, slots[0], lids, ct,
                            lr=learning_rate_at(self.learning_rate, step),
                            eps=self.eps, presorted=presorted)


@dataclasses.dataclass(frozen=True)
class FusedSGD:
    """Fused sparse SGD: ``param[row] -= lr * G`` on the touched rows of each
    ``table_d{d}``, in place (``fused_sgd_apply``); ``optax.sgd`` on the
    dense scatter-added gradient, with no slots. ``SGD(0.01)`` and
    ``FusedSGD(0.01)`` are the reference's training recipe."""

    learning_rate: LearningRate = 0.01

    def init_slots(self, table: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return ()

    def apply(self, table: torch.Tensor, slots: Tuple[torch.Tensor, ...],
              lids: torch.Tensor, ct: torch.Tensor, *, step: int,
              presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        fused_sgd_apply(table, lids, ct, lr=learning_rate_at(self.learning_rate, step),
                        presorted=presorted)


@dataclasses.dataclass(frozen=True)
class FusedAdam:
    """Fused sparse lazy Adam (``fused_adam_apply``): a row whose summed
    gradient is non-zero this step gets the Adam update with bias
    corrections at ``step + 1``; every other row keeps its parameters and
    its stale moments, so no step sweeps the whole table. Slots
    ``(m, v)``."""

    learning_rate: LearningRate = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init_slots(self, table: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return (torch.zeros_like(table, requires_grad=False),
                torch.zeros_like(table, requires_grad=False))

    def apply(self, table: torch.Tensor, slots: Tuple[torch.Tensor, ...],
              lids: torch.Tensor, ct: torch.Tensor, *, step: int,
              presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        fused_adam_apply(table, slots[0], slots[1], lids, ct,
                         lr=learning_rate_at(self.learning_rate, step), step=step,
                         b1=self.b1, b2=self.b2, eps=self.eps, presorted=presorted)


FusedOptimizer = Union[FusedAdagrad, FusedSGD, FusedAdam]


class Trainer:
    """Train, predict and evaluate a model of the port.

    >>> trainer = Trainer(model, Adagrad(0.05), fused_embedding=FusedAdagrad(0.05))
    >>> trainer = Trainer(model, SGD(0.01), fused_embedding=FusedSGD(0.01))
    >>> losses = trainer.multi_step(batches, labels)   # K steps, on the device
    >>> history = trainer.fit(X, y, batch_size=16384, steps_per_call=8)
    >>> trainer.evaluate(X_test, y_test)               # {"auc", "logloss", "accuracy"}

    The model must lie on ``device`` (the card unless another device is
    named). Its outputs go to ``loss_fn(outputs, labels, batch)``, by default
    ``default_loss``: one logit per row, a ``(logits, aux)`` tuple (DIEN) or
    a list of per-task logits with ``[B, T]`` labels. ``optimizer`` (default
    ``Adam(1e-3)``, as the JAX package's) updates the dense parameters, and
    the tables too when ``fused_embedding`` is None; otherwise
    ``fused_embedding`` (``FusedAdagrad``, ``FusedSGD`` or ``FusedAdam``)
    updates the tables. ``weight_decay`` adds ``weight_decay * p`` to the
    gradient of every parameter ``optimizer`` updates, before it
    (``DecayedWeights``, the JAX package's ``optax.add_decayed_weights``
    chained in front). ``generator`` (default: seeded with ``seed`` on the
    device) draws dropout masks; ``seed`` also seeds ``fit``'s shuffling.
    ``mesh``, ``capacity_factor`` and ``explicit_lookup`` come with the
    distributed slice of the port.
    """

    def __init__(self, model: torch.nn.Module, optimizer=None,
                 fused_embedding: Optional[FusedOptimizer] = None, seed: int = 0,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, *,
                 loss_fn: Callable = default_loss, weight_decay: float = 0.0,
                 mesh=None, capacity_factor: Optional[float] = None,
                 explicit_lookup: bool = False):
        for name, given in (("mesh", mesh is not None),
                            ("capacity_factor", capacity_factor is not None),
                            ("explicit_lookup", explicit_lookup)):
            if given:
                raise NotImplementedError(
                    f"{name} comes with the distributed slice of the port")
        requested = resolve_device(device)
        devices = {p.device for p in model.parameters()}
        if len(devices) != 1:
            raise ValueError(f"model spread over devices {sorted(map(str, devices))}")
        (model_device,) = devices
        if (model_device.type != requested.type
                or requested.index not in (None, model_device.index)):
            raise ValueError(f"model lies on {model_device}, Trainer trains on {requested}")
        self.device = model_device
        self.model = model
        self.optimizer = optimizer if optimizer is not None else Adam(1e-3)
        if weight_decay:
            self.optimizer = DecayedWeights(self.optimizer, weight_decay)
        self.loss_fn = loss_fn
        self.fused_embedding = fused_embedding
        self.seed = seed
        self.generator = (generator if generator is not None
                          else torch.Generator(device=self.device).manual_seed(seed))
        self._collections = [(prefix, m) for prefix, m in model.named_modules()
                             if isinstance(m, EmbeddingCollection)]
        self.init()

    def init(self) -> "Trainer":
        """(Re)start the optimizer state and the step count from the model's
        current parameters."""
        params = dict(self.model.named_parameters())
        tables = {}
        if self.fused_embedding is not None:
            tables = {n: p for n, p in params.items()
                      if _STACK_KEY_RE.match(n.rsplit(".", 1)[-1])}
            if not tables:
                raise ValueError("fused_embedding set but the model has no "
                                 "embedding tables (table_d* parameters)")
        self.tables: Dict[str, torch.nn.Parameter] = tables
        self.dense_params = {n: p for n, p in params.items() if n not in tables}
        self.opt_state = self.optimizer.init(self.dense_params)
        self.fused_slots = {n: self.fused_embedding.init_slots(p.detach())
                            for n, p in tables.items()}
        self.step = 0
        return self

    # ------------------------------------------------------------------
    def train_step(self, batch: Mapping[str, torch.Tensor],
                   labels: torch.Tensor) -> torch.Tensor:
        """One step on a batch on the model's device; returns the loss as a
        0-d tensor on the device."""
        fused = self.fused_embedding is not None
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        try:
            if fused:
                for _, coll in self._collections:
                    coll.capture = []
            outputs = self.model(batch, generator=self.generator)
            loss = self.loss_fn(outputs, labels, batch)
            loss.backward()
            captured = [(prefix, coll.capture or []) for prefix, coll in self._collections]
        finally:
            for _, coll in self._collections:
                coll.capture = None
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.dense_params.items()}
        self.optimizer.update(self.dense_params, grads, self.opt_state, self.step)
        if fused:
            self._fused_update(captured)
        self.step += 1
        return loss.detach()

    def _fused_update(self, captured) -> None:
        """One stream per table: its captured sites concatenated, presorted
        when there is one site."""
        sites: Dict[str, list] = {}
        for prefix, records in captured:
            for rec in records:
                if rec.embeds.grad is not None:
                    name = f"{prefix}.{rec.table}" if prefix else rec.table
                    sites.setdefault(name, []).append(rec)
        for name, table in self.tables.items():
            recs = sites.get(name)
            if not recs:
                continue
            dim = table.shape[1]
            lids = torch.cat([r.rows for r in recs])
            ct = torch.cat([r.embeds.grad.reshape(-1, dim) for r in recs]).contiguous()
            presorted = recs[0].presorted() if len(recs) == 1 else None
            self.fused_embedding.apply(table.detach(), self.fused_slots[name], lids, ct,
                                       step=self.step, presorted=presorted)

    def multi_step(self, batches: Mapping[str, torch.Tensor],
                   labels: torch.Tensor) -> torch.Tensor:
        """K steps over batches already on the device, stacked on a leading
        axis (``[K, B, ...]`` leaves, labels ``[K, B]``); returns the K
        losses as a ``[K]`` tensor on the device."""
        losses = [self.train_step({k: v[i] for k, v in batches.items()}, labels[i])
                  for i in range(labels.shape[0])]
        return torch.stack(losses)

    def _to_device(self, xb: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device) for k, v in xb.items()}

    def fit(self, X: Mapping[str, np.ndarray], y: np.ndarray, batch_size: int = 256,
            epochs: int = 1, shuffle: bool = True, steps_per_call: int = 1):
        """Train; returns a history with each epoch's mean loss and examples/s.
        Batches go to the device in groups of ``steps_per_call``, each group
        one ``multi_step`` call (the last group may be shorter)."""
        history = {"loss": [], "examples_per_sec": []}
        for epoch in range(epochs):
            losses, group = [], []
            n_examples = 0
            t0 = time.perf_counter()
            batches = iter_batches(X, y, batch_size, shuffle=shuffle, seed=self.seed + epoch)
            for i, (xb, yb) in enumerate(batches, start=1):
                group.append((self._to_device(xb),
                              torch.as_tensor(yb, dtype=torch.float32, device=self.device)))
                n_examples += len(yb)
                if len(group) == steps_per_call:
                    losses.append(self._run_group(group))
                    group = []
            if group:
                losses.append(self._run_group(group))
            # reading the mean waits for the last step
            epoch_loss = float(torch.cat(losses).mean()) if losses else 0.0
            history["loss"].append(epoch_loss)
            history["examples_per_sec"].append(n_examples / (time.perf_counter() - t0))
        return history

    def _run_group(self, group) -> torch.Tensor:
        batches = {k: torch.stack([xb[k] for xb, _ in group]) for k in group[0][0]}
        return self.multi_step(batches, torch.stack([yb for _, yb in group]))

    # ------------------------------------------------------------------
    def _eval_logits(self, xb: Mapping[str, np.ndarray]) -> np.ndarray:
        """The model's logits on a batch (``logits_of``)."""
        return logits_of(self.model(self._to_device(xb))).cpu().numpy()

    def predict(self, X: Mapping[str, np.ndarray], batch_size: int = 1024,
                apply_sigmoid: bool = True) -> np.ndarray:
        self.model.eval()
        X, _, valid = pad_to_batch(X, None, batch_size)
        with torch.inference_mode():
            outs = [self._eval_logits(xb) for xb in
                    iter_batches(X, None, batch_size, shuffle=False, drop_remainder=False)]
        preds = np.concatenate(outs, axis=0)[valid]
        if apply_sigmoid:
            preds = 1.0 / (1.0 + np.exp(-preds))
        return preds

    def evaluate(self, X: Mapping[str, np.ndarray], y: np.ndarray,
                 batch_size: int = 1024, streaming: bool = False) -> Dict[str, float]:
        """Test metrics. ``streaming=True`` accumulates the histogram AUC,
        logloss and accuracy batch by batch; otherwise the AUC is exact. A
        multi-task model (``[B, T]`` predictions, ``[B, T]`` labels) gets
        ``task{t}_auc`` and ``task{t}_logloss`` per task."""
        if streaming:
            return self.evaluate_stream(iter_batches(X, y, batch_size, shuffle=False,
                                                     drop_remainder=False))
        probs = self.predict(X, batch_size)
        flat = probs[:, 0] if probs.ndim > 1 and probs.shape[1] == 1 else probs
        if flat.ndim == 1:
            return {"auc": metrics_lib.auc(y, flat),
                    "logloss": metrics_lib.logloss(y, flat),
                    "accuracy": metrics_lib.accuracy(y, flat)}
        y = np.asarray(y)
        out = {}
        for t in range(flat.shape[1]):
            out[f"task{t}_auc"] = metrics_lib.auc(y[..., t], flat[:, t])
            out[f"task{t}_logloss"] = metrics_lib.logloss(y[..., t], flat[:, t])
        return out

    def evaluate_stream(self, batches) -> Dict[str, float]:
        """Streaming metrics over a ``(batch_dict, labels)`` iterator; the
        logits of a batch are raveled (a tuple's first element)."""
        self.model.eval()
        stream = metrics_lib.StreamingAUC()
        ll_sum = 0.0
        correct = 0
        n = 0
        with torch.inference_mode():
            for xb, yb in batches:
                logits = self._eval_logits(xb).ravel()
                yb = np.asarray(yb)
                probs = 1.0 / (1.0 + np.exp(-logits))
                stream.update(yb, probs)
                p = np.clip(probs, 1e-7, 1 - 1e-7)
                ll_sum += float(-(yb * np.log(p) + (1 - yb) * np.log(1 - p)).sum())
                correct += int(((probs >= 0.5) == (yb > 0.5)).sum())
                n += len(yb)
        return {"auc": stream.result(), "logloss": ll_sum / max(n, 1),
                "accuracy": correct / max(n, 1)}
