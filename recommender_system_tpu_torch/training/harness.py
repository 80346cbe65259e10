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

Neither step reads a device value on the host. A step's scalars (the
learning rates, Adam's bias corrections) are computed on the host for the
steps of a call, as a ``[K, n]`` float32 table sent to the device with one
asynchronous copy, and each step reads its row there. So on a card the K
steps of a ``multi_step`` call are one dispatch, as the JAX package's
``lax.scan`` is: ``make_multi_step()`` returns a callable that runs the
steps one by one on the first call with a batch signature (K, each leaf's
shape and dtype), captures them into a CUDA graph on the second, and from
then on copies each call's inputs into the graph's and replays it, one
launch a call (``make_multi_step_packed(spec)`` does the same over packed
groups). Unlike the JAX package's pure ``TrainState``, the parameters live
in the model and the optimizer state in the Trainer, both updated in place
(``training/checkpoint.py`` saves and restores them), which is what a
graph reads and writes.

Under a mesh (``Trainer(mesh=make_mesh(...))``, ``parallel/``) each rank
holds its part of every ``table_d*`` (its rows; on a mesh with a model axis
under the plain step without ``explicit_lookup``, a wide table's row block
of 'data' and column slice of 'model', as the JAX rule places it) and its
rows of each global batch; the tables' gathers go through the all-to-all
exchange (``explicit_lookup``: at ``capacity_factor``, else at full
capacity), the model's outputs, the labels and the batch columns the loss
reads are gathered, so every rank computes the global batch's loss, as
GSPMD does; the replicated parameters' gradients are summed over ranks (one
``all_reduce``) and stay bitwise equal on every rank; MMOE's experts are
split over 'model' (``MMoELayer.shard``) and their gradients summed over
the ranks that hold the same experts; the fused step sends each table's
stream to its owners (``sharded_fused_update``), and the plain step's dense
optimizer updates each rank's part of a table with the exchange's gradient.
BatchNorm (and Dice) and DIEN's auxiliary loss take the global batch's
statistics. Dropout draws from a generator seeded from ``(seed, rank)``.

``fit`` trains in memory; ``fit_stream`` trains over an iterator of batches
(the out-of-core path of ``utils.datasets.stream_criteo``), staging each
batch, or K batches packed into one int32 and one float32 array, from
pinned memory with asynchronous copies, as the JAX package's
``_fit_stream_packed`` stages them. A model may take one tensor instead of
a dict of columns (``LSTMClassifier``, ``TransformerClassifier``).
"""
from __future__ import annotations

import dataclasses
import gc
import re
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..layers.embedding import EmbeddingCollection
from ..layers.interaction import MMoELayer
from ..ops.dispatch import DeviceLike, add_launches, launch_counts, resolve_device
from ..ops.fused_adagrad import (adam_scalars, fused_adagrad_apply, fused_adam_apply,
                                 fused_sgd_apply, step_scalars)
from ..parallel.fused import sharded_fused_update
from ..parallel.mesh import Mesh, Placement, gather_rows, rank_seed
from ..utils import metrics as metrics_lib
from ..utils.datasets import iter_batches, pad_to_batch
from .losses import default_loss, logits_of
from .optim import Adam, DecayedWeights, LearningRate, learning_rate_at

_STACK_KEY_RE = re.compile(r"^table_d(\d+)$")
_PACKAGE = Path(__file__).resolve().parent.parent

# a model's input: a dict of tensors, or one tensor (the sequence classifiers)
Batch = Union[Mapping[str, torch.Tensor], torch.Tensor]


def _map(fn: Callable, batch):
    """``fn`` on each leaf of a dict batch, or on a tensor batch."""
    if isinstance(batch, Mapping):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch)


def _gather_outputs(outputs, mesh: Mesh):
    """A model's outputs on the global batch: every tensor with a batch
    axis gathered over ranks (``gather_rows``), in tuples and lists alike;
    a 0-d tensor (DIEN's auxiliary loss) is global already."""
    if isinstance(outputs, (tuple, list)):
        return type(outputs)(_gather_outputs(o, mesh) for o in outputs)
    return outputs if outputs.dim() == 0 else gather_rows(outputs, mesh)


def _leaves(batch) -> list:
    """A dict batch's tensors in order, or a tensor batch as one."""
    return list(batch.values()) if isinstance(batch, Mapping) else [batch]


def _signature(*batches) -> tuple:
    """Each leaf's name, shape and dtype: what a captured graph is for."""
    out = []
    for batch in batches:
        items = batch.items() if isinstance(batch, Mapping) else [(None, batch)]
        out.extend((k, tuple(v.shape), v.dtype) for k, v in items)
    return tuple(out)


def _spec_key(spec) -> Optional[tuple]:
    """A packing layout (``Trainer._pack_spec``) as a dict key."""
    if spec is None:
        return None
    return tuple((kind, tuple(feats)) for kind, feats in spec.items())


def _issuing_line(err: BaseException) -> str:
    """Where the first error of a chain was raised: the innermost frame in
    this package (the line that issued the op), else the innermost one."""
    while err.__context__ is not None:
        err = err.__context__
    frames = traceback.extract_tb(err.__traceback__)
    ours = [f for f in frames if f.filename.startswith(str(_PACKAGE))]
    if not (ours or frames):
        return f"an op ({type(err).__name__}: {err})"
    f = (ours or frames)[-1]
    return f"{f.filename}:{f.lineno} ({f.line}): {type(err).__name__}: {err}"


@dataclasses.dataclass
class _StepGraph:
    """A captured call of K steps: its CUDA graph, the static tensors the
    graph reads (the inputs, the labels, the steps' scalars) and writes
    (the losses), and the kernel launches it holds (``launch_counts``
    keys)."""

    graph: "torch.cuda.CUDAGraph"
    inputs: Batch
    labels: torch.Tensor
    scalars: torch.Tensor
    losses: torch.Tensor
    launches: Dict[str, int]


class _GlobalBatch(Mapping):
    """A rank's batch as the loss sees it: each column the loss reads is
    gathered over ranks when it is first read."""

    def __init__(self, batch: Mapping[str, torch.Tensor], mesh: Mesh):
        self._batch, self._mesh, self._seen = batch, mesh, {}

    def __getitem__(self, key):
        if key not in self._seen:
            self._seen[key] = self._mesh.all_gather(self._batch[key])
        return self._seen[key]

    def __iter__(self):
        return iter(self._batch)

    def __len__(self):
        return len(self._batch)


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

    def scalars(self, step: int) -> Tuple[float, ...]:
        """The values its kernel reads from device memory at ``step``."""
        return (learning_rate_at(self.learning_rate, step),)

    def apply(self, table: torch.Tensor, slots: Tuple[torch.Tensor, ...],
              lids: torch.Tensor, ct: torch.Tensor, *, step: Optional[int] = None,
              scalars: Optional[torch.Tensor] = None,
              presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        """Update ``table`` and its ``slots`` in place at ``step``; the
        step's ``scalars(step)``, where given as a float32 tensor on the
        table's device (the ``Trainer`` gives them), are read from there."""
        fused_adagrad_apply(table, slots[0], lids, ct, eps=self.eps,
                            scalars=_on_device(self, table, step, scalars),
                            presorted=presorted)


def _on_device(cfg, table: torch.Tensor, step: Optional[int],
               scalars: Optional[torch.Tensor]) -> torch.Tensor:
    """A fused optimizer's scalars at ``step`` on the table's device: as
    given, or computed and copied there."""
    return scalars if scalars is not None else step_scalars(cfg.scalars(step), table.device)


@dataclasses.dataclass(frozen=True)
class FusedSGD:
    """Fused sparse SGD: ``param[row] -= lr * G`` on the touched rows of each
    ``table_d{d}``, in place (``fused_sgd_apply``); ``optax.sgd`` on the
    dense scatter-added gradient, with no slots. ``SGD(0.01)`` and
    ``FusedSGD(0.01)`` are the reference's training recipe."""

    learning_rate: LearningRate = 0.01

    def init_slots(self, table: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return ()

    def scalars(self, step: int) -> Tuple[float, ...]:
        return (learning_rate_at(self.learning_rate, step),)

    def apply(self, table: torch.Tensor, slots: Tuple[torch.Tensor, ...],
              lids: torch.Tensor, ct: torch.Tensor, *, step: Optional[int] = None,
              scalars: Optional[torch.Tensor] = None,
              presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        fused_sgd_apply(table, lids, ct, scalars=_on_device(self, table, step, scalars),
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

    def scalars(self, step: int) -> Tuple[float, ...]:
        """``(lr, bc1, bc2)``, the bias corrections reciprocal."""
        return adam_scalars(learning_rate_at(self.learning_rate, step), step, self.b1,
                            self.b2)

    def apply(self, table: torch.Tensor, slots: Tuple[torch.Tensor, ...],
              lids: torch.Tensor, ct: torch.Tensor, *, step: Optional[int] = None,
              scalars: Optional[torch.Tensor] = None,
              presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        fused_adam_apply(table, slots[0], slots[1], lids, ct, b1=self.b1, b2=self.b2,
                         eps=self.eps, scalars=_on_device(self, table, step, scalars),
                         presorted=presorted)


FusedOptimizer = Union[FusedAdagrad, FusedSGD, FusedAdam]


class Trainer:
    """Train, predict and evaluate a model of the port.

    >>> trainer = Trainer(model, Adagrad(0.05), fused_embedding=FusedAdagrad(0.05))
    >>> trainer = Trainer(model, SGD(0.01), fused_embedding=FusedSGD(0.01))
    >>> losses = trainer.multi_step(batches, labels)   # K steps, one graph replay
    >>> history = trainer.fit(X, y, batch_size=16384, steps_per_call=8)
    >>> history = trainer.fit_stream(stream_criteo(path, 16384), steps_per_call=8)
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
    device, or with ``rank_seed(seed, rank)`` under a mesh) draws dropout
    masks; ``seed`` also seeds ``fit``'s shuffling. ``step_generators``
    are the other CUDA generators a step draws from (a loss that samples
    negatives from its own): a captured graph registers them with
    ``generator``, so that each replay draws as the steps one by one would.

    On a card ``multi_step``, ``fit`` and the packed stream loop train
    through ``make_multi_step()`` and ``make_multi_step_packed(spec)``: a
    call of K steps is one CUDA graph replay from the second call with a
    batch signature on. A graph reads the tensors the Trainer held when it
    was captured: ``init()`` drops every graph (``drop_graphs``), and
    whatever replaces a parameter, a buffer or an optimizer state other
    than in place (``load_state_dict``, ``restore_checkpoint`` and
    ``convert``'s loaders copy in place) must call ``drop_graphs()``. Under
    a mesh the steps run one by one.

    ``mesh`` (``parallel.make_mesh``) trains over its ranks (see the module
    docstring): the Trainer shards the model's tables and must be built on
    every rank from the same model. ``multi_step`` and ``train_step`` then
    take this rank's rows of each batch; ``fit``, ``fit_stream``,
    ``predict`` and ``evaluate`` take global data and split it.
    ``capacity_factor`` bounds the exchange's buckets of the fused update
    and, with ``explicit_lookup``, of the train-mode lookup (without it the
    lookup runs at full capacity, the GSPMD gather's result); entries over
    capacity are dropped and counted (``take_overflow``, the history's
    ``embedding_overflow``). Both are ignored without a mesh, as in the JAX
    package.
    """

    def __init__(self, model: torch.nn.Module, optimizer=None,
                 fused_embedding: Optional[FusedOptimizer] = None, seed: int = 0,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, *,
                 loss_fn: Callable = default_loss, weight_decay: float = 0.0,
                 mesh: Optional[Mesh] = None, capacity_factor: float = 2.0,
                 explicit_lookup: bool = False,
                 step_generators: Sequence[torch.Generator] = ()):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh (make_mesh), not "
                            f"{type(mesh).__name__}")
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
        self.mesh, self.capacity_factor = mesh, capacity_factor
        self.explicit_lookup = explicit_lookup
        self.generator = (generator if generator is not None
                          else torch.Generator(device=self.device).manual_seed(
                              seed if mesh is None else rank_seed(seed, mesh.rank)))
        self.step_generators = tuple(step_generators)
        self._collections = [(prefix, m) for prefix, m in model.named_modules()
                             if isinstance(m, EmbeddingCollection)]
        # under a mesh: each sharded parameter's name -> its placement
        self.sharded: Dict[str, Placement] = {}
        if mesh is not None:
            self._shard_model()
        self.init()

    def _shard_model(self) -> None:
        """Shard every collection's tables (by column where the JAX rule
        does: the plain step without the explicit lookup) and MMOE's
        experts, and point BatchNorm and DIEN at the mesh. The replicated
        parameters are each rank's own: every rank builds the model from the
        same seed, as the JAX package places one initial state on every
        device."""
        mesh = self.mesh
        if self.device != mesh.device:
            raise ValueError(f"model lies on {self.device}, the mesh's ranks on {mesh.device}")
        lookup_capacity = self.capacity_factor if self.explicit_lookup else None
        column_sharding = self.fused_embedding is None and not self.explicit_lookup
        for prefix, m in self.model.named_modules():
            if isinstance(m, EmbeddingCollection):
                m.shard(mesh, lookup_capacity, column_sharding)
            elif isinstance(m, MMoELayer):
                m.shard(mesh)
            else:
                if hasattr(type(m), "mesh"):
                    m.mesh = mesh
                continue
            for local, placement in m.placements.items():
                self.sharded[f"{prefix}.{local}" if prefix else local] = placement

    def whole(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        """Parameter ``name``'s tensor (or an optimizer state of its shape)
        in the single-device layout: gathered where the mesh shards it (a
        collective), else as it is."""
        placement = self.sharded.get(name)
        return tensor if placement is None else placement.unshard(tensor, self.mesh)

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
        self._overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        self.drop_graphs()
        return self

    def drop_graphs(self) -> None:
        """Forget every captured graph and every signature's first call, so
        that the next call of a signature runs step by step and the one
        after captures anew. ``init()`` calls it; so must whatever replaces
        a tensor the steps read other than in place."""
        # the captured calls (by packing layout and batch signature), the
        # signatures whose first call has run, the graphs' memory pool and
        # capture stream, and the cached K-step callables
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._warmed = set()
        self._pool = None
        self._capture_stream = None
        self._multi = None
        self._packed_multi: Dict[tuple, Callable] = {}

    @property
    def captures(self) -> bool:
        """True where a K-step call is captured as a CUDA graph: on a card,
        without a mesh (its collectives are not captured)."""
        return self.device.type == "cuda" and self.mesh is None

    @property
    def tracks_overflow(self) -> bool:
        """True where steps count overflow: under a mesh with a fused
        optimizer, as in the JAX package."""
        return self.mesh is not None and self.fused_embedding is not None

    def take_overflow(self) -> int:
        """The entries the exchange dropped since the last call, summed
        over ranks (a collective that waits for the device), and reset."""
        total = self._overflow.clone()
        self._overflow.zero_()
        if self.mesh is not None:
            self.mesh.all_reduce_(total)
        return int(total)

    # ------------------------------------------------------------------
    def train_step(self, batch: Mapping[str, torch.Tensor],
                   labels: torch.Tensor) -> torch.Tensor:
        """One step on a batch on the model's device (under a mesh, this
        rank's rows of the batch), issued op by op; returns the loss (the
        global batch's) as a 0-d tensor on the device."""
        return self._train_step(batch, labels, self._stage_scalars(1)[0])

    def _stage_scalars(self, k: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The scalars of steps ``self.step .. self.step + k - 1`` as a
        ``[k, n]`` float32 table on the device (into ``out`` where given):
        each row the dense optimizer's ``scalars(step)``, then the fused
        optimizer's. On a card one asynchronous copy from a pinned buffer
        that torch's pinned allocator hands out anew and reuses only after
        the copies that read it have finished."""
        rows = []
        for step in range(self.step, self.step + k):
            dense = tuple(self.optimizer.scalars(step))
            fused = () if self.fused_embedding is None else self.fused_embedding.scalars(step)
            rows.append(dense + tuple(fused))
        self._n_dense = len(dense)
        host = torch.tensor(rows, dtype=torch.float32)
        if self.device.type == "cuda":
            host = host.pin_memory()
        if out is None:
            return host.to(self.device, non_blocking=True)
        return out.copy_(host, non_blocking=True)

    def _train_step(self, batch: Mapping[str, torch.Tensor], labels: torch.Tensor,
                    scalars: torch.Tensor) -> torch.Tensor:
        """``train_step`` reading the step's scalars from ``scalars``, a row
        of ``_stage_scalars``' table."""
        fused = self.fused_embedding is not None
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        try:
            if fused:
                for _, coll in self._collections:
                    coll.capture = []
            outputs = self.model(batch, generator=self.generator)
            if self.mesh is not None:
                outputs = _gather_outputs(outputs, self.mesh)
                labels = self.mesh.all_gather(labels)
                if isinstance(batch, Mapping):
                    batch = _GlobalBatch(batch, self.mesh)
            loss = self.loss_fn(outputs, labels, batch)
            loss.backward()
            captured = [(prefix, coll.capture or []) for prefix, coll in self._collections]
        finally:
            for _, coll in self._collections:
                coll.capture = None
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.dense_params.items()}
        if self.mesh is not None:
            self._sum_replicated(grads)
        self.optimizer.update(self.dense_params, grads, self.opt_state, self.step,
                              scalars[:self._n_dense])
        if fused:
            self._fused_update(captured, scalars[self._n_dense:])
        self.step += 1
        return loss.detach()

    def _sum_replicated(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum the gradients of the parameters each rank holds whole over
        ranks in place, in one ``all_reduce`` of their concatenation: each
        rank's gradient is the global loss's through its own rows, so the
        sum is the whole. An expert slice's gradient covers its data group's
        rows and is summed over the ranks that hold the same experts; a
        table's part has the exchange's gradient already."""
        groups = {"replicated": [], "experts": []}
        for n in grads:
            kind = self.sharded[n].kind if n in self.sharded else "replicated"
            if kind in groups:
                groups[kind].append(n)
        for kind, names in groups.items():
            if not names:
                continue
            axis = self.mesh if kind == "replicated" else self.mesh.data_axis
            flat = axis.all_reduce_(torch.cat([grads[n].reshape(-1) for n in names]))
            for name, part in zip(names, flat.split([grads[n].numel() for n in names])):
                grads[name] = part.view_as(grads[name])

    def _fused_update(self, captured, scalars: torch.Tensor) -> None:
        """One stream per table: its captured sites concatenated, presorted
        when there is one site; under a mesh, sent to the owners
        (``sharded_fused_update``), every rank taking part in each table's
        exchange, and the overflow counted."""
        sites: Dict[str, list] = {}
        for prefix, records in captured:
            for rec in records:
                if rec.overflow is not None:
                    self._overflow += rec.overflow
                if rec.embeds.grad is not None:
                    name = f"{prefix}.{rec.table}" if prefix else rec.table
                    sites.setdefault(name, []).append(rec)
        for name, table in self.tables.items():
            recs = sites.get(name, [])
            if not recs and self.mesh is None:
                continue
            dim = table.shape[1]
            if recs:
                lids = torch.cat([r.rows for r in recs])
                ct = torch.cat([r.embeds.grad.reshape(-1, dim) for r in recs]).contiguous()
            else:  # a rank with no stream still takes part in the exchange
                lids = torch.zeros(0, dtype=torch.int64, device=self.device)
                ct = torch.zeros(0, dim, device=self.device)
            if self.mesh is not None:
                self._overflow += sharded_fused_update(
                    self.fused_embedding, table.detach(), self.fused_slots[name], lids, ct,
                    self.mesh, step=self.step, scalars=scalars,
                    capacity_factor=self.capacity_factor)
                continue
            presorted = recs[0].presorted() if len(recs) == 1 else None
            self.fused_embedding.apply(table.detach(), self.fused_slots[name], lids, ct,
                                       step=self.step, scalars=scalars, presorted=presorted)

    def multi_step(self, batches: Batch, labels: torch.Tensor) -> torch.Tensor:
        """K steps over batches already on the device, stacked on a leading
        axis (``[K, B, ...]`` leaves, or one ``[K, B, ...]`` tensor for a
        model that takes a tensor; labels ``[K, B]``); returns the K losses
        as a ``[K]`` tensor on the device. The call goes through the cached
        ``make_multi_step()`` callable: on a card, one graph replay."""
        if self._multi is None:
            self._multi = self.make_multi_step()
        return self._multi(batches, labels)

    def make_multi_step(self, graphed: bool = True) -> Callable[[Batch, torch.Tensor],
                                                                 torch.Tensor]:
        """The K-step call, counterpart of the JAX package's jitted
        ``lax.scan``: ``run(batches, labels) -> losses [K]``, its arguments
        as ``multi_step``'s. The state is the Trainer's, updated in place.

        On a card without a mesh the K steps are one dispatch. The first
        call with a batch signature (K, each leaf's shape and dtype) runs
        them one by one on the capture stream: it builds the kernels, makes
        the libraries' workspaces and whatever a step makes at first use,
        and its steps are real steps. The second call captures them into a
        CUDA graph (the dropout generator and ``step_generators``
        registered, every signature's graph in one memory pool) and replays
        it; every later call copies its inputs and the steps' scalars into
        the graph's tensors and replays it. The losses returned are a copy,
        since the next replay overwrites the graph's. A failed capture
        raises, naming the line that issued the op. ``graphed=False``, a CPU
        device or a mesh (its collectives are not captured) give the steps
        one by one, the plain version of the call."""
        return lambda batches, labels: self._steps(None, batches, labels, graphed)

    def make_multi_step_packed(self, spec, graphed: bool = True) -> Callable:
        """``make_multi_step`` over packed groups: ``run(packed, labels) ->
        losses [K]`` with ``packed`` ``{kind: [K, B, W]}`` (int32 for 'i',
        float32 for 'f'; ``_pack_group``'s arrays on the device) and labels
        ``[K, B]``, ``spec`` the layout (``_pack_spec``). The columns are
        cut from the packed arrays inside the steps (inside the graph)."""
        return lambda packed, labels: self._steps(spec, packed, labels, graphed)

    def _packed_call(self, spec) -> Callable:
        """The cached ``make_multi_step_packed(spec)`` callable, one a
        layout, as the JAX package caches its packed scan."""
        key = _spec_key(spec)
        if key not in self._packed_multi:
            self._packed_multi[key] = self.make_multi_step_packed(spec)
        return self._packed_multi[key]

    def _loop(self, spec, inputs: Batch, labels: torch.Tensor,
              scalars: torch.Tensor) -> torch.Tensor:
        """The K steps one by one; step i reads row i of ``scalars``."""
        batches = inputs if spec is None else self._unpack(spec, inputs)
        losses = [self._train_step(_map(lambda v, i=i: v[i], batches), labels[i], scalars[i])
                  for i in range(labels.shape[0])]
        return torch.stack(losses)

    def _steps(self, spec, inputs: Batch, labels: torch.Tensor,
               graphed: bool) -> torch.Tensor:
        k = labels.shape[0]
        if not (graphed and self.captures):
            return self._loop(spec, inputs, labels, self._stage_scalars(k))
        key = (_spec_key(spec), _signature(inputs, labels))
        entry = self._graphs.get(key)
        with torch.cuda.device(self.device):
            if entry is None and key not in self._warmed:
                self._warmed.add(key)
                return self._warm_up(spec, inputs, labels)
            if entry is None:
                entry = self._graphs[key] = self._capture(spec, inputs, labels)
            return self._replay(entry, inputs, labels)

    def _side_stream(self) -> torch.cuda.Stream:
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        return self._capture_stream

    def _warm_up(self, spec, inputs: Batch, labels: torch.Tensor) -> torch.Tensor:
        """A signature's first call: the steps one by one on the capture
        stream, ordered after and before the caller's stream."""
        main, side = torch.cuda.current_stream(self.device), self._side_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            losses = self._loop(spec, inputs, labels, self._stage_scalars(labels.shape[0]))
        main.wait_stream(side)
        losses.record_stream(main)
        return losses

    def _capture(self, spec, inputs: Batch, labels: torch.Tensor) -> _StepGraph:
        """Capture the K steps over new static tensors of the inputs'
        shapes. Capturing runs nothing: the step count and the launch counts
        are put back as they were, and the launches the graph holds are
        kept for its replays."""
        k = labels.shape[0]
        inputs_ = _map(torch.empty_like, inputs)
        labels_ = torch.empty_like(labels)
        scalars = torch.zeros_like(self._stage_scalars(k))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for g in dict.fromkeys((self.generator, *self.step_generators)):
            if g.device.type == "cuda":
                graph.register_generator_state(g)
        step, counts = self.step, launch_counts()
        # a collection during the capture could destroy a graph that is
        # garbage (an earlier Trainer's, in a reference cycle), and
        # destroying a graph while a stream captures invalidates the
        # capture: collect first, and hold the collector until it ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._side_stream()):
                losses = self._loop(spec, inputs_, labels_, scalars)
        except Exception as err:
            raise RuntimeError(f"capturing {k} training steps into a CUDA graph failed at "
                               f"{_issuing_line(err)}") from err
        finally:
            if collecting:
                gc.enable()
            self.step = step
            held = {key: n - counts[key] for key, n in launch_counts().items()}
            add_launches({key: -n for key, n in held.items()})
        return _StepGraph(graph, inputs_, labels_, scalars, losses,
                          {key: n for key, n in held.items() if n})

    def _replay(self, entry: _StepGraph, inputs: Batch, labels: torch.Tensor) -> torch.Tensor:
        for static, value in zip(_leaves(entry.inputs), _leaves(inputs)):
            static.copy_(value, non_blocking=True)
        entry.labels.copy_(labels, non_blocking=True)
        self._stage_scalars(labels.shape[0], out=entry.scalars)
        entry.graph.replay()
        self.step += labels.shape[0]
        add_launches(entry.launches)
        return entry.losses.clone()

    def _to_device(self, xb) -> Batch:
        return _map(lambda v: torch.as_tensor(v, device=self.device), xb)

    def fit(self, X, y: np.ndarray, batch_size: int = 256, epochs: int = 1,
            shuffle: bool = True, steps_per_call: int = 1, log_every: int = 0):
        """Train; returns a history with each epoch's mean loss and examples/s.
        ``X`` is a dict of arrays, or one array for a model that takes a
        tensor. Each epoch draws its order from ``seed + epoch``, as the JAX
        package's ``fit``. Batches go to the device in groups of
        ``steps_per_call``, each group one ``multi_step`` call; a shorter
        last group trains step by step (``train_step``), so that no graph
        is captured for it. ``log_every`` prints the last loss whenever
        the steps done are a multiple of it, which waits for the device.
        Under a mesh every rank passes the whole data and trains on its rows
        of each batch; with a fused optimizer the history counts each
        epoch's ``embedding_overflow``, summed over ranks."""
        history = {"loss": [], "examples_per_sec": []}
        for epoch in range(epochs):
            losses, group = [], []
            n_examples = steps = 0
            self._overflow.zero_()
            t0 = time.perf_counter()
            batches = iter_batches(X, y, batch_size, shuffle=shuffle, seed=self.seed + epoch)
            for xb, yb in batches:
                n_examples += len(yb)
                if self.mesh is not None:
                    xb, yb = self.mesh.shard_batch(xb), self.mesh.shard_batch(yb)
                group.append((self._to_device(xb),
                              torch.as_tensor(yb, dtype=torch.float32, device=self.device)))
                if len(group) == steps_per_call:
                    losses.append(self._run_group(group))
                    steps += len(group)
                    group = []
                if log_every and steps and steps % log_every == 0:
                    print(f"epoch {epoch} step {steps} loss {float(losses[-1][-1]):.4f}")
            if group:  # a short last group: single steps, as the JAX package's fit
                losses.append(torch.stack([self.train_step(xb, yb) for xb, yb in group]))
            # reading the mean waits for the last step
            epoch_loss = float(torch.cat(losses).mean()) if losses else 0.0
            history["loss"].append(epoch_loss)
            history["examples_per_sec"].append(n_examples / (time.perf_counter() - t0))
            if self.tracks_overflow:
                history.setdefault("embedding_overflow", []).append(self.take_overflow())
        return history

    def _run_group(self, group) -> torch.Tensor:
        first = group[0][0]
        if isinstance(first, Mapping):
            batches = {k: torch.stack([xb[k] for xb, _ in group]) for k in first}
        else:
            batches = torch.stack([xb for xb, _ in group])
        return self.multi_step(batches, torch.stack([yb for _, yb in group]))

    # ------------------------------------------------------------------
    # the out-of-core loop

    def _stage(self, array: np.ndarray) -> torch.Tensor:
        """An asynchronous host-to-device copy of ``array``, from pinned
        memory on a card (torch's pinned allocator reuses a buffer only after
        the copy that read it has finished)."""
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def fit_stream(self, batches, log_every: int = 0, steps_per_call: int = 1,
                   checkpoint_every: int = 0, checkpoint_fn: Optional[Callable] = None,
                   max_steps: int = 0, timings: Optional[dict] = None):
        """Train over a ``(batch_dict, labels)`` iterator (the out-of-core
        path); returns a history like :meth:`fit`'s with one entry for the
        whole stream.

        ``steps_per_call == 1``: each batch is staged (every leaf copied
        from pinned memory, asynchronously) before the step of the one
        before it is issued. ``steps_per_call > 1``: K batches are packed
        into one int32 and one float32 array and one labels array (one
        copy each from pinned memory) and trained in one call of the cached
        ``make_multi_step_packed(spec)`` callable (on a card, one graph
        replay), pipelined one group deep as the JAX package's
        ``_fit_stream_packed`` is; a batch of another size (a short last
        one), and a tail of fewer than K batches, train step by step, in
        order.

        ``checkpoint_every`` calls ``checkpoint_fn(trainer, steps_done)``
        every that many steps; ``max_steps`` stops after that many steps (0:
        run the stream dry). On the packed path both act a group at a time,
        as in the JAX package. The host waits for the device only to print
        (``log_every``), to save a checkpoint and at the end.

        ``timings``, where given, accumulates the host's seconds in
        ``input_s`` (waiting for the next batch), ``pack_s`` (packing into
        pinned memory), ``copy_s`` (issuing the copies) and ``step_s``
        (issuing the steps), and a pair of CUDA events around each call
        in ``events`` (on a card).

        Under a mesh every rank reads the whole stream and trains on its
        rows of each batch (examples/s counts the global batches), a batch
        at a time whatever ``steps_per_call`` is, as the JAX package's
        does: there the K-step call is a loop of steps anyway, and
        ``checkpoint_every`` and ``max_steps`` act a step at a time. With a
        fused optimizer the history has the stream's
        ``embedding_overflow``, summed over ranks."""
        clock = timings if timings is not None else {}
        for key in ("input_s", "pack_s", "copy_s", "step_s"):
            clock.setdefault(key, 0.0)
        if timings is not None and self.device.type == "cuda":
            clock.setdefault("events", [])
        self._overflow.zero_()
        if self.mesh is not None:
            mesh = self.mesh
            batches = ((mesh.shard_batch(xb), mesh.shard_batch(np.asarray(yb)))
                       for xb, yb in batches)
        if steps_per_call > 1 and self.mesh is None:
            history = self._fit_stream_packed(batches, log_every, steps_per_call,
                                              checkpoint_every, checkpoint_fn, max_steps, clock)
        else:
            history = self._fit_stream_batches(batches, log_every, checkpoint_every,
                                               checkpoint_fn, max_steps, clock)
        if self.mesh is not None:
            history["examples_per_sec"] = [v * self.mesh.n for v in history["examples_per_sec"]]
        if self.tracks_overflow:
            history["embedding_overflow"] = [self.take_overflow()]
        return history

    def _fit_stream_batches(self, batches, log_every, checkpoint_every, checkpoint_fn,
                            max_steps, clock):
        """The stream a batch at a time, the next batch staged before this
        one's step is issued."""
        losses = []
        n_examples = 0
        it = iter(batches)

        def pull():
            t0 = time.perf_counter()
            item = next(it, None)
            clock["input_s"] += time.perf_counter() - t0
            if item is None:
                return None
            t0 = time.perf_counter()
            xb, yb = item
            staged = (_map(lambda v: self._stage(np.asarray(v)), xb),
                      self._stage(np.asarray(yb, np.float32)))
            clock["copy_s"] += time.perf_counter() - t0
            return staged

        t_start = time.perf_counter()
        nxt = pull()
        while nxt is not None:
            xb, yb = nxt
            nxt = pull()  # stage the next batch before this step is issued
            losses.append(self._timed_call(clock, self.multi_step, _map(lambda v: v[None], xb),
                                           yb[None]))
            n_examples += int(yb.shape[0])
            if log_every and len(losses) % log_every == 0:
                print(f"stream step {len(losses)} loss {float(losses[-1][-1]):.4f}")
            if checkpoint_every and checkpoint_fn is not None \
                    and len(losses) % checkpoint_every == 0:
                checkpoint_fn(self, len(losses))
            if max_steps and len(losses) >= max_steps:
                break
        history = {"loss": [], "examples_per_sec": []}
        flat = torch.cat(losses) if losses else torch.zeros(0)
        history["loss"].append(float(flat.mean()) if losses else 0.0)
        history["examples_per_sec"].append(
            n_examples / max(time.perf_counter() - t_start, 1e-9))
        return history

    def _timed_call(self, clock: dict, fn: Callable, *args) -> torch.Tensor:
        """``fn(*args)`` (a K-step call, or ``train_step``), its host time
        counted in ``step_s`` and, where ``clock`` keeps ``events``, CUDA
        events recorded around it; returns its losses as a ``[K]`` tensor."""
        events = None
        if "events" in clock:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        losses = fn(*args).reshape(-1)
        clock["step_s"] += time.perf_counter() - t0
        if events is not None:
            events[1].record()
            clock["events"].append(events)
        return losses

    @staticmethod
    def _pack_spec(batch: Mapping[str, np.ndarray]) -> Dict[str, list]:
        """The packing layout of a sample batch: for each kind ('i' integer,
        'f' float), its ``(name, width, trailing shape, dtype)`` columns in
        order."""
        spec = {"i": [], "f": []}
        for k, v in batch.items():
            v = np.asarray(v)
            kind = "i" if v.dtype.kind in "iub" else "f"
            width = int(np.prod(v.shape[1:])) if v.ndim > 1 else 1
            spec[kind].append((k, width, tuple(v.shape[1:]), v.dtype))
        return {kind: feats for kind, feats in spec.items() if feats}

    def _pack_group(self, spec, group) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """K ``(batch, labels)`` pairs -> ({kind: [K, B, W]}, labels [K, B,
        ...]), written straight into pinned host buffers (on a card).
        Integer features are packed as int32: ids outside its range raise,
        as the JAX package's ``_pack_group`` does."""
        pin = self.device.type == "cuda"
        K, B = len(group), len(group[0][1])
        packed = {}
        for kind, feats in spec.items():
            dtype = torch.int32 if kind == "i" else torch.float32
            width = sum(w for _, w, _, _ in feats)
            buf = torch.empty((K, B, width), dtype=dtype, pin_memory=pin)
            out = buf.numpy()
            for j, (xb, _) in enumerate(group):
                off = 0
                for k, w, _, _ in feats:
                    a = np.asarray(xb[k]).reshape(B, -1)
                    if (kind == "i" and a.dtype.itemsize > 4 and a.size
                            and (a.max() >= 2 ** 31 or a.min() < -(2 ** 31))):
                        raise ValueError(
                            f"packed stream: feature {k!r} has {a.dtype} ids outside "
                            f"int32 range; hash/bucket them below 2^31 or use "
                            f"steps_per_call=1")
                    out[j, :, off:off + w] = a
                    off += w
            packed[kind] = buf
        labels = torch.from_numpy(np.stack([np.asarray(yb, np.float32) for _, yb in group]))
        if pin:
            labels = labels.pin_memory()
        return packed, labels

    @staticmethod
    def _unpack(spec, packed: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """[K, B, W] arrays on the device -> the batches' ``[K, B, ...]``
        leaves in their dtypes (views where the dtype is the packed one)."""
        batches = {}
        for kind, feats in spec.items():
            arr = packed[kind]
            K, B = arr.shape[:2]
            off = 0
            for k, w, shape, dtype in feats:
                leaf = arr[:, :, off:off + w].reshape((K, B) + shape)
                off += w
                want = torch.from_numpy(np.empty(0, dtype)).dtype
                batches[k] = leaf if leaf.dtype == want else leaf.to(want)
        return batches

    def _fit_stream_packed(self, batches, log_every, steps_per_call, checkpoint_every,
                           checkpoint_fn, max_steps, clock):
        """Packed groups of ``steps_per_call`` batches, pipelined one group
        deep: group n + 1 is packed and its copies issued before group n's
        call is issued (the call then copies the group from the device into
        its graph's tensors, about 40 MB for a DeepFM group)."""
        spec = multi = None
        expected_b = None
        loss_chunks = []
        n_examples = steps = 0
        group = []
        staged = None

        def stage(g):
            t0 = time.perf_counter()
            packed, labels = self._pack_group(spec, g)
            t1 = time.perf_counter()
            on_device = ({k: v.to(self.device, non_blocking=True) for k, v in packed.items()},
                         labels.to(self.device, non_blocking=True))
            clock["pack_s"] += t1 - t0
            clock["copy_s"] += time.perf_counter() - t1
            return on_device

        def dispatch(staged_group):
            nonlocal steps
            losses = self._timed_call(clock, multi, *staged_group)
            loss_chunks.append(losses)
            steps += steps_per_call
            if log_every and steps % log_every < steps_per_call:
                print(f"stream step {steps} loss {float(losses[-1]):.4f}")
            if (checkpoint_every and checkpoint_fn is not None
                    and steps % checkpoint_every < steps_per_call):
                checkpoint_fn(self, steps)

        def flush_single(items):
            nonlocal steps
            for xb, yb in items:
                t0 = time.perf_counter()
                xd = {k: self._stage(np.asarray(v)) for k, v in xb.items()}
                yd = self._stage(np.asarray(yb, np.float32))
                clock["copy_s"] += time.perf_counter() - t0
                loss_chunks.append(self._timed_call(clock, self.train_step, xd, yd))
                steps += 1

        t_start = time.perf_counter()
        stopped = False
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            clock["input_s"] += time.perf_counter() - t0
            if item is None:
                break
            xb, yb = item
            if max_steps and steps >= max_steps:
                stopped = True  # drop the staged group, as the JAX loop does
                break
            B = len(yb)
            n_examples += B
            if spec is None:
                spec = self._pack_spec(xb)
                multi = self._packed_call(spec)
                expected_b = B
            if B != expected_b:
                # a batch of another size: run everything pending in order
                if staged is not None:
                    dispatch(staged)
                    staged = None
                flush_single(group + [(xb, yb)])
                group = []
                continue
            group.append((xb, yb))
            if len(group) == steps_per_call:
                nxt = stage(group)
                group = []
                if staged is not None:
                    dispatch(staged)
                staged = nxt
        if not stopped:
            if staged is not None:
                dispatch(staged)
            flush_single(group)  # the tail of fewer than K batches
        history = {"loss": [], "examples_per_sec": []}
        if loss_chunks:
            flat = torch.cat(loss_chunks)
            history["loss"].append(float(flat.mean()))  # waits for the last step
            history["examples_per_sec"].append(
                n_examples / max(time.perf_counter() - t_start, 1e-9))
        return history

    # ------------------------------------------------------------------
    def _eval_logits(self, xb: Mapping[str, np.ndarray]) -> np.ndarray:
        """The model's logits on a batch (``logits_of``). Under a mesh (a
        collective) each rank scores its rows of the batch, padded with
        copies of its last row to a multiple of the ranks, and the logits
        are gathered."""
        if self.mesh is None:
            return logits_of(self.model(self._to_device(xb))).cpu().numpy()
        b = len(next(iter(xb.values()))) if isinstance(xb, Mapping) else len(xb)
        pad = (-b) % self.mesh.n
        if pad:
            xb = _map(lambda v: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]), xb)
        local = self._to_device(self.mesh.shard_batch(xb))
        return self.mesh.all_gather(logits_of(self.model(local))).cpu().numpy()[:b]

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
