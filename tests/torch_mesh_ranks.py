"""Four gloo ranks on the CPU for the port's mesh tests, and what they run.

``RankPool(world, directory)`` spawns ``world`` processes that join one
gloo group through a file in ``directory`` (``init_method="file://..."``,
so parallel test workers never share a port), each with one torch thread.
``pool.run(fn, *args)`` runs ``fn(mesh, *args)`` on every rank, with the
mesh of the whole group, and returns the ranks' results in rank order
(``pool.run(on_grid, (data, model), fn, *args)`` runs ``fn`` on a
``make_mesh(data, model)`` of the same ranks, made once a process); a
rank that raises fails the call with its traceback, and a call that does
not end within its timeout fails instead of hanging. After a failure the
ranks are started anew for the next call.

This module imports torch and the port, never JAX: the ranks run the port,
and the tests hold what they return against the JAX package in the parent.
The functions the ranks run live here, so that a rank imports them by name.
"""
from __future__ import annotations

import datetime
import itertools
import os
import queue
import time
import traceback
from typing import Dict, Optional

import multiprocessing as mp
import numpy as np
import torch
import torch.distributed as dist

from recommender_system_tpu_torch import (DIEN, DIN, DSSM, FFM, MMOE, DeepFM, FusedAdagrad,
                                          FusedAdam, FusedSGD, Trainer)
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params
from recommender_system_tpu_torch.parallel import (alltoall_lookup, alltoall_take, gspmd_lookup,
                                                   make_mesh, sharded_fused_update,
                                                   sharded_lookup)
from recommender_system_tpu_torch.parallel.fused import column_take, stream_slice
from recommender_system_tpu_torch.parallel.mesh import Placement
from recommender_system_tpu_torch.parallel.launch import host_batch_slice, make_pod_mesh
from recommender_system_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from recommender_system_tpu_torch.utils import logging as tlogging
from recommender_system_tpu_torch.training import SGD, Adagrad, Adam, default_loss
from recommender_system_tpu_torch.training.losses import inbatch_softmax_loss
from recommender_system_tpu_torch.utils import features as tfeatures

WORLD = 4
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=90)


def _serve(rank: int, world: int, init_file: str, tasks, results) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)
    mesh = make_mesh(world)
    while True:
        item = tasks.get()
        if item is None:
            break
        fn, args = item
        try:
            results.put((rank, True, fn(mesh, *args)))
        except Exception:  # reported to the parent, which fails the test
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks serving calls (see the module docstring)."""

    def __init__(self, world: int, directory) -> None:
        self.world, self.directory = world, str(directory)
        self._names = itertools.count()
        self._ctx = mp.get_context("spawn")
        self.procs = []
        self._start()

    def _start(self) -> None:
        init_file = os.path.join(self.directory, f"group-{next(self._names)}")
        self.tasks = [self._ctx.Queue() for _ in range(self.world)]
        self.results = self._ctx.Queue()
        self.procs = [self._ctx.Process(target=_serve, daemon=True,
                                        args=(r, self.world, init_file, self.tasks[r],
                                              self.results))
                      for r in range(self.world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = 60.0) -> list:
        if not self.procs:
            self._start()
        for q in self.tasks:
            q.put((fn, args))
        out: Dict[int, object] = {}
        errors = []
        deadline = time.monotonic() + timeout
        while len(out) + len(errors) < self.world:
            try:
                rank, ok, value = self.results.get(
                    timeout=max(deadline - time.monotonic(), 0.1) if not errors else 5.0)
            except queue.Empty:
                break
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if len(out) < self.world:
            self.close()
            missing = sorted(set(range(self.world)) - set(out))
            raise RuntimeError(f"{fn.__name__} failed or hung on ranks {missing}\n"
                               + "\n".join(errors))
        return [out[r] for r in range(self.world)]

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self.procs = []


# ---------------------------------------------------------------------------
# models and trainers, built alike on the ranks and in the parent

def schema(kind: str, mod, vocab: int = 64, dim: int = 8, T: int = 8):
    """DIN's, DIEN's and DSSM's columns (``tests/test_fused_mesh.py``'s
    ``_din_setup``) in the features module ``mod`` (the port's or the JAX
    package's)."""
    cols = [mod.SparseFeat("user_id", vocab, dim),
            mod.SparseFeat("item_id", vocab, dim, embedding_name="item_id"),
            mod.VarLenSparseFeat(mod.SparseFeat("hist_item_id", vocab, dim,
                                                embedding_name="item_id"), maxlen=T),
            mod.DenseFeat("price", 1)]
    if kind == "dien":
        cols.append(mod.VarLenSparseFeat(mod.SparseFeat("neg_hist_item_id", vocab, dim,
                                                        embedding_name="item_id"), maxlen=T))
    return cols


def _generator():
    return torch.Generator().manual_seed(0)


def build_model(kind: str, spec: dict, params: Optional[dict] = None,
                stats: Optional[dict] = None):
    """A port model on the CPU, filled with the JAX package's variables
    where they are given (else the port's own draws from a fixed seed)."""
    kw = dict(device="cpu", generator=_generator())
    if kind == "deepfm":
        model = DeepFM(spec["columns"], hidden_units=spec["hidden"], **kw)
    elif kind == "din":
        model = DIN(schema("din", tfeatures, **spec.get("schema", {})),
                    behavior_feature_list=("item_id",), hidden_units=spec["hidden"],
                    att_hidden_units=spec["att"], **kw)
    elif kind == "dien":
        model = DIEN(schema("dien", tfeatures), behavior_feature_list=("item_id",),
                     use_negsampling=True, hidden_units=spec["hidden"], **kw)
    elif kind == "dssm":
        cols = schema("dssm", tfeatures)
        model = DSSM((cols[0], cols[2]), (cols[1],), user_hidden_units=spec["hidden"],
                     item_hidden_units=spec["hidden"], **kw)
    elif kind == "ffm":
        model = FFM(spec["columns"], factor_dim=spec.get("k", 4), **kw)
    elif kind == "mmoe" and "columns" in spec:
        model = MMOE(feature_columns=spec["columns"], num_tasks=2, num_experts=4,
                     expert_units=16, tower_hidden_units=(8,), **kw)
    elif kind == "mmoe":
        model = MMOE(in_features=spec["in_features"], num_tasks=2, num_experts=4,
                     expert_units=16, tower_hidden_units=(8,), **kw)
    else:
        raise ValueError(kind)
    return model if params is None else load_jax_params(model, params, stats)


def dssm_loss(outputs, labels, batch):
    user, item = outputs
    return inbatch_softmax_loss(user, item, batch["item_id"], temperature=0.05)


_OPTIMIZERS = {"adagrad": Adagrad, "adam": Adam, "sgd": SGD}
_FUSED = {"adagrad": FusedAdagrad, "sgd": FusedSGD, "adam": FusedAdam}


def build_trainer(kind: str, spec: dict, params: dict, stats=None, mesh=None, **mesh_kw):
    """``spec["optimizer"]`` and ``spec.get("fused")`` are ``(rule, lr)``."""
    rule, lr = spec["optimizer"]
    fused = spec.get("fused")
    return Trainer(build_model(kind, spec, params, stats), _OPTIMIZERS[rule](lr),
                   fused_embedding=_FUSED[fused[0]](fused[1]) if fused else None,
                   loss_fn=dssm_loss if kind == "dssm" else default_loss,
                   device="cpu", mesh=mesh, **mesh_kw)


def view(trainer) -> Dict[str, np.ndarray]:
    """Every parameter, buffer and optimizer state by name, the sharded
    tables and their states gathered whole (a collective under a mesh)."""
    mesh = trainer.mesh

    def whole(name, t):
        t = t.detach()
        if mesh is not None:
            t = trainer.whole(name, t)
        return t.numpy().copy()

    out = {n: whole(n, p) for n, p in trainer.model.named_parameters()}
    out.update({n: b.numpy().copy() for n, b in trainer.model.named_buffers(
        remove_duplicate=False) if n.endswith(("running_mean", "running_var"))})
    for n, slots in trainer.opt_state.items():
        out.update({f"{k}:{n}": whole(n, v) for k, v in slots.items()})
    for n, slots in trainer.fused_slots.items():
        out.update({f"slot{i}:{n}": whole(n, v) for i, v in enumerate(slots)})
    return out


def to_tensors(X):
    if not isinstance(X, dict):
        return torch.from_numpy(np.ascontiguousarray(X))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in X.items()}


def steps(trainer, batches, mesh=None):
    """One ``train_step`` per global ``(X, y)``, each rank on its rows:
    the losses and, where the trainer counts it, each step's overflow
    summed over ranks."""
    losses, overflow = [], []
    for X, y in batches:
        if mesh is not None:
            X, y = mesh.shard_batch(X), mesh.shard_batch(y)
        losses.append(float(trainer.train_step(to_tensors(X), torch.from_numpy(y))))
        if trainer.tracks_overflow:
            overflow.append(trainer.take_overflow())
    return np.asarray(losses), overflow


# ---------------------------------------------------------------------------
# what the ranks run: fn(mesh, *args)

def train_on_mesh(mesh, kind, spec, params, stats, batches, mesh_kw):
    """``steps`` on the mesh; rank 0 returns the losses, the overflow and
    the whole view, every rank its replicated parameters and buffers."""
    trainer = build_trainer(kind, spec, params, stats, mesh=mesh, **mesh_kw)
    losses, overflow = steps(trainer, batches, mesh)
    whole = view(trainer)
    replicated = {n: v for n, v in whole.items() if n not in trainer.sharded
                  and not any(n.endswith(f":{t}") for t in trainer.sharded)}
    shard_rows = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()
                  if n in trainer.sharded}
    placements = {n: p.kind for n, p in trainer.sharded.items()}
    if mesh.rank == 0:
        return {"losses": losses, "overflow": overflow, "view": whole,
                "replicated": replicated, "shard_rows": shard_rows, "placements": placements}
    return {"replicated": replicated, "shard_rows": shard_rows, "placements": placements}


def fit_on_mesh(mesh, kind, spec, params, stats, X, y, mesh_kw, fit_kw):
    """``Trainer.fit`` on the mesh over the whole data: the history, and
    rank 0's whole view."""
    trainer = build_trainer(kind, spec, params, stats, mesh=mesh, **mesh_kw)
    history = trainer.fit(X, y, **fit_kw)
    whole = view(trainer)
    return {"history": history, "view": whole if mesh.rank == 0 else None,
            "shard_rows": {n: tuple(p.shape) for n, p in trainer.model.named_parameters()
                           if n in trainer.sharded}}


def fit_stream_on_mesh(mesh, kind, spec, params, batches, mesh_kw, stream_kw):
    """``Trainer.fit_stream`` on the mesh over the stream of ``batches``
    (every rank reads all of it): the history, the step, and rank 0's whole
    view."""
    trainer = build_trainer(kind, spec, params, mesh=mesh, **mesh_kw)
    history = trainer.fit_stream(iter(batches), **stream_kw)
    whole = view(trainer)
    return {"history": history, "step": trainer.step,
            "view": whole if mesh.rank == 0 else None}


def checkpoint_on_mesh(mesh, kind, spec, params, batches, directory, mesh_kw):
    """Steps, a checkpoint, one more step. Every rank returns whether a
    trainer restored from the checkpoint on the mesh equals the saved one
    and then takes the last step as it did; rank 0 also the view at the
    checkpoint, the last step's loss and the view after it."""
    trainer = build_trainer(kind, spec, params, mesh=mesh, **mesh_kw)
    steps(trainer, batches[:-1], mesh)
    save_checkpoint(directory, trainer)
    saved = view(trainer)
    last, _ = steps(trainer, batches[-1:], mesh)
    final = view(trainer)
    restored = build_trainer(kind, spec, params, mesh=mesh, **mesh_kw)
    restore_checkpoint(directory, restored)
    again = view(restored)
    again_last, _ = steps(restored, batches[-1:], mesh)
    after = view(restored)
    same = (restored.step == len(batches) and
            all(np.array_equal(saved[k], again[k]) for k in saved) and
            np.array_equal(last, again_last) and
            all(np.array_equal(final[k], after[k]) for k in final))
    if mesh.rank:
        return {"restored_equal": same}
    return {"restored_equal": same, "saved": saved, "last": last, "final": final}


def take_on_mesh(mesh, stack, wids, capacity_factor, grad):
    """``alltoall_take`` of rank r's slice of ``wids`` from the block-sharded
    ``stack``: its rows, its overflow and, for ``sum(out ** 2)``, its
    shard's gradient."""
    K = stack.shape[0] // mesh.n
    shard = torch.from_numpy(stack[mesh.rank * K:(mesh.rank + 1) * K].copy())
    shard.requires_grad_(grad)
    out, overflow = alltoall_take(shard, torch.from_numpy(mesh.shard_batch(wids)), mesh,
                                  capacity_factor)
    g = None
    if grad:
        (out * out).sum().backward()
        g = shard.grad.numpy()
    return out.detach().numpy(), int(overflow), g


def mod_lookup_on_mesh(mesh, sharded, ids, capacity_factor, grad):
    """``sharded_lookup`` from rank r's shard of a mod-sharded table: the
    global rows and, for ``sum(out ** 2)`` of this rank's rows, the shard's
    gradient."""
    shard = torch.from_numpy(sharded[mesh.rank].copy()).requires_grad_(grad)
    ids_t = torch.from_numpy(ids)
    if not grad:
        return sharded_lookup(shard, ids_t, mesh, capacity_factor).numpy(), None
    mine = alltoall_lookup(shard, mesh.shard_batch(ids_t), mesh, capacity_factor)
    (mine * mine).sum().backward()
    return mesh.all_gather(mine.detach()).numpy(), shard.grad.numpy()


def gspmd_on_mesh(mesh, table, ids):
    return gspmd_lookup(torch.from_numpy(table), torch.from_numpy(ids), mesh).numpy()


def update_on_mesh(mesh, rule, lr, table, lids, ct, step, capacity_factor):
    """``sharded_fused_update`` of ``table``'s block on rank r over its even
    slice of the global stream: the new block, its slots and the overflow."""
    cfg = _FUSED[rule](lr)
    K = table.shape[0] // mesh.n
    shard = torch.from_numpy(table[mesh.rank * K:(mesh.rank + 1) * K].copy())
    slots = cfg.init_slots(shard)
    lids_r, ct_r = stream_slice(torch.from_numpy(lids).to(torch.int64),
                                torch.from_numpy(ct), mesh)
    overflow = sharded_fused_update(cfg, shard, slots, lids_r, ct_r, mesh, step=step,
                                    capacity_factor=capacity_factor)
    return shard.numpy(), [t.numpy() for t in slots], int(overflow)


def logging_on_mesh(mesh):
    logger = tlogging.get_logger()
    return tlogging.is_host_zero(), logger.level, mesh.rank


def launch_on_mesh(mesh, global_batch, model_per_host=1):
    """``make_pod_mesh`` over the default group and this rank's
    ``host_batch_slice``."""
    pod = make_pod_mesh(model_per_host)
    return (pod.n, pod.rank, pod.data, pod.model), host_batch_slice(global_batch)


# ---------------------------------------------------------------------------
# the model axis

_GRIDS: Dict[tuple, object] = {}


def on_grid(mesh, shape, fn, *args):
    """``fn(grid, *args)`` on the ``make_mesh(*shape)`` of the ranks' group
    (``shape = (data, model)``), made once a process: ``make_mesh`` makes
    the axis groups with ``dist.new_group``, which every rank calls."""
    if shape not in _GRIDS:
        _GRIDS[shape] = make_mesh(*shape, group=mesh.group)
    return fn(_GRIDS[shape], *args)


def axes_on_mesh(mesh):
    """This rank's place on the grid and the global ranks of its two axis
    groups."""
    return ((mesh.n, mesh.rank, mesh.data, mesh.model, mesh.data_index, mesh.model_index),
            dist.get_process_group_ranks(mesh.data_axis.group),
            dist.get_process_group_ranks(mesh.model_axis.group))


def column_take_on_mesh(mesh, table, ids):
    """``column_take`` of this rank's rows of ``ids`` from a column-sharded
    ``table``: every rank's rows gathered, the table's gradient for
    ``sum(out ** 2)`` gathered whole, and this rank's shard's shape."""
    placement = Placement("columns", table.shape)
    shard = placement.shard(torch.from_numpy(table), mesh).requires_grad_(True)
    out = column_take(shard, torch.from_numpy(mesh.shard_batch(ids)), mesh)
    out = out[:, :table.shape[1]]
    (out * out).sum().backward()
    return (mesh.all_gather(out.detach()).numpy(),
            placement.unshard(shard.grad, mesh).numpy(), tuple(shard.shape))


class OptState:
    """An optax state's fields (``_fields``), as ``convert.load_jax_opt_state``
    reads them, without optax: the ranks never import JAX."""

    def __init__(self, **fields):
        self._fields = tuple(fields)
        self.__dict__.update(fields)


def carry_jax_state_on_mesh(mesh, kind, spec, params, opt_state, step, batches, mesh_kw):
    """A mesh Trainer filled with a JAX mesh Trainer's state (global arrays
    as numpy) after the Trainer sharded the model, then ``steps``; rank 0
    returns the losses and the whole view."""
    trainer = build_trainer(kind, spec, params, mesh=mesh, **mesh_kw)
    load_jax_params(trainer.model, params)
    load_jax_opt_state(trainer, opt_state, step=step)
    losses, _ = steps(trainer, batches, mesh)
    whole = view(trainer)
    return {"losses": losses, "view": whole} if mesh.rank == 0 else None


def collection_on_mesh(mesh, batch):
    """An ``EmbeddingCollection`` sharded on the mesh (a frozen varlen
    column among its columns) against its own whole tables: every output of
    this rank's rows, in train and in eval mode."""
    from recommender_system_tpu_torch.layers.embedding import EmbeddingCollection

    cols = [tfeatures.SparseFeat("user_id", 64, 8),
            tfeatures.SparseFeat("item_id", 64, 8, embedding_name="item_id"),
            tfeatures.VarLenSparseFeat(tfeatures.SparseFeat(
                "hist_item_id", 64, 8, embedding_name="item_id", trainable=False), maxlen=4)]
    whole = EmbeddingCollection(cols, device=torch.device("cpu"), generator=_generator())
    sharded = EmbeddingCollection(cols, device=torch.device("cpu"), generator=_generator())
    sharded.shard(mesh, capacity_factor=8.0)
    local = to_tensors(mesh.shard_batch(batch))
    worst = 0.0
    for train in (True, False):
        whole.train(train)
        sharded.train(train)
        with torch.no_grad():
            want, got = whole(local), sharded(local)
        for name in want.sparse:
            worst = max(worst, float((got.sparse[name] - want.sparse[name]).abs().max()))
        for name in want.varlen_raw:
            worst = max(worst, float((got.varlen_raw[name] - want.varlen_raw[name]).abs().max()))
            worst = max(worst, float((got.pooled[name] - want.pooled[name]).abs().max()))
    return worst, tuple(sharded.table_d8.shape)


def multi_step_on_mesh(mesh, kind, spec, params, batches, labels, mesh_kw):
    """``make_multi_step()`` under the mesh on this rank's rows of stacked
    ``[K, B, ...]`` batches, and ``make_multi_step(graphed=False)`` from the
    same start: a mesh's call is the loop, so the two agree bitwise and no
    signature is recorded for a graph, whatever the device. Rank 0 returns
    both losses, the whole view and what the Trainer says of capture."""
    runs = {}
    for graphed in (True, False):
        trainer = build_trainer(kind, spec, params, mesh=mesh, **mesh_kw)
        mine = {k: mesh.shard_batch(v.swapaxes(0, 1)).swapaxes(0, 1) for k, v in batches.items()}
        ys = mesh.shard_batch(labels.swapaxes(0, 1)).swapaxes(0, 1)
        losses = trainer.make_multi_step(graphed=graphed)(to_tensors(mine), to_tensors(ys))
        recorded = len(trainer._graphs) + len(trainer._warmed)
        device, trainer.device = trainer.device, torch.device("cuda")
        captures = trainer.captures  # the rule itself, on a card as on this CPU
        trainer.device = device
        runs[graphed] = (losses.numpy(), view(trainer), recorded, captures)
    return runs if mesh.rank == 0 else None
