"""Checkpoint and resume of a ``Trainer`` with ``torch.save`` (counterpart
of ``recommender_system_tpu/training/checkpoint.py``, which uses orbax).

A checkpoint is the directory ``path/<step>/`` holding ``trainer.pt``:
everything the next step reads, namely the model's parameters and
persistent buffers (BatchNorm statistics), the dense optimizer's state,
the fused optimizer's slots (``()``, ``(acc,)`` or ``(m, v)`` per table),
the step count and the dropout generator's state. It is written under a
temporary name and renamed into place, so a reader sees a whole
checkpoint or none.

A checkpoint made under a mesh has the single-device layout, as the JAX
package's (orbax saves global arrays): every rank calls
``save_checkpoint``, each sharded table and its states (rows, or a row
block's columns) and MMOE's expert slices are gathered, and rank 0 writes
them, with its dropout generator's state as ``generator`` and
every rank's in ``rank_generators``. ``restore_checkpoint`` restores any
checkpoint on one device or on a mesh of any shape, each rank taking its
part; a rank's generator comes back where the checkpoint kept one for it
(a mesh of the same size, a generator of the same device type), else it is
seeded anew: from ``seed + step`` on one device, from ``(seed + step,
rank)`` on a mesh. So a checkpoint made on the CPU restores on the card.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import rank_seed

FILE = "trainer.pt"


def _map_tables(trainer, state: dict, fn) -> dict:
    """``state``'s ``model``, ``opt_state`` and ``fused_slots`` with
    ``fn(tensor, placement)`` applied to each sharded parameter's tensors
    (the parameter and its states, all of its shape)."""
    def each(name, t):
        return fn(t, trainer.sharded[name]) if name in trainer.sharded else t

    return {
        "model": {k: each(k, v) for k, v in state["model"].items()},
        "opt_state": {n: {k: each(n, v) for k, v in slots.items()}
                      for n, slots in state["opt_state"].items()},
        "fused_slots": {n: tuple(each(n, v) for v in slots)
                        for n, slots in state["fused_slots"].items()},
    }


def save_checkpoint(path: str, trainer, step: Optional[int] = None) -> str:
    """Save ``trainer`` under ``path/<step>`` (default: its step count),
    replacing a checkpoint of that step; returns the directory. Under a mesh
    every rank calls it and rank 0 writes."""
    path = os.path.abspath(path)
    step = int(trainer.step if step is None else step)
    target = os.path.join(path, str(step))
    mesh = trainer.mesh
    state = {"model": trainer.model.state_dict(), "opt_state": trainer.opt_state,
             "fused_slots": trainer.fused_slots,
             "step": trainer.step, "generator": trainer.generator.get_state()}
    if mesh is not None:
        state.update(_map_tables(trainer, state,
                                 lambda t, placement: placement.unshard(t, mesh)))
        state["rank_generators"] = [None] * mesh.n
        dist.all_gather_object(state["rank_generators"], state["generator"],
                               group=mesh.group)
    if mesh is None or mesh.rank == 0:
        partial = os.path.join(path, f".{step}.{os.getpid()}.partial")
        os.makedirs(partial, exist_ok=True)
        torch.save(state, os.path.join(partial, FILE))
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.replace(partial, target)
    if mesh is not None:
        dist.barrier(group=mesh.group)
    return target


def latest_step(path: str) -> Optional[int]:
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = [int(d) for d in os.listdir(path) if d.isdigit()]
    return max(steps) if steps else None


def restore_checkpoint(path: str, trainer, step: Optional[int] = None):
    """Restore ``trainer`` in place from ``path/<step>`` (default: the
    latest); returns it. The checkpoint's tensors must have the shapes of
    the trainer's (under a mesh, of its tables before sharding)."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    saved = torch.load(os.path.join(path, str(step), FILE), map_location=trainer.device,
                       weights_only=True)
    mesh = trainer.mesh
    if mesh is not None:
        saved.update(_map_tables(trainer, saved,
                                 lambda t, placement: placement.shard(t, mesh)))
    trainer.model.load_state_dict(saved["model"])
    with torch.no_grad():
        if saved["opt_state"].keys() != trainer.opt_state.keys():
            raise KeyError("the checkpoint's optimizer state names other parameters")
        for name, slots in trainer.opt_state.items():
            for key, tensor in slots.items():
                tensor.copy_(saved["opt_state"][name][key])
        if saved["fused_slots"].keys() != trainer.fused_slots.keys():
            raise KeyError("the checkpoint's fused slots name other tables")
        for name, slots in trainer.fused_slots.items():
            if len(saved["fused_slots"][name]) != len(slots):
                raise ValueError(f"the checkpoint keeps {len(saved['fused_slots'][name])} "
                                 f"slots for {name}, the trainer {len(slots)}")
            for tensor, value in zip(slots, saved["fused_slots"][name]):
                tensor.copy_(value)
    trainer.step = int(saved["step"])
    generators = saved.get("rank_generators")
    kept = saved["generator"] if mesh is None else (
        generators[mesh.rank] if generators is not None and len(generators) == mesh.n else None)
    if kept is not None and kept.numel() == trainer.generator.get_state().numel():
        trainer.generator.set_state(kept.cpu())
    else:  # another mesh, or a generator of another device type
        trainer.generator.manual_seed(trainer.seed + trainer.step if mesh is None
                                      else rank_seed(trainer.seed + trainer.step, mesh.rank))
    return trainer
