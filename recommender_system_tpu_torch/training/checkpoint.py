"""Checkpoint and resume of a ``Trainer`` with ``torch.save`` (counterpart
of ``recommender_system_tpu/training/checkpoint.py``, which uses orbax).

A checkpoint is the directory ``path/<step>/`` holding ``trainer.pt``:
everything the next step reads, namely the model's parameters and
persistent buffers (BatchNorm statistics), the dense optimizer's state,
the fused optimizer's slots (``()``, ``(acc,)`` or ``(m, v)`` per table),
the step count and the dropout generator's state. It is written under a
temporary name and renamed into place, so a reader sees a whole
checkpoint or none.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

FILE = "trainer.pt"


def save_checkpoint(path: str, trainer, step: Optional[int] = None) -> str:
    """Save ``trainer`` under ``path/<step>`` (default: its step count),
    replacing a checkpoint of that step; returns the directory."""
    path = os.path.abspath(path)
    step = int(trainer.step if step is None else step)
    target = os.path.join(path, str(step))
    partial = os.path.join(path, f".{step}.{os.getpid()}.partial")
    os.makedirs(partial, exist_ok=True)
    torch.save({
        "model": trainer.model.state_dict(),
        "opt_state": trainer.opt_state,
        "fused_slots": trainer.fused_slots,
        "step": trainer.step,
        "generator": trainer.generator.get_state(),
    }, os.path.join(partial, FILE))
    if os.path.isdir(target):
        shutil.rmtree(target)
    os.replace(partial, target)
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
    the trainer's."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    saved = torch.load(os.path.join(path, str(step), FILE), map_location=trainer.device,
                       weights_only=True)
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
    trainer.generator.set_state(saved["generator"].cpu())
    return trainer
