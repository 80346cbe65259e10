"""Rank-0 logging and seeding (counterpart of
``recommender_system_tpu/utils/logging.py``).

On a mesh only rank 0 speaks: ``get_logger`` logs at INFO there and only
errors elsewhere. ``seed_everything`` seeds numpy's global generator and
returns a ``torch.Generator`` from the same seed, on the card unless
another device is named.
"""
from __future__ import annotations

import logging
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..ops.dispatch import resolve_device


def is_host_zero() -> bool:
    """True on rank 0 of the default process group, or with no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def get_logger(name: str = "recommender_system_tpu_torch") -> logging.Logger:
    """A logger that is silent on ranks other than 0 (errors only), its
    level set from the rank at each call."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO if is_host_zero() else logging.ERROR)
    logger.propagate = False
    return logger


def seed_everything(seed: int, device="cuda") -> torch.Generator:
    """Seed numpy's global generator; returns a ``torch.Generator`` on
    ``device`` (the card unless another device is named; raises without
    one, as ``Trainer`` does) seeded with ``seed``. The port's models and
    ``Trainer`` take generators, not a global seed, and a generator draws
    only for tensors on its own device."""
    device = torch.device(device)
    if device.type == "cuda":
        resolve_device(None)  # raises where there is no card
    np.random.seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
