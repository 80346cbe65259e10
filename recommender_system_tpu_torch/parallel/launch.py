"""Launch: the process group of a ``torchrun`` job, its mesh, and each
rank's share of the input (counterpart of
``recommender_system_tpu/parallel/launch.py``).

Every rank runs the same program (``torchrun --nproc-per-node N ...``).
``initialize()`` reads torchrun's ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` and starts the default group with NCCL,
one rank a card (``LOCAL_RANK`` picks it); ``make_pod_mesh`` lays the mesh
over every rank, its model groups within a host; ``host_batch_slice`` is
the rows of a global batch this rank loads, the rows ``Mesh.shard_batch``
gives it.

The JAX package's ``global_batch_from_local`` has no counterpart: torch has
no global array. A rank keeps its own rows (``Mesh.shard_batch``), and the
collectives of ``parallel/`` exchange what the step needs.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def initialize(backend: str = "nccl") -> None:
    """Start torchrun's default process group (a no-op where it is
    running). ``backend="nccl"`` (one rank a card, ``LOCAL_RANK`` picking
    the card) or ``"gloo"`` (ranks on the CPU). More ranks on a host than
    cards raises; so does a run outside torchrun."""
    if dist.is_initialized():
        return
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"no torchrun environment ({', '.join(missing)} unset): "
                           "start the job with torchrun --nproc-per-node N")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        cards = torch.cuda.device_count()
        if per_host > cards:
            raise RuntimeError(f"{per_host} ranks on this host and {cards} cards: NCCL "
                               "takes one rank a card")
        torch.cuda.set_device(local)
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    dist.init_process_group(backend, init_method="env://")


def make_pod_mesh(model_per_host: int = 1) -> Mesh:
    """The mesh over every rank of the default group: 'model' spans
    ``model_per_host`` consecutive ranks, which torchrun starts on one host
    (its ``LOCAL_RANK`` order), so the lookup's exchange over the model
    peers and MMOE's expert exchange stay on the host's links; 'data' spans
    the rest. Raises where ``model_per_host`` does not divide the ranks, or
    the ranks of a host (``LOCAL_WORLD_SIZE``)."""
    n = dist.get_world_size()
    if n % model_per_host:
        raise ValueError(f"{n} ranks do not split into model groups of {model_per_host}")
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if per_host % model_per_host:
        raise ValueError(f"{per_host} ranks a host do not split into model groups of "
                         f"{model_per_host}: a model group would span two hosts")
    return make_mesh(data=n // model_per_host, model=model_per_host)


def host_batch_slice(global_batch: int, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> slice:
    """The rows of a global batch this rank loads: its ``global_batch / n``
    consecutive rows."""
    rank = dist.get_rank() if rank is None else rank
    world_size = dist.get_world_size() if world_size is None else world_size
    per = global_batch // world_size
    return slice(rank * per, (rank + 1) * per)
