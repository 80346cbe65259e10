"""Carry weights trained by the JAX package into the port's modules.

``load_jax_params(model, params, batch_stats)`` takes the JAX package's
nested parameter dicts (``variables["params"]`` and
``variables["batch_stats"]``) as numpy arrays and copies each leaf into the
port's parameter or buffer of the same path:

- ``embeddings/table_d{d}``: the TPU's lane-packed ``[ceil(V/P), 128]``
  stack, unpacked to the logical ``[V, d]`` table (``unpack_stack``);
- a Flax Dense ``kernel [in, out]``: ``weight [out, in]``, transposed;
- a Flax BatchNorm ``scale``: ``weight``; ``bias``, ``alpha``, ``weights``,
  ``biases`` and every other name: the same name;
- ``batch_stats`` ``mean`` / ``var``: ``running_mean`` / ``running_var``.

It raises on a leaf with no counterpart, on a shape that disagrees, and on a
port parameter or buffer that no leaf filled.
"""
from __future__ import annotations

from typing import Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_RENAMES = {"kernel": "weight", "scale": "weight",
            "mean": "running_mean", "var": "running_var"}


def pack_factor(dim: int) -> int:
    """Rows packed per 128-lane row in the JAX package's tables (1 = unpacked)."""
    return max(128 // dim, 1) if dim <= 128 else 1


def unpack_stack(stack: np.ndarray, total_rows: int, dim: int) -> np.ndarray:
    """Lane-packed ``[ceil(V/P), 128]`` -> logical ``[total_rows, dim]``.

    Logical row r lies in packed row r // P, lanes [(r % P)*dim, (r % P + 1)*dim);
    where ``P*dim < 128`` the tail lanes hold nothing."""
    P = pack_factor(dim)
    if P == 1:
        return stack[:total_rows]
    return stack[:, : P * dim].reshape(-1, dim)[:total_rows]


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> torch.nn.Module:
    """Fill ``model`` from the JAX package's variables; returns ``model``."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    unfilled = {k for k in targets if not k.endswith("num_batches_tracked")}
    leaves = list(_leaves(params)) + list(_leaves(batch_stats or {}))
    for path, value in leaves:
        name = ".".join(path[:-1] + (_RENAMES.get(path[-1], path[-1]),))
        if name not in targets:
            raise KeyError(f"JAX variable {'/'.join(path)} has no counterpart "
                           f"{name!r} in {type(model).__name__}")
        target = targets[name]
        if path[-1].startswith("table_d"):
            value = unpack_stack(value, target.shape[0], target.shape[1])
        elif path[-1] == "kernel":
            value = value.T
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"JAX variable {'/'.join(path)} has shape "
                             f"{value.shape}, {name} has {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.as_tensor(np.ascontiguousarray(value),
                                         dtype=target.dtype))
        unfilled.discard(name)
    if unfilled:
        raise KeyError(f"no JAX variable for {sorted(unfilled)}")
    return model
