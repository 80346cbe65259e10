"""Carry weights trained by the JAX package into the port's modules.

``load_jax_params(model, params, batch_stats)`` takes the JAX package's
nested parameter dicts (``variables["params"]`` and
``variables["batch_stats"]``) as numpy arrays and copies each leaf into the
port's parameter or buffer of the same path:

- ``embeddings/table_d{d}`` (and any other collection's, such as
  ``linear/linear_tables/table_d1``): the TPU's lane-packed
  ``[ceil(V/P), 128]`` stack, unpacked to the logical ``[V, d]`` table
  (``unpack_stack``);
- a Flax Dense ``kernel [in, out]``: ``weight [out, in]``, transposed;
- a Flax Conv ``kernel [kh, kw, in, out]`` (FGCNN's ``conv_{i}``):
  ``weight [out, in, kh, kw]``, the axes permuted ``(3, 2, 0, 1)``;
- a leaf whose whole path the port has as it is: the same name, in the JAX
  layout. This is how ``OuterProductLayer``'s ``kernel [k, P, k]`` is kept:
  it is not a Dense kernel, and ``.T`` would swap its first and last axes
  and keep its shape;
- a Flax BatchNorm or LayerNorm ``scale``: ``weight``; ``bias``, ``alpha``, ``weights``,
  ``biases``, DIN attention's ``w1``-``w3`` and ``b1``-``b3``, ``FMLayer``'s
  ``w0``, ``w1`` and ``v``, FM's and FFM's ``dense_factors`` and
  ``UnifiedEmbedding``'s and ``LinearEmbedding``'s ``dense_w`` (not Dense
  kernels: kept in the JAX layout) and every other name: the same name;
- ``batch_stats`` ``mean`` / ``var``: the ``running_mean`` /
  ``running_var`` buffers of the port's ``BatchNorm`` (in ``bn``,
  ``bn_{i}`` and each ``Dice``'s ``BatchNorm_0``).

The NLP models (``LSTMClassifier``, ``Transformer``,
``TransformerClassifier``) load the same way: their Dense kernels (``q``,
``k``, ``v``, ``out``, ``in``, ``head``) transposed, square ones too, and
``embedding`` / ``table``, ``wx``, ``wh`` and ``bias`` as they are.

It raises on a leaf with no counterpart, on a shape that disagrees, and on a
port parameter or buffer that no leaf filled.

``load_jax_opt_state(trainer, opt_state)`` carries a JAX ``Trainer``'s
optimizer state into the port's ``Trainer`` (``training/harness.py``), so
that a run started by the JAX package continues in the port: optax
Adagrad's ``sum_of_squares`` and Adam's ``mu``, ``nu`` and ``count`` for the
parameters the dense optimizer updates (``optax.sgd`` keeps only
``EmptyState``s, which carry nothing), and the fused optimizer's slots,
each unpacked like its table: ``{path: (acc,)}`` of ``FusedAdagrad``,
``{path: ()}`` of ``FusedSGD``, ``{path: (m, v)}`` of ``FusedAdam``.

A JAX mesh state's leaves are global arrays, so ``np.asarray`` of each is
the whole table or state. Into a model that a mesh ``Trainer`` has sharded
(``EmbeddingCollection.shard``, ``MMoELayer.shard``), both functions put
this rank's part: the unpacked table (or state) padded to the JAX stack's
rows and split by row or by row block and column, an expert tensor split on
its expert axis, as the mesh places it (``parallel.mesh.Placement``).
"""
from __future__ import annotations

from typing import Container, Dict, Iterator, Mapping, Optional, Tuple

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


def _port_name(path: Tuple[str, ...], names: Container[str]) -> str:
    """The port's name of a JAX leaf: its path as it is where the port has
    that name among ``names``, else with the leaf renamed."""
    kept = ".".join(path)
    if kept in names:
        return kept
    return ".".join(path[:-1] + (_RENAMES.get(path[-1], path[-1]),))


def _placement(model: torch.nn.Module, name: str):
    """``(placement, mesh)`` of parameter ``name`` of ``model`` where a mesh
    shards it (a table of a sharded collection, an MMOE expert slice), else
    ``(None, None)``."""
    prefix, _, local = name.rpartition(".")
    owner = model.get_submodule(prefix)
    placement = getattr(owner, "placements", {}).get(local)
    return (placement, owner.mesh) if placement is not None else (None, None)


def _copy(model: torch.nn.Module, param: str, path: Tuple[str, ...], value: np.ndarray,
          name: str, target: torch.Tensor) -> None:
    """``_copy_leaf``, but a parameter (or a state of its shape) that a mesh
    has sharded is copied whole (a table unpacked) and this rank's part
    taken."""
    placement, mesh = _placement(model, param)
    if placement is None:
        _copy_leaf(path, value, name, target)
        return
    whole = torch.empty(placement.shape, dtype=target.dtype)
    _copy_leaf(path, value, name, whole)
    part = placement.shard(whole, mesh)
    if part.shape != target.shape:
        raise ValueError(f"JAX variable {'/'.join(path)} gives this rank "
                         f"{tuple(part.shape)}, {name} has {tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(part.to(target.dtype))


def _copy_leaf(path: Tuple[str, ...], value: np.ndarray, name: str,
               target: torch.Tensor) -> None:
    """Copy one JAX leaf into ``target``: a ``table_d*`` stack (or a state of
    its shape) unpacked, a Dense kernel transposed, a Conv kernel permuted to
    ``[out, in, kh, kw]``, a kernel the port keeps under its own name as it
    is; the shape checked."""
    if path[-1].startswith("table_d"):
        value = unpack_stack(value, target.shape[0], target.shape[1])
    elif path[-1] == "kernel" and name.endswith(".weight"):
        value = value.T if value.ndim == 2 else np.transpose(value, (3, 2, 0, 1))
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"JAX variable {'/'.join(path)} has shape "
                         f"{value.shape}, {name} has {tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(torch.as_tensor(np.array(value), dtype=target.dtype))


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> torch.nn.Module:
    """Fill ``model`` from the JAX package's variables; returns ``model``."""
    # parameters and persistent buffers (not, e.g., sort layouts)
    targets = dict(model.state_dict(keep_vars=True))
    unfilled = {k for k in targets if not k.endswith("num_batches_tracked")}
    leaves = list(_leaves(params)) + list(_leaves(batch_stats or {}))
    for path, value in leaves:
        name = _port_name(path, targets)
        if name not in targets:
            raise KeyError(f"JAX variable {'/'.join(path)} has no counterpart "
                           f"{name!r} in {type(model).__name__}")
        _copy(model, name, path, value, name, targets[name])
        unfilled.discard(name)
    if unfilled:
        raise KeyError(f"no JAX variable for {sorted(unfilled)}")
    return model


# optax state fields that the port's optimizers keep under the same name
_OPT_FIELDS = ("sum_of_squares", "mu", "nu")


def load_jax_opt_state(trainer, opt_state, step: Optional[int] = None):
    """Fill ``trainer``'s optimizer state from a JAX ``Trainer``'s
    ``TrainState.opt_state``; returns ``trainer``.

    ``opt_state`` is the optax state of ``optax.sgd``, ``optax.adagrad`` or
    ``optax.adam`` (a tuple of named tuples), or, with a fused embedding
    optimizer, the pair ``(optax state, {table path: slots})``. Adam's
    ``count`` sets ``trainer.step``; ``step`` (the JAX ``TrainState.step``)
    sets it where given. Raises on a leaf that nothing in ``trainer`` takes,
    on a shape that disagrees, on a state tensor of ``trainer`` that no leaf
    filled, and where neither a ``count`` nor ``step`` gives the step
    (``optax.sgd`` and ``optax.adagrad`` keep no count): a continued run
    would otherwise restart its bias corrections and schedules at step 0.
    """
    targets: Dict[str, torch.Tensor] = {}
    for pname, slots in trainer.opt_state.items():
        for key, tensor in slots.items():
            targets[f"{key}:{pname}"] = tensor
    for pname, slots in trainer.fused_slots.items():
        for i, tensor in enumerate(slots):
            targets[f"slot{i}:{pname}"] = tensor
    unfilled = set(targets)
    counts = []

    def fill(key: str, path: Tuple[str, ...], value) -> None:
        if key not in targets:
            raise KeyError(f"JAX optimizer state {'/'.join(path)} has no "
                           f"counterpart {key!r} in the Trainer")
        _copy(trainer.model, key.split(":", 1)[1], path, np.asarray(value), key,
              targets[key])
        unfilled.discard(key)

    def walk(node) -> None:
        fields = getattr(node, "_fields", None)
        if fields is not None:  # an optax state (a named tuple)
            for field in fields:
                value = getattr(node, field)
                if field == "count":
                    counts.append(int(np.asarray(value)))
                elif field in _OPT_FIELDS:
                    for path, leaf in _leaves(value):
                        fill(f"{field}:{_port_name(path, trainer.opt_state)}",
                             (field,) + path, leaf)
                else:
                    raise KeyError(f"optax state field {field!r} of "
                                   f"{type(node).__name__} has no counterpart")
        elif isinstance(node, Mapping):  # the fused slots {path: (...)}
            for path, slots in node.items():
                if not isinstance(path, tuple):
                    raise KeyError(f"JAX optimizer state key {path!r} is not "
                                   "a fused slot path")
                for i, leaf in enumerate(slots):
                    fill(f"slot{i}:{'.'.join(path)}", path, leaf)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
        else:
            raise KeyError(f"JAX optimizer state leaf of type "
                           f"{type(node).__name__} has no counterpart")

    walk(opt_state)
    if unfilled:
        raise KeyError(f"no JAX optimizer state for {sorted(unfilled)}")
    if step is None and not counts:
        raise ValueError("the optimizer state carries no step count (optax.sgd and "
                         "optax.adagrad keep none): pass step=, the JAX TrainState.step")
    trainer.step = int(step) if step is not None else counts[-1]
    return trainer
