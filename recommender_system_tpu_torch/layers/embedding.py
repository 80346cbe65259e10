"""Fused embedding engine: one stacked table per embedding dim, one gather per
dim group (counterpart of ``recommender_system_tpu/layers/embedding.py``).

All tables that share an embedding dim are stacked into one logical
``[total_rows, dim]`` parameter, ``table_d{dim}``, with static per-table row
offsets, so a batch's single-valued sparse features of that dim become one
``[B, F]`` row matrix and one gather. The JAX package stores the same stack
lane-packed as ``[ceil(V/P), 128]`` for the TPU; ``convert.py`` unpacks it.

Supported here: shared tables via ``embedding_name``, ``use_hash`` (murmur
hash into the vocab), ``trainable=False`` (detached lookup), per-table init
std, dense columns with ``transform_fn``. Variable-length columns and their
pooling come with the sequence-model slice of the port.

The gather is ``take_fast``, whose backward is the sorted scatter-add kernel.
For the fused sparse optimizer the Trainer sets ``capture`` to a list
instead (the JAX package's perturb and sow hooks): each gather then reads the
detached table, makes its ``[B, F, d]`` output a leaf that requires grad,
and appends a ``Captured`` record, so that after ``backward()`` the leaf's
``.grad`` is the lookup's cotangent, beside its rows and sorted stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.embedding_grad import take_fast
from ..ops.stream_sort import SortLayout
from ..utils.features import (DenseFeat, FeatureColumn, SparseFeat,
                              VarLenSparseFeat, split_columns)
from ..utils.hashing import hash_ids


@dataclasses.dataclass
class _TableSpec:
    name: str
    vocab: int
    dim: int
    init_std: float
    trainable: bool
    offset: int = 0


def build_table_specs(feature_columns: Sequence[FeatureColumn]) -> Dict[int, Dict[str, _TableSpec]]:
    """Unique tables grouped by dim, with row offsets into the per-dim stack."""
    by_dim: Dict[int, Dict[str, _TableSpec]] = {}
    for fc in feature_columns:
        if isinstance(fc, DenseFeat):
            continue
        name = fc.embedding_name
        group = by_dim.setdefault(fc.embedding_dim, {})
        if name in group:
            # Shared table: vocab must agree (max wins).
            group[name].vocab = max(group[name].vocab, fc.vocabulary_size)
        else:
            group[name] = _TableSpec(name, fc.vocabulary_size, fc.embedding_dim,
                                     fc.init_std, fc.trainable)
    for dim, group in by_dim.items():
        offset = 0
        for spec in group.values():
            spec.offset = offset
            offset += spec.vocab
    return by_dim


@dataclasses.dataclass
class EmbedOutputs:
    """What a model needs from the feature pipeline for one batch.

    ``fused`` holds the per-dim-group lookup results (``dim -> (names,
    [B, F, d])``) of groups whose tables are all trainable; ``sparse_stack``
    and ``concat_flat`` use them directly."""

    sparse: Dict[str, torch.Tensor]     # name -> [B, d]
    dense: Optional[torch.Tensor]       # [B, sum(dims)] or None
    fused: Dict[int, Tuple[Tuple[str, ...], torch.Tensor]] = \
        dataclasses.field(default_factory=dict)

    def sparse_stack(self, names: Optional[Sequence[str]] = None) -> torch.Tensor:
        """Stack single-valued sparse embeddings into [B, F, d] (uniform dim)."""
        if names is None and len(self.fused) == 1:
            (fnames, arr), = self.fused.values()
            if len(fnames) == len(self.sparse):
                return arr
        vals = [self.sparse[n] for n in (names or self.sparse.keys())]
        return torch.stack(vals, dim=1)

    def concat_flat(self, include_dense: bool = True,
                    sparse_names: Optional[Sequence[str]] = None) -> Optional[torch.Tensor]:
        """Flattened ``[sparse embeds | dense]``.

        The order is the JAX package's: with one fused dim group, the fields
        in column order; otherwise ``self.sparse``'s order, which is dim group
        by dim group (``EmbeddingCollection.forward``), not column order.
        Transplanted weights depend on it."""
        if sparse_names is None and len(self.fused) == 1:
            (fnames, arr), = self.fused.values()
            if len(fnames) == len(self.sparse):
                parts = [arr.reshape(arr.shape[0], -1)]
                if include_dense and self.dense is not None:
                    parts.append(self.dense)
                return torch.cat(parts, dim=-1)
        parts = [self.sparse[n] for n in (sparse_names or self.sparse.keys())]
        if include_dense and self.dense is not None:
            parts.append(self.dense)
        return torch.cat(parts, dim=-1) if parts else None


@dataclasses.dataclass
class Captured:
    """One gather in capture mode: ``embeds`` is the ``[B, F, d]`` leaf whose
    ``.grad`` is the cotangent after ``backward()``, ``rows`` its ``[B*F]``
    rows of ``table`` (the collection's ``table_d{d}``), ``presorted`` their
    sorted stream from ``blocked_sort`` or None."""

    table: str
    embeds: torch.Tensor
    rows: torch.Tensor
    presorted: Optional[Tuple[torch.Tensor, torch.Tensor]]


class EmbeddingCollection(nn.Module):
    """The fused lookup front end (see module docstring).

    Parameters: ``table_d{dim}``, logical ``[total_rows, dim]``, each table's
    rows drawn as ``normal(0, init_std)`` of that table from ``generator``.
    """

    def __init__(self, feature_columns: Sequence[FeatureColumn], *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.feature_columns = tuple(feature_columns)
        sparse, varlen, dense = split_columns(self.feature_columns)
        if varlen:
            raise NotImplementedError(
                f"VarLenSparseFeat columns ({', '.join(fc.name for fc in varlen)}) "
                "and their pooling come with the sequence-model slice of the port")
        self._sparse_cols, self._dense_cols = sparse, dense
        self._specs = build_table_specs(self.feature_columns)
        for dim, group in self._specs.items():
            total = sum(s.vocab for s in group.values())
            std = torch.empty(total, 1)
            for s in group.values():
                std[s.offset: s.offset + s.vocab] = s.init_std
            table = torch.randn(total, dim, generator=generator,
                                device=generator.device).to(device)
            self.register_parameter(f"table_d{dim}",
                                    nn.Parameter(table * std.to(device)))
        # single-valued columns by dim group, in column order, and each
        # group's blocked_sort layout (absent: the generic sort)
        self._by_dim: Dict[int, List[SparseFeat]] = {}
        for fc in sparse:
            self._by_dim.setdefault(fc.embedding_dim, []).append(fc)
        self.sort_layouts = nn.ModuleDict()
        for dim, fcs in self._by_dim.items():
            specs = [self._specs[dim][fc.embedding_name] for fc in fcs]
            layout = SortLayout.of([(s.offset, s.vocab) for s in specs])
            if layout is not None:
                self.sort_layouts[str(dim)] = layout.to(device)
        # capture mode: None, or the list the gathers append to
        self.capture: Optional[List[Captured]] = None

    @property
    def output_dim(self) -> int:
        """Width of ``concat_flat()``: every sparse embedding and dense column."""
        return (sum(fc.embedding_dim for fc in self._sparse_cols)
                + sum(fc.dimension for fc in self._dense_cols))

    def table(self, dim: int) -> nn.Parameter:
        return getattr(self, f"table_d{dim}")

    def _resolve_ids(self, fc: SparseFeat, ids: torch.Tensor) -> torch.Tensor:
        spec = self._specs[fc.embedding_dim][fc.embedding_name]
        # an explicit vocabulary file (applied host-side) takes precedence
        # over hashing, as in the JAX package
        if fc.use_hash and not fc.vocabulary_path:
            ids = hash_ids(ids, spec.vocab, mask_zero=True)
        # clamp, as the JAX package's gather does: out-of-range ids read the
        # table's first or last row instead of raising
        ids = ids.to(torch.int64).clamp(0, spec.vocab - 1)
        return ids + spec.offset

    def _presort(self, dim: int,
                 rows: torch.Tensor) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The dim group's ``[B, F]`` rows as a sorted stream, or None."""
        key = str(dim)
        return self.sort_layouts[key](rows) if key in self.sort_layouts else None

    def _gather(self, dim: int, rows: torch.Tensor) -> torch.Tensor:
        """``[B, F]`` rows -> ``[B, F, d]``: captured, or through ``take_fast``."""
        table = self.table(dim)
        flat = rows.reshape(-1)
        shape = (*rows.shape, dim)
        if self.capture is not None:
            embeds = table.detach().index_select(0, flat).reshape(shape)
            embeds.requires_grad_(True)
            self.capture.append(Captured(f"table_d{dim}", embeds, flat,
                                         self._presort(dim, rows)))
            return embeds
        presorted = (self._presort(dim, rows)
                     if torch.is_grad_enabled() and table.requires_grad else None)
        return take_fast(table, flat, presorted).reshape(shape)

    def forward(self, batch: Mapping[str, torch.Tensor]) -> EmbedOutputs:
        # --- fused single-valued sparse lookup: one gather per dim group ---
        sparse: Dict[str, torch.Tensor] = {}
        fused: Dict[int, Tuple[Tuple[str, ...], torch.Tensor]] = {}
        for dim, fcs in self._by_dim.items():
            rows = torch.stack(
                [self._resolve_ids(fc, batch[fc.name].reshape(-1)) for fc in fcs],
                dim=1)  # [B, F]
            embeds = self._gather(dim, rows)  # [B, F, d]
            if all(fc.trainable for fc in fcs):
                fused[dim] = (tuple(fc.name for fc in fcs), embeds)
            for i, fc in enumerate(fcs):
                e = embeds[:, i, :]
                sparse[fc.name] = e if fc.trainable else e.detach()

        # --- dense features (+ optional transform_fn) ---
        dense = None
        if self._dense_cols:
            parts = []
            for fc in self._dense_cols:
                v = batch[fc.name]
                if v.dim() == 1:
                    v = v[:, None]
                if fc.transform_fn is not None:
                    v = fc.transform_fn(v)
                parts.append(v.to(torch.float32))
            dense = torch.cat(parts, dim=-1)

        return EmbedOutputs(sparse, dense, fused)


class UnifiedEmbedding(nn.Module):
    """Embedding collection with the first-order (linear) weight fused in
    (counterpart of the JAX package's ``UnifiedEmbedding``).

    Each id's row stores ``[v_1..v_d, w]``, the factor vector and its linear
    weight, in one ``table_d{d+1}`` of ``embeddings``, so one gather serves
    both. ``dense_w [n_dense, 1]`` (normal, std 1e-4) weighs the dense
    columns and ``bias`` is the global bias.

    ``forward(batch) -> (EmbedOutputs with d-wide embeddings, linear [B, 1])``.
    """

    def __init__(self, feature_columns: Sequence[FeatureColumn], *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        sparse, varlen, dense = split_columns(tuple(feature_columns))
        aug = [dataclasses.replace(fc, embedding_dim=fc.embedding_dim + 1)
               for fc in sparse] + list(varlen) + list(dense)
        self.embeddings = EmbeddingCollection(aug, device=device, generator=generator)
        n_dense = sum(fc.dimension for fc in dense)
        self.dense_w = (nn.Parameter(
            (torch.randn(n_dense, 1, generator=generator, device=generator.device)
             * 1e-4).to(device)) if n_dense else None)
        self.bias = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, batch: Mapping[str, torch.Tensor]):
        out = self.embeddings(batch)
        first = next(iter(batch.values()))
        linear = torch.zeros(first.shape[0], 1, device=first.device)
        fused: Dict[int, Tuple[Tuple[str, ...], torch.Tensor]] = {}
        fused_names = set()
        for dim, (names, arr) in out.fused.items():
            # one reduction over the fused [B, F, d+1] group
            linear = linear + arr[..., -1].sum(dim=1, keepdim=True)
            fused[dim - 1] = (names, arr[..., :-1])
            fused_names.update(names)
        for n, v in out.sparse.items():
            if n not in fused_names:
                linear = linear + v[..., -1:]
        sparse = {n: v[..., :-1] for n, v in out.sparse.items()}
        if out.dense is not None:
            linear = linear + out.dense @ self.dense_w
        linear = linear + self.bias
        return EmbedOutputs(sparse, out.dense, fused), linear
