"""Fused embedding engine: one stacked table per embedding dim, one gather per
dim group (counterpart of ``recommender_system_tpu/layers/embedding.py``).

All tables that share an embedding dim are stacked into one logical
``[total_rows, dim]`` parameter, ``table_d{dim}``, with static per-table row
offsets, so a batch's single-valued sparse features of that dim become one
``[B, F]`` row matrix and one gather. The JAX package stores the same stack
lane-packed as ``[ceil(V/P), 128]`` for the TPU; ``convert.py`` unpacks it.

Supported here: shared tables via ``embedding_name``, ``use_hash`` (murmur
hash into the vocab), ``trainable=False`` (detached lookup), per-table init
std, dense columns with ``transform_fn``, and variable-length columns: each
is one ``[B, T]`` gather (``lookup``) with its mask (from ``length_name`` or
from the ids, id 0 being padding), optional per-position weights and its
pooled vector (``ops/seqpool.py``). ``forward(batch, columns=...)`` looks
up only some columns (DSSM's towers); a single-valued group that is not the
whole dim group takes the generic sort.

The gather is ``take_fast``, whose backward is the sorted scatter-add kernel.
For the fused sparse optimizer the Trainer sets ``capture`` to a list
instead (the JAX package's perturb and sow hooks): each gather (a dim
group's ``[B, F]`` or a varlen column's ``[B, T]``) then reads the detached
table, makes its output a leaf that requires grad, and appends a
``Captured`` record, so that after ``backward()`` the leaf's ``.grad`` is
the lookup's cotangent, beside its rows.

Under a mesh (``shard``, which the ``Trainer`` calls) the collection holds
only this rank's part of each ``table_d*`` (its ``placements``: rows, or,
for a wide table under the plain step on a mesh with a model axis, a row
block's columns) and every gather goes through the all-to-all exchange
(``parallel.fused.alltoall_take``, or ``column_take`` for a column-sharded
table): in train mode at the ``capacity_factor`` given (overflowed rows
read zeros and are counted in the ``Captured`` record), else at full
capacity, which is exact; a column-sharded table always at full capacity.
The captured cotangent is the one of the rows this rank looked up.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.embedding_grad import take_fast
from ..ops.seqpool import id_mask, length_mask, sequence_pooling, weighted_sequence
from ..ops.stream_sort import SortLayout
from ..parallel.fused import alltoall_take, column_take
from ..parallel.mesh import Mesh, Placement, sharding_rule
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
    varlen_raw: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)  # [B, T, d]
    varlen_mask: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)  # [B, T] bool
    pooled: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)  # [B, d]

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
        """Flattened ``[sparse embeds | pooled varlen | dense]``.

        The order is the JAX package's: with one fused dim group and no
        varlen column, the fields in column order; otherwise
        ``self.sparse``'s order, which is dim group by dim group
        (``EmbeddingCollection.forward``), not column order, then the pooled
        varlen columns. Transplanted weights depend on it."""
        if sparse_names is None and len(self.fused) == 1 and not self.pooled:
            (fnames, arr), = self.fused.values()
            if len(fnames) == len(self.sparse):
                parts = [arr.reshape(arr.shape[0], -1)]
                if include_dense and self.dense is not None:
                    parts.append(self.dense)
                return torch.cat(parts, dim=-1)
        parts = [self.sparse[n] for n in (sparse_names or self.sparse.keys())]
        parts += list(self.pooled.values())
        if include_dense and self.dense is not None:
            parts.append(self.dense)
        return torch.cat(parts, dim=-1) if parts else None


@dataclasses.dataclass
class Captured:
    """One gather in capture mode: ``embeds`` is the ``[B, F, d]`` (or
    ``[B, T, d]``) leaf whose ``.grad`` is the cotangent after
    ``backward()``, ``rows2d`` its ``[B, F]`` rows of ``table`` (the
    collection's ``table_d{d}``), ``layout`` the site's ``SortLayout`` or
    None; under a mesh, ``overflow`` the exchange's count of rows it
    dropped."""

    table: str
    embeds: torch.Tensor
    rows2d: torch.Tensor
    layout: Optional[SortLayout]
    overflow: Optional[torch.Tensor] = None

    @property
    def rows(self) -> torch.Tensor:
        return self.rows2d.reshape(-1)

    def presorted(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The rows' sorted stream from the layout, or None."""
        return None if self.layout is None else self.layout(self.rows2d)


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
        self._sparse_cols, self._varlen_cols, self._dense_cols = sparse, varlen, dense
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
        # under a mesh: the mesh, the train-mode lookup's capacity factor
        # (None: full capacity), each table's logical rows and its placement
        self.mesh: Optional[Mesh] = None
        self.capacity_factor: Optional[float] = None
        self.total_rows: Dict[int, int] = {}
        self.placements: Dict[str, Placement] = {}

    def shard(self, mesh: Mesh, capacity_factor: Optional[float] = None,
              column_sharding: bool = False) -> None:
        """Keep only this rank's part of each ``table_d*`` and look rows up
        through the exchange, at ``capacity_factor`` in train mode (None:
        full capacity). A table is split by row (the JAX package's row
        blocks), or, with ``column_sharding`` where the JAX rule splits its
        columns, by row over 'data' and by column over 'model'
        (``parallel.mesh.sharding_rule``)."""
        if self.mesh is not None:
            raise ValueError("the collection is sharded already")
        for dim in self._specs:
            table = self.table(dim)
            placement = sharding_rule(f"table_d{dim}", tuple(table.shape), mesh,
                                      column_sharding)
            self.total_rows[dim] = table.shape[0]
            self.placements[f"table_d{dim}"] = placement
            self.register_parameter(f"table_d{dim}", nn.Parameter(
                placement.shard(table.detach(), mesh), requires_grad=table.requires_grad))
        self.mesh, self.capacity_factor = mesh, capacity_factor

    @property
    def output_dim(self) -> int:
        """Width of ``concat_flat()``: every sparse embedding, pooled varlen
        column and dense column."""
        return (sum(fc.embedding_dim for fc in (*self._sparse_cols, *self._varlen_cols))
                + sum(fc.dimension for fc in self._dense_cols))

    def table(self, dim: int) -> nn.Parameter:
        return getattr(self, f"table_d{dim}")

    def _resolve_ids(self, fc: FeatureColumn, ids: torch.Tensor) -> torch.Tensor:
        spec = self._specs[fc.embedding_dim][fc.embedding_name]
        # an explicit vocabulary file (applied host-side) takes precedence
        # over hashing, as in the JAX package
        base = getattr(fc, "sparsefeat", fc)
        if fc.use_hash and not base.vocabulary_path:
            ids = hash_ids(ids, spec.vocab, mask_zero=True)
        # clamp, as the JAX package's gather does: out-of-range ids read the
        # table's first or last row instead of raising
        ids = ids.to(torch.int64).clamp(0, spec.vocab - 1)
        return ids + spec.offset

    def _layout(self, dim: int) -> Optional[SortLayout]:
        key = str(dim)
        return self.sort_layouts[key] if key in self.sort_layouts else None

    def _gather(self, dim: int, rows: torch.Tensor,
                layout: Optional[SortLayout]) -> torch.Tensor:
        """``[B, F]`` rows -> ``[B, F, d]``: captured, or through ``take_fast``,
        whose backward takes the stream sorted by ``layout`` where there is
        one (a whole dim group's), else sorts it generically (a varlen
        column's, or a column subset's)."""
        table = self.table(dim)
        flat = rows.reshape(-1)
        shape = (*rows.shape, dim)
        if self.mesh is not None:
            return self._exchange(dim, rows, shape)
        if self.capture is not None:
            embeds = table.detach().index_select(0, flat).reshape(shape)
            embeds.requires_grad_(True)
            self.capture.append(Captured(f"table_d{dim}", embeds, rows, layout))
            return embeds
        presorted = (layout(rows) if layout is not None and torch.is_grad_enabled()
                     and table.requires_grad else None)
        return take_fast(table, flat, presorted).reshape(shape)

    def _exchange(self, dim: int, rows: torch.Tensor, shape, frozen: bool = False
                  ) -> torch.Tensor:
        """The gather under a mesh: through ``alltoall_take``, captured as
        ``_gather`` captures (the record carries the overflow), or, on a
        column-sharded table, through ``column_take`` (never captured: the
        fused step row-shards every table)."""
        table = self.table(dim)
        if self.placements[f"table_d{dim}"].kind == "columns":
            with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
                got = column_take(table, rows, self.mesh)
            return got[:, :dim].reshape(shape)
        capacity_factor = self.capacity_factor if self.training else None
        if frozen or self.capture is not None:
            with torch.no_grad():
                embeds, overflow = alltoall_take(table.detach(), rows, self.mesh,
                                                 capacity_factor)
            embeds = embeds.reshape(shape)
            if not frozen:
                embeds.requires_grad_(True)
                self.capture.append(Captured(f"table_d{dim}", embeds, rows, None, overflow))
            return embeds
        return alltoall_take(table, rows, self.mesh, capacity_factor)[0].reshape(shape)

    def lookup(self, fc: FeatureColumn, ids: torch.Tensor) -> torch.Tensor:
        """Embed ids of any shape for one column -> ``ids.shape + (d,)``; a
        frozen column's lookup is detached (and never captured)."""
        rows = self._resolve_ids(fc, ids)
        if not fc.trainable:
            if self.mesh is not None:
                return self._exchange(fc.embedding_dim, rows,
                                      (*rows.shape, fc.embedding_dim), frozen=True)
            return self.table(fc.embedding_dim).detach()[rows]
        return self._gather(fc.embedding_dim, rows, layout=None)

    def forward(self, batch: Mapping[str, torch.Tensor],
                columns: Optional[Sequence[FeatureColumn]] = None) -> EmbedOutputs:
        """Look up every column, or only ``columns`` (the JAX package's
        ``columns=``, which DSSM's towers pass): their single-valued columns
        are gathered by dim group and, unless they are the whole group,
        sorted generically."""
        if columns is None:
            by_dim = self._by_dim
            varlen_cols, dense_cols = self._varlen_cols, self._dense_cols
        else:
            sparse_cols, varlen_cols, dense_cols = split_columns(tuple(columns))
            by_dim: Dict[int, List[SparseFeat]] = {}
            for fc in sparse_cols:
                by_dim.setdefault(fc.embedding_dim, []).append(fc)

        # --- fused single-valued sparse lookup: one gather per dim group ---
        sparse: Dict[str, torch.Tensor] = {}
        fused: Dict[int, Tuple[Tuple[str, ...], torch.Tensor]] = {}
        for dim, fcs in by_dim.items():
            rows = torch.stack(
                [self._resolve_ids(fc, batch[fc.name].reshape(-1)) for fc in fcs],
                dim=1)  # [B, F]
            whole = fcs == self._by_dim[dim]
            embeds = self._gather(dim, rows,
                                  self._layout(dim) if whole else None)  # [B, F, d]
            if all(fc.trainable for fc in fcs):
                fused[dim] = (tuple(fc.name for fc in fcs), embeds)
            for i, fc in enumerate(fcs):
                e = embeds[:, i, :]
                sparse[fc.name] = e if fc.trainable else e.detach()

        # --- varlen features: raw sequences, masks, pooled vectors ---
        varlen_raw: Dict[str, torch.Tensor] = {}
        varlen_mask: Dict[str, torch.Tensor] = {}
        pooled: Dict[str, torch.Tensor] = {}
        for fc in varlen_cols:
            ids = batch[fc.name]  # [B, T]
            seq = self.lookup(fc, ids)  # [B, T, d]
            if fc.length_name is not None:
                mask = length_mask(batch[fc.length_name], fc.maxlen)
            else:
                mask = id_mask(ids)
            varlen_raw[fc.name] = seq
            varlen_mask[fc.name] = mask
            if fc.weight_name is not None:
                seq_w = weighted_sequence(seq, batch[fc.weight_name], mask,
                                          normalize=fc.weight_norm)
            else:
                seq_w = seq
            pooled[fc.name] = sequence_pooling(seq_w, mask, mode=fc.combiner)

        # --- dense features (+ optional transform_fn) ---
        dense = None
        if dense_cols:
            parts = []
            for fc in dense_cols:
                v = batch[fc.name]
                if v.dim() == 1:
                    v = v[:, None]
                if fc.transform_fn is not None:
                    v = fc.transform_fn(v)
                parts.append(v.to(torch.float32))
            dense = torch.cat(parts, dim=-1)

        return EmbedOutputs(sparse, dense, fused, varlen_raw, varlen_mask, pooled)


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
        aug = ([dataclasses.replace(fc, embedding_dim=fc.embedding_dim + 1)
                for fc in sparse]
               + [dataclasses.replace(fc, sparsefeat=dataclasses.replace(
                   fc.sparsefeat, embedding_dim=fc.embedding_dim + 1)) for fc in varlen]
               + list(dense))
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
        for v in out.pooled.values():
            linear = linear + v[..., -1:]
        sparse = {n: v[..., :-1] for n, v in out.sparse.items()}
        varlen_raw = {n: v[..., :-1] for n, v in out.varlen_raw.items()}
        pooled = {n: v[..., :-1] for n, v in out.pooled.items()}
        if out.dense is not None:
            linear = linear + out.dense @ self.dense_w
        linear = linear + self.bias
        return EmbedOutputs(sparse, out.dense, fused, varlen_raw, out.varlen_mask,
                            pooled), linear


class LinearEmbedding(nn.Module):
    """First-order (wide) logit: one scalar weight per id and one per dense
    column (counterpart of the JAX package's ``LinearEmbedding``), a dim-1
    ``EmbeddingCollection`` over the one-hot encoding without the one-hots.

    Each sparse or varlen column gets a dim-1 table ``linear_{name}``
    (normal, std 1e-4), all stacked in ``linear_tables.table_d1``;
    ``dense_w [n_dense, 1]`` (normal, std 1e-4) weighs the dense columns
    and ``bias`` (zeros) is the global bias. ``forward(batch) -> [B, 1]``.
    """

    def __init__(self, feature_columns: Sequence[FeatureColumn], *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        sparse, varlen, dense = split_columns(tuple(feature_columns))
        linear_cols = [dataclasses.replace(fc, embedding_dim=1, init_std=1e-4,
                                           embedding_name=f"linear_{fc.embedding_name}")
                       for fc in sparse]
        linear_cols += [dataclasses.replace(fc, sparsefeat=dataclasses.replace(
            fc.sparsefeat, embedding_dim=1, init_std=1e-4,
            embedding_name=f"linear_{fc.embedding_name}")) for fc in varlen]
        self.linear_tables = EmbeddingCollection(linear_cols + list(dense), device=device,
                                                 generator=generator)
        n_dense = sum(fc.dimension for fc in dense)
        self.dense_w = (nn.Parameter(
            (torch.randn(n_dense, 1, generator=generator, device=generator.device)
             * 1e-4).to(device)) if n_dense else None)
        self.bias = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        out = self.linear_tables(batch)
        first = next(iter(batch.values()))
        logit = torch.zeros(first.shape[0], 1, device=first.device)
        fused_names = set()
        for names, arr in out.fused.values():
            # one reduction over the fused [B, F, 1] group
            logit = logit + arr.sum(dim=1)
            fused_names.update(names)
        for n, v in out.sparse.items():
            if n not in fused_names:
                logit = logit + v
        for v in out.pooled.values():
            logit = logit + v
        if out.dense is not None:
            logit = logit + out.dense @ self.dense_w
        return logit + self.bias
