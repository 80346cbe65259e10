"""Typed feature schema, a copy of ``recommender_system_tpu/utils/features.py``.

The port keeps its own copy so that it imports without JAX (importing any
submodule of the JAX package runs that package's ``__init__``, which imports
flax and jax). ``tests/test_torch_utils.py`` holds it equal to the original.

Batches are plain dicts of fixed-shape arrays:

- ``SparseFeat``      -> int32  ``[B]``
- ``DenseFeat``       -> float32 ``[B, dimension]``
- ``VarLenSparseFeat``-> int32 ``[B, maxlen]`` (+ optional float32 weight
  ``[B, maxlen]`` and int32 length ``[B]``)

ID 0 is reserved as the padding/missing id for maskable features.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

DEFAULT_GROUP_NAME = "default_group"


def auto_embedding_dim(vocabulary_size: int) -> int:
    """The ``"auto"`` rule: 6 * vocab**0.25 (reference ``utils/feature_column.py:24-25``)."""
    return 6 * int(pow(vocabulary_size, 0.25))


@dataclasses.dataclass(frozen=True)
class SparseFeat:
    """A single-valued categorical feature.

    Mirrors the capability of the reference ``SparseFeat``
    (``utils/feature_column.py:12-40``): vocab size, embedding dim with "auto" rule,
    optional on-the-fly hashing into ``vocabulary_size`` buckets, shared embedding
    tables via ``embedding_name``, feature groups, and non-trainable tables.
    """

    name: str
    vocabulary_size: int
    embedding_dim: Union[int, str] = 4
    use_hash: bool = False
    embedding_name: Optional[str] = None
    group_name: str = DEFAULT_GROUP_NAME
    trainable: bool = True
    init_std: float = 1e-4
    # optional explicit token->id vocabulary file (reference Hash layer's
    # vocabulary_path StaticHashTable, layer/utils.py:57-64); applied host-side
    # by utils.vocab.encode_with_vocab during batch construction.
    vocabulary_path: Optional[str] = None

    def __post_init__(self):
        if self.embedding_dim == "auto":
            object.__setattr__(self, "embedding_dim", auto_embedding_dim(self.vocabulary_size))
        if self.embedding_name is None:
            object.__setattr__(self, "embedding_name", self.name)

    @property
    def maxlen(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class VarLenSparseFeat:
    """A variable-length (sequence / multi-valued) categorical feature.

    Mirrors the reference ``VarLenSparseFeat`` (``utils/feature_column.py:42-92``):
    wraps a ``SparseFeat`` plus maxlen, pooling combiner, optional explicit length
    feature and optional per-position weights (with softmax normalization).
    """

    sparsefeat: SparseFeat
    maxlen: int
    combiner: str = "mean"  # 'sum' | 'mean' | 'max'
    length_name: Optional[str] = None
    weight_name: Optional[str] = None
    weight_norm: bool = True

    # -- proxy properties (parity with utils/feature_column.py:51-89) --
    @property
    def name(self) -> str:
        return self.sparsefeat.name

    @property
    def vocabulary_size(self) -> int:
        return self.sparsefeat.vocabulary_size

    @property
    def embedding_dim(self) -> int:
        return self.sparsefeat.embedding_dim

    @property
    def use_hash(self) -> bool:
        return self.sparsefeat.use_hash

    @property
    def embedding_name(self) -> str:
        return self.sparsefeat.embedding_name

    @property
    def group_name(self) -> str:
        return self.sparsefeat.group_name

    @property
    def trainable(self) -> bool:
        return self.sparsefeat.trainable

    @property
    def init_std(self) -> float:
        return self.sparsefeat.init_std


@dataclasses.dataclass(frozen=True)
class DenseFeat:
    """A dense numeric feature (reference ``utils/feature_column.py:94-111``)."""

    name: str
    dimension: int = 1
    transform_fn: Optional[Callable] = None

    def __hash__(self):
        return hash(self.name)


FeatureColumn = Union[SparseFeat, VarLenSparseFeat, DenseFeat]


def split_columns(
    feature_columns: Sequence[FeatureColumn],
) -> Tuple[list, list, list]:
    """Partition columns into (sparse, varlen, dense) preserving order.

    Equivalent to the repeated ``filter(lambda x: isinstance(...))`` idiom in the
    reference (``utils/inputs.py:48-51,135-138``).
    """
    sparse = [c for c in feature_columns if isinstance(c, SparseFeat)]
    varlen = [c for c in feature_columns if isinstance(c, VarLenSparseFeat)]
    dense = [c for c in feature_columns if isinstance(c, DenseFeat)]
    return sparse, varlen, dense


def get_feature_names(feature_columns: Sequence[FeatureColumn]) -> list:
    """All batch keys implied by the columns (reference ``utils/feature_column.py:114-116``)."""
    names = []
    for fc in feature_columns:
        names.append(fc.name)
        if isinstance(fc, VarLenSparseFeat):
            if fc.weight_name is not None:
                names.append(fc.weight_name)
            if fc.length_name is not None:
                names.append(fc.length_name)
    return names


def batch_spec(feature_columns: Sequence[FeatureColumn], batch_size: int):
    """Shape/dtype spec dict for a batch — the jax analogue of the reference's
    ``build_input_features`` (``utils/feature_column.py:119-140``)."""
    import numpy as np

    spec = {}
    for fc in feature_columns:
        if isinstance(fc, SparseFeat):
            spec[fc.name] = ((batch_size,), np.int32)
        elif isinstance(fc, DenseFeat):
            spec[fc.name] = ((batch_size, fc.dimension), np.float32)
        elif isinstance(fc, VarLenSparseFeat):
            spec[fc.name] = ((batch_size, fc.maxlen), np.int32)
            if fc.weight_name is not None:
                spec[fc.weight_name] = ((batch_size, fc.maxlen), np.float32)
            if fc.length_name is not None:
                spec[fc.length_name] = ((batch_size,), np.int32)
        else:
            raise TypeError(f"Invalid feature column type: {type(fc)}")
    return spec
