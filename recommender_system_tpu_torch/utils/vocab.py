"""Vocabulary files: a token -> id mapping applied on the host (counterpart
of ``recommender_system_tpu/utils/vocab.py``, a framework-free copy on the
port's ``features``).

A column's ``vocabulary_path`` maps raw tokens to ids in the data pipeline:
``encode_batch`` (or ``encode_feature`` for one column) builds a model
batch from raw values. Unknown and missing tokens map to id 0, the padding
and out-of-vocabulary row. A ``vocabulary_path`` takes precedence over
``use_hash``: the port's lookup does not hash such a column
(``layers/embedding.py``), so the ids encoded here reach the table as they
are.

File format: one ``token,id`` pair a line; ids must lie in
``[1, vocabulary_size)``, leaving 0 for out-of-vocabulary tokens
(``encode_feature`` checks them).
"""
from __future__ import annotations

import functools
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

from .features import DenseFeat, FeatureColumn, SparseFeat, VarLenSparseFeat


@functools.lru_cache(maxsize=64)
def load_vocab_file(path: str, delimiter: str = ",") -> Dict[str, int]:
    """Parse (cached per path). Skips empty lines; raises with file/line
    context on malformed entries; later duplicates win (dict semantics)."""
    vocab: Dict[str, int] = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            token, sep, idx = line.rpartition(delimiter)
            if not sep:
                raise ValueError(
                    f"{path}:{lineno}: expected 'token{delimiter}id', "
                    f"got {line!r}")
            try:
                vocab[token] = int(idx)
            except ValueError as e:
                raise ValueError(
                    f"{path}:{lineno}: non-integer id in {line!r}") from e
    return vocab


def encode_with_vocab(values: Iterable, vocab: Dict[str, int],
                      default: int = 0,
                      max_id: Optional[int] = None) -> np.ndarray:
    """Map raw tokens to ids; unknown/missing -> ``default`` (OOV row 0).
    ``max_id`` (exclusive) validates mapped ids against the table size."""
    values = list(values)
    out = np.empty(len(values), np.int32)
    for i, v in enumerate(values):
        if v is None or (isinstance(v, float) and np.isnan(v)):
            out[i] = default
        else:
            out[i] = vocab.get(str(v), default)
    if max_id is not None and len(out) and out.max() >= max_id:
        bad = int(out.max())
        raise ValueError(
            f"vocabulary maps to id {bad} >= vocabulary_size {max_id}; "
            f"ids must be in [0, {max_id}) (0 reserved for OOV)")
    return out


def _vocab_path(fc) -> Optional[str]:
    # VarLenSparseFeat wraps its SparseFeat; reach through for the path.
    if isinstance(fc, VarLenSparseFeat):
        fc = fc.sparsefeat
    return getattr(fc, "vocabulary_path", None)


def encode_feature(fc, values) -> np.ndarray:
    """Encode raw values for a Sparse/VarLenSparse feature: vocabulary file if
    configured (validated against vocabulary_size), otherwise pass-through
    ints (hashing, if any, happens on device)."""
    path = _vocab_path(fc)
    if path:
        vocab = load_vocab_file(path)
        arr = np.asarray(values, dtype=object)
        flat = encode_with_vocab(arr.reshape(-1), vocab,
                                 max_id=fc.vocabulary_size)
        return flat.reshape(arr.shape).astype(np.int32)
    return np.asarray(values, np.int32)


def encode_batch(feature_columns: Sequence[FeatureColumn],
                 raw: Dict[str, Iterable]) -> Dict[str, np.ndarray]:
    """Build a model-input batch from raw values: vocab files applied for
    columns that configure them, dense passed through as float32."""
    out: Dict[str, np.ndarray] = {}
    for fc in feature_columns:
        if fc.name not in raw:
            continue
        if isinstance(fc, DenseFeat):
            out[fc.name] = np.asarray(raw[fc.name], np.float32)
        else:
            out[fc.name] = encode_feature(fc, raw[fc.name])
            if isinstance(fc, VarLenSparseFeat):
                if fc.length_name and fc.length_name in raw:
                    out[fc.length_name] = np.asarray(raw[fc.length_name],
                                                     np.int32)
                if fc.weight_name and fc.weight_name in raw:
                    out[fc.weight_name] = np.asarray(raw[fc.weight_name],
                                                     np.float32)
    return out
