"""Host-side data: the Criteo schema, synthetic Criteo-shaped and behaviour
data, batching.

Copies of the parts of ``recommender_system_tpu/utils/datasets.py`` that the
port's paths use, bit-exact with them (``tests/test_torch_utils.py``,
``tests/test_torch_din.py``). Batches are dicts of fixed-shape numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from .features import DenseFeat, SparseFeat, VarLenSparseFeat

CRITEO_DENSE = [f"I{i}" for i in range(1, 14)]
CRITEO_SPARSE = [f"C{i}" for i in range(1, 27)]


def criteo_columns(embedding_dim: int = 8,
                   hash_buckets: int = 1 << 20) -> list:
    """The typed schema for hashed Criteo (13 dense + 26 hashed sparse)."""
    return ([DenseFeat(c, 1) for c in CRITEO_DENSE]
            + [SparseFeat(c, hash_buckets, embedding_dim)
               for c in CRITEO_SPARSE])


def synthetic_criteo(
    n_rows: int = 4096,
    n_dense: int = 13,
    n_sparse: int = 26,
    vocab: int = 1000,
    embedding_dim: int = 8,
    seed: int = 0,
) -> Tuple[list, Dict[str, np.ndarray], np.ndarray]:
    """Criteo-shaped synthetic data with a learnable signal (for tests/bench)."""
    rng = np.random.default_rng(seed)
    columns: list = []
    X: Dict[str, np.ndarray] = {}
    logits = np.zeros(n_rows)
    for i in range(n_dense):
        name = f"I{i + 1}"
        v = rng.uniform(0, 1, n_rows).astype(np.float32)
        X[name] = v[:, None]
        columns.append(DenseFeat(name, 1))
        logits += (0.5 if i % 2 == 0 else -0.5) * (v - 0.5)
    for i in range(n_sparse):
        name = f"C{i + 1}"
        ids = rng.integers(1, vocab, n_rows).astype(np.int32)
        X[name] = ids
        columns.append(SparseFeat(name, vocab, embedding_dim))
        logits += 0.3 * np.sin(ids * (i + 1) * 0.37)
    y = (rng.uniform(size=n_rows) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return columns, X, y


def synthetic_behavior(
    n_rows: int = 2048,
    n_items: int = 500,
    n_users: int = 200,
    seq_len: int = 10,
    embedding_dim: int = 8,
    seed: int = 0,
):
    """Behaviour-sequence synthetic data: the label depends on whether the
    target item's "category" (item_id % 8) appears in the history, the
    signal DIN's attention should pick up."""
    rng = np.random.default_rng(seed)
    user = rng.integers(1, n_users, n_rows).astype(np.int32)
    item = rng.integers(1, n_items, n_rows).astype(np.int32)
    hist = rng.integers(1, n_items, (n_rows, seq_len)).astype(np.int32)
    hist_len = rng.integers(1, seq_len + 1, n_rows).astype(np.int32)
    pos_mask = np.arange(seq_len)[None, :] < hist_len[:, None]
    hist = np.where(pos_mask, hist, 0)
    match = ((hist % 8) == (item[:, None] % 8)) & pos_mask
    p = np.where(match.any(1), 0.85, 0.2)
    y = (rng.uniform(size=n_rows) < p).astype(np.float32)

    columns = [
        SparseFeat("user_id", n_users, embedding_dim),
        SparseFeat("item_id", n_items, embedding_dim),
        VarLenSparseFeat(
            SparseFeat("hist_item_id", n_items, embedding_dim, embedding_name="item_id"),
            maxlen=seq_len, combiner="mean", length_name="hist_len",
        ),
    ]
    X = {"user_id": user, "item_id": item, "hist_item_id": hist, "hist_len": hist_len}
    return columns, X, y


def iter_batches(
    X: Dict[str, np.ndarray],
    y: Optional[np.ndarray],
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator:
    """Minibatch iterator over a dict-of-arrays dataset (fixed shapes).

    With ``drop_remainder`` every batch has the same shape.
    """
    is_dict = isinstance(X, dict)
    n = len(next(iter(X.values()))) if is_dict else len(X)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    stop = n - batch_size + 1 if drop_remainder else n
    for start in range(0, max(stop, 0), batch_size):
        sel = idx[start: start + batch_size]
        xb = {k: v[sel] for k, v in X.items()} if is_dict else X[sel]
        if y is None:
            yield xb
        else:
            yield xb, y[sel]


def pad_to_batch(X, y, batch_size: int):
    """Pad the last partial batch up to ``batch_size`` returning a validity mask."""
    is_dict = isinstance(X, dict)
    n = len(next(iter(X.values()))) if is_dict else len(X)
    pad = (-n) % batch_size
    if pad == 0:
        return X, y, np.ones(n, bool)
    if is_dict:
        Xp = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
              for k, v in X.items()}
    else:
        Xp = np.concatenate([X, np.repeat(X[-1:], pad, axis=0)])
    yp = None if y is None else np.concatenate([y, np.zeros(pad, y.dtype)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return Xp, yp, mask
