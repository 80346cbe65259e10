"""Deterministic feature hashing: host-side numpy and on-device torch.

Counterpart of ``recommender_system_tpu/utils/hashing.py``, bit-exact with it
(``tests/test_torch_utils.py``):

- ``hash_ids`` is the 32-bit murmur3 finalizer over uint32 ids. Torch has no
  uint32 arithmetic, so the port carries each value in int64 and masks it to
  32 bits after every multiply and xor.
- ``hash_strings_np`` is a copy of the numpy FNV-1a string hash.

``mask_zero``: id 0 stays 0 (the padding row) and hashed values land in
``[1, num_buckets)``.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``0 <= x < 2**32``, without int64 overflow:
    the constant is split into 16-bit halves so no partial product exceeds
    2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash_ids(ids: torch.Tensor, num_buckets: int, mask_zero: bool = False,
             salt: int = 0) -> torch.Tensor:
    """Hash int ids into ``[0, num_buckets)`` (or ``[1, num_buckets)`` if
    ``mask_zero``) -> int32, on the ids' device.

    Ids are read as uint32, as the JAX version casts them: a negative int32
    id wraps to ``id + 2**32``.
    """
    x = ids.to(torch.int64) & _MASK32
    orig = x
    x = x ^ ((salt * 0x9E3779B9 + 0x85EBCA6B) & _MASK32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    if mask_zero:
        bucketed = x % (num_buckets - 1) + 1
        return torch.where(orig == 0, torch.zeros_like(bucketed),
                           bucketed).to(torch.int32)
    return (x % num_buckets).to(torch.int32)


def hash_strings_np(values, num_buckets: int, mask_zero: bool = False, salt: int = 0) -> np.ndarray:
    """Host-side FNV-1a string/bytes hashing into buckets (numpy, vectorized).

    Hashes all N strings column-wise over a null-padded byte matrix, one
    vectorized pass per byte position. Missing values (None, empty, NaN) hash
    to 0 when ``mask_zero`` else to the empty-string hash.
    """
    n = len(values)
    lo = 1 if mask_zero else 0
    span = np.uint64(num_buckets - lo)
    basis = np.uint64(0xCBF29CE484222325) ^ np.uint64(salt)
    prime = np.uint64(0x100000001B3)
    bvals = [
        b"" if (v is None or v == ""
                or (isinstance(v, float) and np.isnan(v)))
        else (bytes(v) if isinstance(v, (bytes, bytearray))
              else str(v).encode())
        for v in values
    ]
    lens = np.fromiter((len(b) for b in bvals), np.int64, count=n)
    maxlen = int(lens.max()) if n else 0
    h = np.full(n, basis, np.uint64)
    if maxlen:
        mat = np.frombuffer(
            np.array(bvals, dtype=f"S{maxlen}").tobytes(), np.uint8,
        ).reshape(n, maxlen)
        for j in range(maxlen):
            active = j < lens
            h = np.where(active, (h ^ mat[:, j].astype(np.uint64)) * prime, h)
    out = (h % span).astype(np.int64) + lo
    if mask_zero:
        out[lens == 0] = 0
    return out
