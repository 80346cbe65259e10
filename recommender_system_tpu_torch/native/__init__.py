"""The native Criteo TSV parser: built with ``g++`` at first use, loaded
through ctypes (counterpart of ``recommender_system_tpu/native``).

``criteo_parser.cpp`` is the port's own copy of the JAX package's parser: a
multithreaded parse of ``label \\t I1..I13 \\t C1..C26`` rows with FNV-1a
hashing of the categorical tokens, bit-identical to
``utils.hashing.hash_strings_np``. The library is compiled once into
``recommender_system_tpu_torch/build/`` (``libcriteo_parser-<hash>.so``,
named by the source's and the flags' hash). ``available()`` says whether it
built; ``parse_criteo_native`` and ``iter_criteo_chunks`` raise where it did
not, with the compiler's message.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "criteo_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libcriteo_parser-{digest[:16]}.so"


def _build() -> Optional[Path]:
    """Compile the parser unless its library exists; returns the library's
    path, or None with the error recorded."""
    global _build_error
    try:
        target = library_path()
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = target.with_name(f"{target.name}.{os.getpid()}.part")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(partial)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            _build_error = proc.stderr[-2000:]
            return None
        os.replace(partial, target)
        return target
    except Exception as e:  # g++ missing, a read-only tree, ...
        _build_error = repr(e)
        return None


def get_lib():
    """ctypes handle to the native library, or None if it did not build."""
    global _lib
    if _lib is not None:
        return _lib
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    f32 = ctypes.POINTER(ctypes.c_float)
    u64 = ctypes.POINTER(ctypes.c_uint64)
    lib.criteo_count_rows.argtypes = [ctypes.c_char_p]
    lib.criteo_count_rows.restype = ctypes.c_int64
    lib.criteo_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, f32, f32, u64]
    lib.criteo_parse.restype = ctypes.c_int64
    lib.criteo_parse_chunk.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                       ctypes.c_int64, ctypes.c_int, f32, f32, u64]
    lib.criteo_parse_chunk.restype = ctypes.c_int64
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    return _build_error


def _required():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native parser unavailable: {_build_error}")
    return lib


def _threads(threads: int) -> int:
    return threads if threads > 0 else min(os.cpu_count() or 1, 16)


def _outputs(n: int):
    labels = np.zeros(n, np.float32)
    dense = np.zeros((n, 13), np.float32)
    sparse = np.zeros((n, 26), np.uint64)
    ptrs = (labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            sparse.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return (labels, dense, sparse), ptrs


def parse_criteo_native(path: str, max_rows: Optional[int] = None,
                        threads: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a Criteo TSV -> (labels f32 [N], dense f32 [N, 13],
    sparse_hashes u64 [N, 26]; 0 = missing token)."""
    lib = _required()
    total = lib.criteo_count_rows(path.encode())
    if total < 0:
        raise FileNotFoundError(path)
    n = int(total if max_rows is None else min(total, max_rows))
    (labels, dense, sparse), ptrs = _outputs(n)
    rows = lib.criteo_parse(path.encode(), n, _threads(threads), *ptrs)
    if rows < 0:
        raise IOError(f"native parse failed for {path}")
    return labels[:rows], dense[:rows], sparse[:rows]


def iter_criteo_chunks(path: str, chunk_rows: int, threads: int = 0):
    """Stream a Criteo TSV in chunks of at most ``chunk_rows`` rows:
    ``(labels f32 [n], dense f32 [n, 13], sparse u64 [n, 26])``. Only one
    chunk and the parser's read window are resident at a time. Empty lines
    are skipped."""
    lib = _required()
    threads = _threads(threads)
    offset = ctypes.c_int64(0)
    while True:
        (labels, dense, sparse), ptrs = _outputs(chunk_rows)
        rows = lib.criteo_parse_chunk(path.encode(), ctypes.byref(offset), chunk_rows,
                                      threads, *ptrs)
        if rows < 0:
            raise IOError(f"native chunk parse failed for {path} at offset {offset.value}")
        if rows == 0:
            return
        yield labels[:rows], dense[:rows], sparse[:rows]
