"""The port's native Criteo parser and its data loaders against the JAX
package's, bit for bit, on files written here: ``parse_criteo_native`` and
``iter_criteo_chunks`` (missing fields, no trailing newline, chunk sizes
that do not divide the row count, ``max_rows``), ``load_criteo`` (both
engines, hashed and LabelEncoder modes), ``stream_criteo`` (with and
without a shuffle pool, over two epochs, ``drop_remainder`` False),
``load_avazu`` and ``synthetic_avazu``; the parser's build directory and
the paths that require it."""
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from recommender_system_tpu import native as jnative
from recommender_system_tpu.utils import datasets as jdatasets
from recommender_system_tpu_torch import native
from recommender_system_tpu_torch.utils import datasets

ROWS = 1500


def write_criteo_tsv(path, rows: int, seed: int = 0, vocab: int = 300,
                     missing: float = 0.1, trailing_newline: bool = False,
                     pool_seed: int = 0) -> str:
    """A Criteo-format TSV (``label \\t I1..I13 \\t C1..C26``) with a
    learnable label: dense ints (some negative, so that ``log1p(max(x, 0))``
    clips) and 8-hex-digit tokens drawn skewed from per-column pools, each
    field missing with probability ``missing``. ``pool_seed`` fixes the
    pools and the token effects, ``seed`` the rows."""
    pool_rng = np.random.default_rng(pool_seed)
    pools = [np.array([f"{v:08x}" for v in pool_rng.integers(0, 2 ** 32, vocab,
                                                               dtype=np.uint64)])
             for _ in range(26)]
    effects = [0.5 * np.sin(np.arange(vocab) * (i + 1) * 0.37) for i in range(26)]
    rng = np.random.default_rng(seed)
    logits = np.zeros(rows)
    cols = []
    for i in range(13):
        v = rng.integers(-5, 1000, rows)
        logits += (0.4 if i % 2 == 0 else -0.4) * (v / 1000.0 - 0.5)
        s = v.astype("U5")
        s[rng.random(rows) < missing] = ""
        cols.append(s)
    for i in range(26):
        ids = (rng.random(rows) ** 2 * vocab).astype(np.int64)
        logits += effects[i][ids]
        s = pools[i][ids].astype("U8")
        s[rng.random(rows) < missing] = ""
        cols.append(s)
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-logits))).astype(np.int64)
    lines = ["\t".join(r) for r in zip(y.astype("U1"), *cols)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if trailing_newline else ""))
    return str(path)


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    return write_criteo_tsv(tmp_path_factory.mktemp("criteo") / "train.tsv", ROWS)


def _equal_parts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_parser_builds_into_the_package():
    assert native.available(), native.build_error()
    path = native.library_path()
    assert path.parent == Path(datasets.__file__).resolve().parent.parent / "build"
    assert path.exists() and path.name.startswith("libcriteo_parser-")
    assert native.get_lib() is native.get_lib()


@pytest.mark.parametrize("max_rows", [None, 1, 1000, ROWS + 10])
def test_parse_matches_jax(tsv, max_rows):
    got = native.parse_criteo_native(tsv, max_rows=max_rows)
    want = jnative.parse_criteo_native(tsv, max_rows=max_rows)
    _equal_parts(got, want)
    assert len(got[0]) == min(ROWS, max_rows or ROWS)
    if max_rows is None:  # the file has missing tokens (hash 0) and negative values
        assert (got[2] == 0).any() and (got[1] < 0).any()


@pytest.mark.parametrize("chunk_rows", [1, 777, 1000, ROWS, 4096])
def test_chunks_match_jax_and_the_whole_parse(tsv, chunk_rows):
    got = list(native.iter_criteo_chunks(tsv, chunk_rows))
    want = list(jnative.iter_criteo_chunks(tsv, chunk_rows))
    assert len(got) == len(want) == -(-ROWS // chunk_rows)
    for g, w in zip(got, want):
        _equal_parts(g, w)
    whole = native.parse_criteo_native(tsv)
    _equal_parts([np.concatenate([c[i] for c in got]) for i in range(3)], whole)


def test_parse_of_a_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_criteo_native(str(tmp_path / "absent.tsv"))


def _equal_loaded(got, want):
    cols_g, *arrays_g = got
    cols_w, *arrays_w = want
    assert [(c.name, type(c).__name__, getattr(c, "vocabulary_size", None),
             getattr(c, "embedding_dim", None)) for c in cols_g] == \
        [(c.name, type(c).__name__, getattr(c, "vocabulary_size", None),
          getattr(c, "embedding_dim", None)) for c in cols_w]
    for g, w in zip(arrays_g, arrays_w):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("engine,hash_buckets,max_rows", [
    ("native", 1000, None), ("native", 97, 700), ("pandas", 1000, None),
    ("pandas", None, None), ("pandas", None, 900), ("auto", 5000, None)])
def test_load_criteo_matches_jax(tsv, engine, hash_buckets, max_rows):
    kw = dict(embedding_dim=4, hash_buckets=hash_buckets, max_rows=max_rows, engine=engine)
    _equal_loaded(datasets.load_criteo(tsv, **kw), jdatasets.load_criteo(tsv, **kw))


def test_both_engines_hash_alike(tsv):
    a = datasets.load_criteo(tsv, hash_buckets=1000, engine="native")
    b = datasets.load_criteo(tsv, hash_buckets=1000, engine="pandas")
    for c in datasets.CRITEO_SPARSE:
        np.testing.assert_array_equal(a[1][c], b[1][c])


def _stream(mod, path, **kw):
    return [(X, y) for X, y in mod.stream_criteo(path, **kw)]


@pytest.mark.parametrize("shuffle_rows,drop_remainder", [
    (0, False), (0, True), (500, False), (1200, True)])
def test_stream_matches_jax(tsv, shuffle_rows, drop_remainder):
    kw = dict(batch_size=128, hash_buckets=1000, chunk_rows=333, epochs=2,
              prefetch_chunks=2, drop_remainder=drop_remainder,
              shuffle_buffer_rows=shuffle_rows, seed=3)
    got, want = _stream(datasets, tsv, **kw), _stream(jdatasets, tsv, **kw)
    assert len(got) == len(want)
    assert len(got) == (2 * ROWS) // 128 + (0 if drop_remainder else 1)
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(yg, yw)
        assert xg.keys() == xw.keys()
        for k in xw:
            assert xg[k].dtype == xw[k].dtype and xg[k].shape == xw[k].shape, k
            np.testing.assert_array_equal(xg[k], xw[k], err_msg=k)
    # the pool's generator advances across epochs: epoch 2 is ordered anew
    if shuffle_rows:
        n = ROWS // 128
        first = np.concatenate([y for _, y in got[:5]])
        second = np.concatenate([y for _, y in got[n:n + 5]])
        assert not np.array_equal(first, second)


def test_stream_close_drains_and_stops_the_parser(tsv):
    before = threading.active_count()
    stats = {}
    it = datasets.stream_criteo(tsv, batch_size=64, hash_buckets=1000, chunk_rows=100,
                                prefetch_chunks=1, stats=stats)
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    assert stats["parser_wait_s"] >= 0.0 and stats["batch_s"] > 0.0


def test_paths_that_need_the_parser_raise_without_it(tsv, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build", lambda: None)
    monkeypatch.setattr(native, "_build_error", "g++: not found")
    with pytest.raises(RuntimeError, match=r"native parser unavailable: g\+\+: not found"):
        datasets.load_criteo(tsv, hash_buckets=1000, engine="native")
    with pytest.raises(RuntimeError, match="native parser unavailable"):
        next(datasets.stream_criteo(tsv, batch_size=64, hash_buckets=1000))
    # the library call falls back to pandas, as the JAX package's does
    _equal_loaded(datasets.load_criteo(tsv, hash_buckets=1000, engine="auto"),
                  jdatasets.load_criteo(tsv, hash_buckets=1000, engine="pandas"))


def test_synthetic_avazu_and_load_avazu_match_jax(tmp_path):
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    assert datasets.synthetic_avazu(str(ours), n_rows=600, seed=2) == 600
    jdatasets.synthetic_avazu(str(theirs), n_rows=600, seed=2)
    assert ours.read_bytes() == theirs.read_bytes()
    kw = dict(embedding_dim=4, hash_buckets=5000, max_rows=500)
    _equal_loaded(datasets.load_avazu(str(ours), **kw), jdatasets.load_avazu(str(ours), **kw))
    assert datasets.AVAZU_SPARSE == jdatasets.AVAZU_SPARSE
