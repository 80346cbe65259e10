"""Host-side data: the Criteo schema, the Criteo TSV loader and its
out-of-core stream, the Avazu CSV loader, synthetic Criteo-shaped and
behaviour data, the MovieLens and Amazon behaviour datasets, the
logistic-regression toy set, batching.

Copies of the parts of ``recommender_system_tpu/utils/datasets.py`` that the
port's paths use, bit-exact with them (``tests/test_torch_utils.py``,
``tests/test_torch_din.py``, ``tests/test_torch_behavior_data.py``,
``tests/test_torch_criteo_data.py``, ``tests/test_torch_classics.py``).
Batches are dicts of fixed-shape numpy arrays. The readers import pandas
inside the functions that need it, so the module imports without it. Unlike the JAX package's, they take the
data's path from the caller: they have no default data directory.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .features import DenseFeat, SparseFeat, VarLenSparseFeat
from .hashing import hash_strings_np

CRITEO_DENSE = [f"I{i}" for i in range(1, 14)]
CRITEO_SPARSE = [f"C{i}" for i in range(1, 27)]


def criteo_columns(embedding_dim: int = 8,
                   hash_buckets: int = 1 << 20) -> list:
    """The typed schema for hashed Criteo (13 dense + 26 hashed sparse)."""
    return ([DenseFeat(c, 1) for c in CRITEO_DENSE]
            + [SparseFeat(c, hash_buckets, embedding_dim)
               for c in CRITEO_SPARSE])


def load_criteo(
    path: str,
    embedding_dim: int = 8,
    hash_buckets: Optional[int] = None,
    test_frac: float = 0.2,
    max_rows: Optional[int] = None,
    engine: str = "auto",
) -> Tuple[list, Dict[str, np.ndarray], np.ndarray, Dict[str, np.ndarray], np.ndarray]:
    """Load a Criteo TSV into typed columns and a train/test split.

    Dense I1..I13: missing -> 0, MinMax-scaled over the file. Sparse
    C1..C26: hashed into ``hash_buckets`` (FNV-1a, 0 = missing) when given,
    else integer-encoded by sorted value with 0 reserved (LabelEncoder
    parity; vocabulary nunique + 1). ``engine``: 'auto' parses the hashed
    mode with the native parser where it built and with pandas elsewhere;
    'native' raises where it did not build; 'pandas' forces pandas (the
    only engine of the LabelEncoder mode). Both engines give the same
    hashes. The split is the last ``test_frac`` of the rows.

    Returns (feature_columns, X_train, y_train, X_test, y_test).
    """
    use_native = False
    if hash_buckets is not None and engine in ("auto", "native"):
        from .. import native

        use_native = native.available()
        if engine == "native" and not use_native:
            raise RuntimeError(f"native parser unavailable: {native.build_error()}")

    columns: list = [DenseFeat(c, 1) for c in CRITEO_DENSE]
    X: Dict[str, np.ndarray] = {}

    if use_native:
        from ..native import parse_criteo_native

        y, dense, hashes = parse_criteo_native(path, max_rows=max_rows)
        lo, hi = dense.min(axis=0), dense.max(axis=0)
        span = np.where(hi > lo, hi - lo, 1.0)
        dense = (dense - lo) / span
        for i, c in enumerate(CRITEO_DENSE):
            X[c] = dense[:, i:i + 1].astype(np.float32)
        span_b = np.uint64(hash_buckets - 1)
        bucketed = (hashes % span_b + np.uint64(1)).astype(np.int32)
        bucketed = np.where(hashes == 0, 0, bucketed)  # missing -> padding id
        for i, c in enumerate(CRITEO_SPARSE):
            columns.append(SparseFeat(c, hash_buckets, embedding_dim))
            X[c] = bucketed[:, i]
    else:
        import pandas as pd

        names = ["label"] + CRITEO_DENSE + CRITEO_SPARSE
        df = pd.read_csv(path, sep="\t", header=None, names=names, nrows=max_rows)
        df[CRITEO_DENSE] = df[CRITEO_DENSE].fillna(0.0).astype(np.float64)
        for c in CRITEO_DENSE:
            lo, hi = df[c].min(), df[c].max()
            df[c] = (df[c] - lo) / (hi - lo) if hi > lo else 0.0
        for c in CRITEO_DENSE:
            X[c] = df[c].to_numpy(np.float32)[:, None]
        for c in CRITEO_SPARSE:
            raw = df[c]
            if hash_buckets is not None:
                vals = [None if (isinstance(v, float) and np.isnan(v)) else str(v)
                        for v in raw]
                ids = hash_strings_np(vals, hash_buckets, mask_zero=True)
                vocab = hash_buckets
            else:
                vals = raw.fillna("-1").astype(str).to_numpy()
                uniq, inv = np.unique(vals, return_inverse=True)
                ids = inv + 1  # 0 reserved for unseen
                vocab = len(uniq) + 1
            columns.append(SparseFeat(c, vocab, embedding_dim))
            X[c] = ids.astype(np.int32)
        y = df["label"].to_numpy(np.float32)

    y = np.asarray(y, np.float32)
    n = len(y)
    n_test = int(n * test_frac)
    tr = slice(0, n - n_test)
    te = slice(n - n_test, n)
    X_train = {k: v[tr] for k, v in X.items()}
    X_test = {k: v[te] for k, v in X.items()}
    return columns, X_train, y[tr], X_test, y[te]


def stream_criteo(
    path: str,
    batch_size: int,
    hash_buckets: int = 1 << 20,
    chunk_rows: int = 1 << 18,
    epochs: int = 1,
    threads: int = 0,
    prefetch_chunks: int = 2,
    drop_remainder: bool = True,
    shuffle_buffer_rows: int = 0,
    seed: int = 0,
    stats: Optional[Dict[str, float]] = None,
) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
    """Out-of-core Criteo batches of exactly ``batch_size`` rows (the last
    one shorter where ``drop_remainder`` is False), parsed in the
    background.

    A thread runs the native chunk parser (``native.iter_criteo_chunks``;
    ctypes releases the GIL) into a queue of at most ``prefetch_chunks``
    chunks of ``chunk_rows`` rows, so parsing overlaps the device. Dense
    values become ``log1p(max(x, 0))``; tokens ``hash % (buckets - 1) + 1``
    with 0 for a missing one, the in-memory hashed path's ids. Pair with
    :func:`criteo_columns`. Raises where the native parser did not build.

    ``shuffle_buffer_rows > 0`` keeps a pool of at least that many rows:
    once it holds more, the whole pool is permuted and full batches leave
    from its front until it is back at the bound. The permutations come
    from one generator seeded with ``seed`` that advances across epochs, so
    every epoch is shuffled differently and a rerun replays the same
    batches. On close the queue is drained and the parser thread stops.

    ``stats``, where given, accumulates seconds: ``parser_wait_s`` blocked
    on the queue, ``batch_s`` concatenating, permuting and bucketing.
    """
    import queue
    import threading
    import time

    from ..native import iter_criteo_chunks

    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch_chunks))
    stop = threading.Event()

    def put(item) -> bool:
        """Put unless the consumer stopped; False once it has."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for _ in range(epochs):
                for chunk in iter_criteo_chunks(path, chunk_rows, threads):
                    if stop.is_set() or not put(chunk):
                        return
            put(None)
        except BaseException as e:  # surface parser errors to the consumer
            put(e)

    worker = threading.Thread(target=produce, daemon=True)
    worker.start()

    span_b = np.uint64(hash_buckets - 1)
    clock = {"parser_wait_s": 0.0, "batch_s": 0.0} if stats is None else stats
    clock.setdefault("parser_wait_s", 0.0)
    clock.setdefault("batch_s", 0.0)

    def to_batch(labels, dense, hashes):
        t0 = time.perf_counter()
        X = {}
        d = np.log1p(np.maximum(dense, 0.0))
        for i, c in enumerate(CRITEO_DENSE):
            X[c] = d[:, i:i + 1]
        bucketed = (hashes % span_b + np.uint64(1)).astype(np.int32)
        bucketed = np.where(hashes == 0, 0, bucketed)
        for i, c in enumerate(CRITEO_SPARSE):
            X[c] = bucketed[:, i]
        clock["batch_s"] += time.perf_counter() - t0
        return X, labels

    def pool(pend_l, pend_d, pend_s):
        t0 = time.perf_counter()
        labels = np.concatenate(pend_l)
        dense = np.concatenate(pend_d)
        hashes = np.concatenate(pend_s)
        if rng is not None:
            perm = rng.permutation(len(labels))
            labels, dense, hashes = labels[perm], dense[perm], hashes[perm]
        clock["batch_s"] += time.perf_counter() - t0
        return labels, dense, hashes

    pend_l, pend_d, pend_s = [], [], []
    pending = 0
    pool_min = max(0, int(shuffle_buffer_rows))
    rng = np.random.default_rng(seed) if pool_min else None
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            clock["parser_wait_s"] += time.perf_counter() - t0
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            labels, dense, hashes = item
            pend_l.append(labels)
            pend_d.append(dense)
            pend_s.append(hashes)
            pending += len(labels)
            if pending < batch_size + pool_min:
                continue
            labels, dense, hashes = pool(pend_l, pend_d, pend_s)
            n_full = ((len(labels) - pool_min) // batch_size) * batch_size
            for lo in range(0, n_full, batch_size):
                sl = slice(lo, lo + batch_size)
                yield to_batch(labels[sl], dense[sl], hashes[sl])
            pend_l = [labels[n_full:]]
            pend_d = [dense[n_full:]]
            pend_s = [hashes[n_full:]]
            pending = len(labels) - n_full
        if pending:
            labels, dense, hashes = pool(pend_l, pend_d, pend_s)
            n_full = (len(labels) // batch_size) * batch_size
            for lo in range(0, n_full, batch_size):
                sl = slice(lo, lo + batch_size)
                yield to_batch(labels[sl], dense[sl], hashes[sl])
            if len(labels) > n_full and not drop_remainder:
                sl = slice(n_full, None)
                yield to_batch(labels[sl], dense[sl], hashes[sl])
    finally:
        stop.set()
        # drain so that the producer unblocks and exits
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break


def load_logireg(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The logistic-regression toy set (``LogiReg_data.txt``: two scores and
    a 0/1 label a line, comma-separated) -> ``(X [n, 2], y [n])`` float32."""
    arr = np.loadtxt(path, delimiter=",")
    return arr[:, :2].astype(np.float32), arr[:, 2].astype(np.float32)


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


# ---------------------------------------------------------------------------
# Avazu (hashed categorical CTR)
# ---------------------------------------------------------------------------

AVAZU_SPARSE = [
    "C1", "banner_pos", "site_id", "site_domain", "site_category",
    "app_id", "app_domain", "app_category", "device_id", "device_ip",
    "device_model", "device_type", "device_conn_type",
    "C14", "C15", "C16", "C17", "C18", "C19", "C20", "C21",
]


def load_avazu(
    path: str,
    embedding_dim: int = 8,
    hash_buckets: int = 1_000_000,
    test_frac: float = 0.2,
    max_rows: Optional[int] = None,
) -> Tuple[list, Dict[str, np.ndarray], np.ndarray, Dict[str, np.ndarray], np.ndarray]:
    """Load an Avazu CTR CSV (kaggle ``train.csv`` schema) into typed
    columns: the 21 categorical columns FNV-1a hashed into ``hash_buckets``
    (0 = missing); ``hour`` (YYMMDDHH) expanded into ``hour_of_day`` (24 +
    1) and ``day_of_week`` (7 + 1) instead of hashed. The split is the last
    ``test_frac`` of the rows. Returns (columns, X_train, y_train, X_test,
    y_test)."""
    import pandas as pd

    df = pd.read_csv(path, nrows=max_rows, dtype=str)
    y = df["click"].to_numpy(np.float32)

    columns: list = []
    X: Dict[str, np.ndarray] = {}

    ints = df["hour"].to_numpy(np.int64)
    hod = (ints % 100).astype(np.int32)
    dates = (ints // 100).astype(np.int64)  # YYMMDD
    # int -> datetime64 casts count from the 1970 epoch
    months = ((2000 + dates // 10000 - 1970).astype("datetime64[Y]")
              .astype("datetime64[M]")
              + ((dates // 100 % 100).astype("timedelta64[M]") - 1))
    days = (months.astype("datetime64[D]")
            + ((dates % 100).astype("timedelta64[D]") - 1))
    # 1970-01-01 was a Thursday (weekday 3, Monday = 0)
    dow = ((days.astype(np.int64) + 3) % 7).astype(np.int32)
    columns.append(SparseFeat("hour_of_day", 25, embedding_dim))
    X["hour_of_day"] = hod + 1  # 0 reserved for padding/missing
    columns.append(SparseFeat("day_of_week", 8, embedding_dim))
    X["day_of_week"] = dow + 1

    for c in AVAZU_SPARSE:
        vals = [None if (isinstance(v, float) and np.isnan(v)) else v for v in df[c]]
        X[c] = hash_strings_np(vals, hash_buckets, mask_zero=True).astype(np.int32)
        columns.append(SparseFeat(c, hash_buckets, embedding_dim))

    n = len(y)
    n_test = int(n * test_frac)
    tr, te = slice(0, n - n_test), slice(n - n_test, n)
    return (columns, {k: v[tr] for k, v in X.items()}, y[tr],
            {k: v[te] for k, v in X.items()}, y[te])


def synthetic_avazu(path: str, n_rows: int = 1_250_000, n_sites: int = 500,
                    n_apps: int = 300, seed: int = 0) -> int:
    """Write a deterministic synthetic CSV in the kaggle Avazu ``train.csv``
    schema with a learnable structure: per-site and per-app quality scores,
    banner position, hour-of-day and device-type effects, and a
    multiplicative site-category x app-category latent term that linear
    models cannot express. Mean CTR ~0.17. Returns the number of rows
    written."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    n_cats = 20
    q_site = rng.normal(0, 0.5, n_sites)
    q_app = rng.normal(0, 0.4, n_apps)
    u_sc = rng.normal(0, 1.0, (n_cats, 8)) / np.sqrt(8)
    v_ac = rng.normal(0, 1.0, (n_cats, 8)) / np.sqrt(8)
    site_cat = rng.integers(0, n_cats, n_sites)
    app_cat = rng.integers(0, n_cats, n_apps)
    dtype_eff = {0: 0.0, 1: 0.15, 4: -0.2, 5: -0.35}

    site = rng.integers(0, n_sites, n_rows)
    app = rng.integers(0, n_apps, n_rows)
    pos = rng.choice([0, 1, 2, 3, 4, 5, 7], n_rows,
                     p=[0.55, 0.25, 0.08, 0.05, 0.03, 0.02, 0.02])
    day = rng.integers(0, 10, n_rows)
    hod = rng.integers(0, 24, n_rows)
    dtv = rng.choice([0, 1, 4, 5], n_rows, p=[0.06, 0.80, 0.09, 0.05])

    cross = np.einsum("nk,nk->n", u_sc[site_cat[site]], v_ac[app_cat[app]])
    logit = (-1.85 + q_site[site] + q_app[app] - 0.12 * pos
             + 0.25 * np.sin(2 * np.pi * hod / 24.0)
             + np.vectorize(dtype_eff.get)(dtv) + 1.3 * cross)
    click = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int8)

    df = pd.DataFrame({
        "id": np.arange(n_rows, dtype=np.int64) + 10_000_000_000,
        "click": click,
        "hour": 14102100 + day * 100 + hod,
        "C1": 1000 + rng.integers(0, 8, n_rows),
        "banner_pos": pos,
        "site_id": np.char.add("s", site.astype("U6")),
        "site_domain": np.char.add("sd", (site // 5).astype("U6")),
        "site_category": np.char.add("sc", site_cat[site].astype("U3")),
        "app_id": np.char.add("a", app.astype("U6")),
        "app_domain": np.char.add("ad", (app // 4).astype("U6")),
        "app_category": np.char.add("ac", app_cat[app].astype("U3")),
        "device_id": np.char.add("d", rng.integers(0, 200_000, n_rows).astype("U7")),
        "device_ip": np.char.add("ip", rng.integers(0, 800_000, n_rows).astype("U7")),
        "device_model": np.char.add("m", rng.integers(0, 3000, n_rows).astype("U5")),
        "device_type": dtv,
        "device_conn_type": rng.choice([0, 2, 3, 5], n_rows),
        "C14": 15000 + rng.integers(0, 2000, n_rows),
        "C15": rng.choice([300, 320, 728], n_rows),
        "C16": rng.choice([50, 250, 90], n_rows),
        "C17": 1700 + (site // 2),
        "C18": rng.integers(0, 4, n_rows),
        "C19": 30 + rng.integers(0, 60, n_rows),
        "C20": rng.choice([-1, 100000, 100100, 100200], n_rows),
        "C21": rng.integers(0, 100, n_rows),
    })
    df.to_csv(path, index=False)
    return n_rows


# ---------------------------------------------------------------------------
# MovieLens behaviour sequences (DIN/DIEN, and DSSM's retrieval rows)
# ---------------------------------------------------------------------------

def load_movielens_ratings(path: str):
    """ml-100k ``u.data``: user_id \\t item_id \\t rating \\t timestamp."""
    import pandas as pd

    return pd.read_csv(
        path, sep="\t", header=None,
        names=["user_id", "item_id", "rating", "timestamp"],
    )


def build_behavior_dataset(
    ratings,
    seq_len: int = 10,
    embedding_dim: int = 8,
    like_threshold: int = 3,
    test_frac: float = 0.2,
    negsample: bool = False,
    seed: int = 0,
) -> Tuple[list, Dict[str, np.ndarray], np.ndarray, Dict[str, np.ndarray], np.ndarray]:
    """Behaviour-sequence CTR dataset for DIN/DIEN from a ratings frame
    (``load_movielens_ratings``): per user, the chronologically last
    interaction is the labelled example (label = rating > like_threshold)
    and the top-``seq_len`` liked earlier items its history, padded with id
    0. Columns: ``user_id``, ``item_id`` and a ``hist_item_id`` varlen
    column on the item table; with ``negsample``, a ``neg_hist_item_id``
    column of per-position uniform negatives (DIEN's auxiliary loss).
    Returns (columns, X_train, y_train, X_test, y_test)."""
    ratings = ratings.sort_values("timestamp")

    n_users = int(ratings["user_id"].max()) + 1
    n_items = int(ratings["item_id"].max()) + 1

    users, items, labels, hists, hist_lens = [], [], [], [], []
    for uid, grp in ratings.groupby("user_id", sort=False):
        if len(grp) < 2:
            continue
        hist_grp, last = grp.iloc[:-1], grp.iloc[-1]
        liked = hist_grp[hist_grp["rating"] > like_threshold]
        seq = liked.sort_values("rating", ascending=False)["item_id"].to_numpy()[:seq_len]
        pad = np.zeros(seq_len, dtype=np.int32)
        pad[: len(seq)] = seq
        users.append(uid)
        items.append(int(last["item_id"]))
        labels.append(1.0 if last["rating"] > like_threshold else 0.0)
        hists.append(pad)
        hist_lens.append(len(seq))

    columns = [
        SparseFeat("user_id", n_users, embedding_dim),
        SparseFeat("item_id", n_items, embedding_dim),
        VarLenSparseFeat(
            SparseFeat("hist_item_id", n_items, embedding_dim, embedding_name="item_id"),
            maxlen=seq_len, combiner="mean", length_name="hist_len",
        ),
    ]
    X = {
        "user_id": np.asarray(users, np.int32),
        "item_id": np.asarray(items, np.int32),
        "hist_item_id": np.stack(hists).astype(np.int32),
        "hist_len": np.asarray(hist_lens, np.int32),
    }
    if negsample:
        rng = np.random.default_rng(seed)
        neg = rng.integers(1, n_items, X["hist_item_id"].shape).astype(np.int32)
        neg = np.where(X["hist_item_id"] > 0, neg, 0)
        X["neg_hist_item_id"] = neg
        columns.append(VarLenSparseFeat(
            SparseFeat("neg_hist_item_id", n_items, embedding_dim,
                       embedding_name="item_id"),
            maxlen=seq_len, combiner="mean", length_name="hist_len"))
    y = np.asarray(labels, np.float32)
    n = len(y)
    n_test = int(n * test_frac)
    X_train = {k: v[: n - n_test] for k, v in X.items()}
    X_test = {k: v[n - n_test:] for k, v in X.items()}
    return columns, X_train, y[: n - n_test], X_test, y[n - n_test:]


def gen_sequence_dataset(
    interactions,
    user_col: str = "user_id",
    item_col: str = "item_id",
    time_col: str = "timestamp",
    seq_max_len: int = 50,
    negsample: int = 0,
    seed: int = 0,
):
    """Chronological prefix expansion for retrieval training (DSSM): each
    prefix of a user's item sequence predicts the next item; each user's
    last interaction is a test row; ``negsample`` uniform negatives of
    unseen items per positive. Returns (train_rows, test_rows), each row
    ``(user_id, item_id, label, history padded to seq_max_len, hist_len)``,
    the history most recent first."""
    rng = np.random.default_rng(seed)
    interactions = interactions.sort_values(time_col)
    all_items = interactions[item_col].unique()

    train_rows, test_rows = [], []
    for uid, grp in interactions.groupby(user_col, sort=False):
        pos = grp[item_col].tolist()
        if len(pos) < 2:
            continue
        neg = None
        if negsample > 0:
            candidates = np.setdiff1d(all_items, np.asarray(pos))
            if len(candidates):
                neg = rng.choice(candidates, size=len(pos) * negsample, replace=True)
        for i in range(1, len(pos)):
            hist = pos[:i][::-1][:seq_max_len]
            padded = np.zeros(seq_max_len, dtype=np.int32)
            padded[: len(hist)] = hist
            row = (uid, pos[i], 1.0, padded, len(hist))
            if i != len(pos) - 1:
                train_rows.append(row)
                if neg is not None:
                    for k in range(negsample):
                        train_rows.append(
                            (uid, int(neg[i * negsample + k]), 0.0, padded, len(hist)))
            else:
                test_rows.append(row)
    rng.shuffle(train_rows)
    rng.shuffle(test_rows)
    return train_rows, test_rows


def rows_to_batch(rows, seq_max_len: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Pack ``gen_sequence_dataset`` rows into a model-input dict."""
    X = {
        "user_id": np.asarray([r[0] for r in rows], np.int32),
        "item_id": np.asarray([r[1] for r in rows], np.int32),
        "hist_item_id": np.stack([r[3] for r in rows]).astype(np.int32),
        "hist_len": np.asarray([r[4] for r in rows], np.int32),
    }
    y = np.asarray([r[2] for r in rows], np.float32)
    return X, y


# ---------------------------------------------------------------------------
# Amazon behaviour sequences (DIN/DIEN)
# ---------------------------------------------------------------------------

def _open_maybe_gzip(path: str):
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "rt")
    return open(path, "r")


def load_amazon_reviews(reviews_path: str, meta_path: Optional[str] = None,
                        max_rows: Optional[int] = None):
    """Parse Amazon product-review JSON lines (the DIN paper's format):
    ``reviews_path`` lines with reviewerID / asin / unixReviewTime, and
    optionally ``meta_path`` lines with asin / categories (JSON or Python
    literals), which give each item a category id.

    Returns (df, n_users, n_items, n_cates, item_cate): df with integer
    user_id / item_id / cate_id (from 1; 0 pads) and timestamp, sorted
    chronologically, and ``item_cate[item_id] -> cate_id`` (row 0 pads)."""
    import ast
    import json

    import pandas as pd

    asin_cate: Dict[str, str] = {}
    if meta_path is not None:
        with _open_maybe_gzip(meta_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    rec = ast.literal_eval(line)  # Python-literal meta lines
                cats = rec.get("categories") or [["unknown"]]
                asin_cate[rec["asin"]] = cats[0][-1] if cats[0] else "unknown"

    users, asins, times = [], [], []
    with _open_maybe_gzip(reviews_path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            users.append(rec["reviewerID"])
            asins.append(rec["asin"])
            times.append(int(rec.get("unixReviewTime", 0)))

    df = pd.DataFrame({"user": users, "asin": asins, "timestamp": times})
    uuniq, uinv = np.unique(df["user"].to_numpy(), return_inverse=True)
    iuniq, iinv = np.unique(df["asin"].to_numpy(), return_inverse=True)
    df["user_id"] = (uinv + 1).astype(np.int32)
    df["item_id"] = (iinv + 1).astype(np.int32)
    cates = [asin_cate.get(a, "unknown") for a in iuniq]
    cuniq, cinv = np.unique(np.asarray(cates), return_inverse=True)
    item_cate = np.concatenate([[0], cinv + 1]).astype(np.int32)  # 0 pads
    df["cate_id"] = item_cate[df["item_id"].to_numpy()]
    df = df.sort_values("timestamp", kind="stable").reset_index(drop=True)
    return df, len(uuniq) + 1, len(iuniq) + 1, len(cuniq) + 1, item_cate


def build_amazon_behavior_dataset(
    reviews_path: str,
    meta_path: Optional[str] = None,
    seq_len: int = 50,
    embedding_dim: int = 8,
    max_rows: Optional[int] = None,
    negsample_hist: bool = False,
    seed: int = 0,
) -> Tuple[list, Dict[str, np.ndarray], np.ndarray, Dict[str, np.ndarray], np.ndarray]:
    """The DIN paper's Amazon behaviour dataset: per user's chronological
    review sequence, each next item over the history before it is a label-1
    example, paired with one uniformly sampled item the user never reviewed
    as a label-0 example over the same history; the last item tests, the
    rest train. Item and category histories share the target columns'
    tables. ``negsample_hist`` adds per-position negative histories
    (``neg_hist_item_id``, ``neg_hist_cate_id``) for DIEN's auxiliary loss.
    Returns (columns, X_train, y_train, X_test, y_test)."""
    df, n_users, n_items, n_cates, item_cate = load_amazon_reviews(
        reviews_path, meta_path, max_rows=max_rows)
    rng = np.random.default_rng(seed)

    def sample_neg(seen: set) -> int:
        while True:
            cand = int(rng.integers(1, n_items))
            if cand not in seen:
                return cand

    rows_train: List[tuple] = []
    rows_test: List[tuple] = []
    for uid, grp in df.groupby("user_id", sort=False):
        items = grp["item_id"].tolist()
        if len(items) < 2:
            continue
        seen = set(items)
        for i in range(1, len(items)):
            hist = items[max(0, i - seq_len): i]
            pad = np.zeros(seq_len, np.int32)
            pad[: len(hist)] = hist
            out = rows_test if i == len(items) - 1 else rows_train
            out.append((uid, items[i], 1.0, pad, len(hist)))
            out.append((uid, sample_neg(seen), 0.0, pad, len(hist)))

    columns = [
        SparseFeat("user_id", n_users, embedding_dim),
        SparseFeat("item_id", n_items, embedding_dim),
        SparseFeat("cate_id", n_cates, embedding_dim),
        VarLenSparseFeat(
            SparseFeat("hist_item_id", n_items, embedding_dim,
                       embedding_name="item_id"),
            maxlen=seq_len, combiner="mean", length_name="hist_len"),
        VarLenSparseFeat(
            SparseFeat("hist_cate_id", n_cates, embedding_dim,
                       embedding_name="cate_id"),
            maxlen=seq_len, combiner="mean", length_name="hist_len"),
    ]

    def pack(rows):
        rng.shuffle(rows)
        hist = np.stack([r[3] for r in rows]).astype(np.int32)
        item = np.asarray([r[1] for r in rows], np.int32)
        X = {
            "user_id": np.asarray([r[0] for r in rows], np.int32),
            "item_id": item,
            "cate_id": item_cate[item],
            "hist_item_id": hist,
            "hist_cate_id": item_cate[hist],
            "hist_len": np.asarray([r[4] for r in rows], np.int32),
        }
        if negsample_hist:
            neg = rng.integers(1, n_items, hist.shape).astype(np.int32)
            neg = np.where(hist > 0, neg, 0)
            X["neg_hist_item_id"] = neg
            X["neg_hist_cate_id"] = item_cate[neg]
        return X, np.asarray([r[2] for r in rows], np.float32)

    if negsample_hist:
        columns.append(VarLenSparseFeat(
            SparseFeat("neg_hist_item_id", n_items, embedding_dim,
                       embedding_name="item_id"),
            maxlen=seq_len, combiner="mean", length_name="hist_len"))
        columns.append(VarLenSparseFeat(
            SparseFeat("neg_hist_cate_id", n_cates, embedding_dim,
                       embedding_name="cate_id"),
            maxlen=seq_len, combiner="mean", length_name="hist_len"))

    X_train, y_train = pack(rows_train)
    X_test, y_test = pack(rows_test)
    return columns, X_train, y_train, X_test, y_test


def synthetic_amazon_reviews(
    reviews_path: str,
    meta_path: str,
    n_users: int = 5000,
    n_items: int = 2000,
    n_cates: int = 20,
    reviews_per_user: Tuple[int, int] = (5, 40),
    seed: int = 0,
) -> int:
    """Write a deterministic synthetic dataset in the Amazon JSON-lines
    format (a reviews file and a meta file) with a learnable structure: each
    user has 2 preferred categories and ~85 % of their reviews stay inside
    them. Returns the number of review lines written."""
    import json

    rng = np.random.default_rng(seed)
    item_cate = rng.integers(0, n_cates, n_items)
    with open(meta_path, "w") as f:
        for i in range(n_items):
            f.write(json.dumps({
                "asin": f"B{i:09d}",
                "categories": [["root", f"cate_{item_cate[i]:03d}"]],
            }) + "\n")

    cate_items = [np.where(item_cate == c)[0] for c in range(n_cates)]
    n_written = 0
    t0 = 1_300_000_000
    with open(reviews_path, "w") as f:
        for u in range(n_users):
            prefs = rng.choice(n_cates, size=2, replace=False)
            n_rev = int(rng.integers(*reviews_per_user))
            t = t0 + int(rng.integers(0, 10_000_000))
            for _ in range(n_rev):
                if rng.random() < 0.85:
                    pool = cate_items[int(prefs[rng.integers(0, 2)])]
                    item = (int(pool[rng.integers(0, len(pool))]) if len(pool)
                            else int(rng.integers(0, n_items)))
                else:
                    item = int(rng.integers(0, n_items))
                t += int(rng.integers(1, 100_000))
                f.write(json.dumps({
                    "reviewerID": f"U{u:08d}",
                    "asin": f"B{item:09d}",
                    "unixReviewTime": t,
                    "overall": float(rng.integers(1, 6)),
                }) + "\n")
                n_written += 1
    return n_written


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
