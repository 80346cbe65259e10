"""The port's vocabulary encoding and timing helpers: ``utils/vocab.py``
bit-exact with the JAX package's (``tests/test_data.py``'s cases), a port
model on an ``encode_batch`` batch against the Flax model on the same
weights, and ``utils/benchmark.py``'s protocol under a patched clock."""
import numpy as np
import pytest
import torch

import jax

from recommender_system_tpu.models import DeepFM as JDeepFM
from recommender_system_tpu.utils import features as jfeatures
from recommender_system_tpu.utils import vocab as jvocab
from recommender_system_tpu_torch.convert import load_jax_params
from recommender_system_tpu_torch.models import DeepFM
from recommender_system_tpu_torch.utils import benchmark
from recommender_system_tpu_torch.utils import features as tfeatures
from recommender_system_tpu_torch.utils import vocab as tvocab


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_vocab_file_encoding(tmp_path):
    p = tmp_path / "vocab.csv"
    p.write_text("apple,1\nbanana,2\ncherry,3\n")
    vocab = tvocab.load_vocab_file(str(p))
    assert vocab == jvocab.load_vocab_file(str(p)) == {"apple": 1, "banana": 2, "cherry": 3}
    assert tvocab.load_vocab_file(str(p)) is vocab  # cached per path
    for values in (["banana", "unknown", None, "apple"], ["x", float("nan"), 3]):
        _same(tvocab.encode_with_vocab(values, vocab), jvocab.encode_with_vocab(values, vocab))
    _same(tvocab.encode_with_vocab((t for t in ["apple", "x"]), vocab),
          jvocab.encode_with_vocab((t for t in ["apple", "x"]), vocab))

    fc = tfeatures.SparseFeat("fruit", 10, 4, vocabulary_path=str(p))
    jfc = jfeatures.SparseFeat("fruit", 10, 4, vocabulary_path=str(p))
    _same(tvocab.encode_feature(fc, ["cherry", "nope"]),
          jvocab.encode_feature(jfc, ["cherry", "nope"]))
    # the varlen wrapper reaches through to the inner vocabulary_path
    vfc = tfeatures.VarLenSparseFeat(tfeatures.SparseFeat("hist", 10, 4,
                                                          vocabulary_path=str(p)), maxlen=2)
    jvfc = jfeatures.VarLenSparseFeat(jfeatures.SparseFeat("hist", 10, 4,
                                                           vocabulary_path=str(p)), maxlen=2)
    raw = [["apple", "cherry"], ["nope", "banana"]]
    _same(tvocab.encode_feature(vfc, raw), jvocab.encode_feature(jvfc, raw))
    # no vocabulary: ints pass through
    plain = tfeatures.SparseFeat("n", 10, 4)
    _same(tvocab.encode_feature(plain, [1, 2]),
          jvocab.encode_feature(jfeatures.SparseFeat("n", 10, 4), [1, 2]))

    cols = [fc, tfeatures.DenseFeat("d", 1), vfc]
    jcols = [jfc, jfeatures.DenseFeat("d", 1), jvfc]
    raw = {"fruit": ["apple"], "d": [[0.5]], "hist": [["cherry", "x"]], "other": [1]}
    got, want = tvocab.encode_batch(cols, raw), jvocab.encode_batch(jcols, raw)
    assert got.keys() == want.keys() == {"fruit", "d", "hist"}
    for key in want:
        _same(got[key], want[key])


def test_vocab_varlen_length_and_weight_columns(tmp_path):
    p = tmp_path / "v.csv"
    p.write_text("a,1\nb,2\n")
    kw = dict(maxlen=3, length_name="h_len", weight_name="h_w")
    vfc = tfeatures.VarLenSparseFeat(tfeatures.SparseFeat("h", 8, 4, vocabulary_path=str(p)),
                                     **kw)
    jvfc = jfeatures.VarLenSparseFeat(jfeatures.SparseFeat("h", 8, 4, vocabulary_path=str(p)),
                                      **kw)
    raw = {"h": [["a", "b", "z"]], "h_len": [2], "h_w": [[1.0, 0.5, 0.0]]}
    got, want = tvocab.encode_batch([vfc], raw), jvocab.encode_batch([jvfc], raw)
    assert got.keys() == want.keys() == {"h", "h_len", "h_w"}
    for key in want:
        _same(got[key], want[key])


def test_vocab_file_validation(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("apple,1\nbroken-line\n")
    with pytest.raises(ValueError, match="bad.csv:2"):
        tvocab.load_vocab_file(str(bad))
    nonint = tmp_path / "nonint.csv"
    nonint.write_text("apple,one\n")
    with pytest.raises(ValueError, match="non-integer"):
        tvocab.load_vocab_file(str(nonint))
    big = tmp_path / "big.csv"
    big.write_text("rare,10\n")
    fc = tfeatures.SparseFeat("f", 10, 4, vocabulary_path=str(big))
    with pytest.raises(ValueError, match="vocabulary_size"):
        tvocab.encode_feature(fc, ["rare"])


def test_model_on_an_encoded_batch_matches_flax(tmp_path):
    """DeepFM over vocabulary columns (one with ``use_hash``, which the
    vocabulary overrides): the port on ``encode_batch``'s batch equals the
    Flax model on the JAX ``encode_batch``'s, on transplanted weights."""
    rng = np.random.default_rng(0)
    tokens = [f"tok{i}" for i in range(30)]
    paths = {}
    for name in ("city", "brand"):
        path = tmp_path / f"{name}.csv"
        path.write_text("".join(f"{t},{i + 1}\n" for i, t in enumerate(tokens)))
        paths[name] = str(path)

    def columns(mod):
        return [mod.SparseFeat("city", 32, 4, vocabulary_path=paths["city"]),
                mod.SparseFeat("brand", 32, 4, use_hash=True, vocabulary_path=paths["brand"]),
                mod.DenseFeat("price", 1)]

    raw = {"city": list(rng.choice(tokens + ["unseen"], 16)),
           "brand": list(rng.choice(tokens, 16)),
           "price": rng.normal(size=(16, 1)).astype(np.float32)}
    jbatch = jvocab.encode_batch(columns(jfeatures), raw)
    batch = tvocab.encode_batch(columns(tfeatures), raw)
    for key in jbatch:
        _same(batch[key], jbatch[key])
    jmodel = JDeepFM(tuple(columns(jfeatures)), hidden_units=(8,))
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0), jbatch)["params"])
    want = np.asarray(jmodel.apply({"params": params}, jbatch))
    model = load_jax_params(DeepFM(columns(tfeatures), hidden_units=(8,), device="cpu",
                                   generator=torch.Generator().manual_seed(0)), params)
    model.eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- benchmark

class _Clock:
    """``time.perf_counter`` stand-in that only the work under test
    advances."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_time_iterations_order_and_arithmetic_on_the_host(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(benchmark.time, "perf_counter", clock)
    calls = []

    def run_n(n):
        calls.append(n)
        clock.now += 0.5 + 0.25 * n  # a fixed tail a window, 0.25 s an iteration
        return n

    assert benchmark.time_iterations(run_n, 10, 40, device="cpu") == pytest.approx(0.25)
    assert calls == [5, 10, 40]  # warm-up, then the two windows
    calls.clear()
    benchmark.time_iterations(run_n, 1, 3, device="cpu")
    assert calls == [1, 1, 3]  # the warm-up runs at least once


class _Event:
    """``torch.cuda.Event`` stand-in on a shared log: ``elapsed_time``
    between two records is the scripted milliseconds of the work between
    them; ``synchronize`` is logged."""

    log = []
    streams = []
    work_ms = {}

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream=None):
        _Event.log.append("record")
        _Event.streams.append(stream)
        self.at = len(_Event.log)

    def synchronize(self):
        _Event.log.append("sync")

    def elapsed_time(self, end):
        between = [e for e in _Event.log[self.at:end.at] if isinstance(e, int)]
        return sum(_Event.work_ms[n] for n in between)


def _fake_streams(monkeypatch):
    """``torch.cuda.current_stream(device)`` stand-in: a name per device."""
    monkeypatch.setattr(benchmark.torch.cuda, "current_stream",
                        lambda device=None: f"stream of {device}")


def test_time_iterations_on_the_card_uses_event_pairs(monkeypatch):
    """On a card each window lies between two CUDA events, recorded on the
    card's current stream, and the host waits for the second after each
    window; no host clock is read."""
    monkeypatch.setattr(benchmark.torch.cuda, "Event", _Event)
    _fake_streams(monkeypatch)
    monkeypatch.setattr(benchmark.time, "perf_counter",
                        lambda: pytest.fail("the host clock timed a card's window"))
    _Event.log.clear()
    _Event.streams.clear()
    _Event.work_ms.update({5: 10.0, 10: 12.0, 40: 24.0})

    def run_n(n):
        _Event.log.append(n)

    seconds = benchmark.time_iterations(run_n, 10, 40, device="cuda")
    assert seconds == pytest.approx((24.0 - 12.0) / 1e3 / 30)
    assert _Event.log == ["record", 5, "record", "sync", "record", 10, "record", "sync",
                          "record", 40, "record", "sync"]
    assert _Event.streams == ["stream of cuda"] * 6


def test_time_iterations_records_on_the_named_cards_stream(monkeypatch):
    """``device="cuda:1"`` records every event on card 1's current stream,
    whichever card is current."""
    monkeypatch.setattr(benchmark.torch.cuda, "Event", _Event)
    _fake_streams(monkeypatch)
    _Event.log.clear()
    _Event.streams.clear()
    _Event.work_ms.update({1: 3.0, 2: 4.0, 4: 6.0})
    seconds = benchmark.time_iterations(lambda n: _Event.log.append(n), 2, 4,
                                        device="cuda:1")
    assert seconds == pytest.approx((6.0 - 4.0) / 1e3 / 2)
    assert _Event.streams == ["stream of cuda:1"] * 6


def test_bench_fn_and_bench_train_step_chain_calls(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(benchmark.time, "perf_counter", clock)
    seen = []

    def f(x):
        seen.append(x)
        clock.now += 0.002
        return x

    assert benchmark.bench_fn(f, 7, n1=4, n2=12, device="cpu") == pytest.approx(0.002)
    assert seen == [7] * (2 + 4 + 12)
    losses = []

    def step(scale):
        clock.now += 0.003
        losses.append(scale * len(losses))
        return torch.tensor(losses[-1])

    assert benchmark.bench_train_step(step, 2.0, n1=2, n2=6, device="cpu") == \
        pytest.approx(0.003)
    assert len(losses) == 1 + 2 + 6
