"""The port's training loops against the JAX package's on the same
Criteo-format TSV, weights carried across: ``Trainer.fit_stream`` per
batch and packed (K=4, a short tail and ``max_steps`` included) and the
in-memory ``fit`` over ``load_criteo``. The port runs plain Adagrad and the
fused Adagrad, the JAX side its dense optax Adagrad; losses, parameters and
accumulators agree at f32 tolerance. Checkpoints:
``tests/test_torch_checkpoint.py``."""
import functools

import numpy as np
import pytest
import torch

import jax
import optax

from recommender_system_tpu.models import DeepFM as JDeepFM
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.utils import datasets as jdatasets
from recommender_system_tpu_torch import DeepFM, FusedAdagrad, Trainer
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params
from recommender_system_tpu_torch.training import Adagrad
from recommender_system_tpu_torch.utils import datasets
from tests.test_torch_criteo_data import write_criteo_tsv

LR, BUCKETS, DIM, BATCH, K = 0.05, 500, 4, 64, 4
HIDDEN = (16, 8)
ROWS = 1100  # 17 batches of 64: four packed groups and a tail of one
# f32 on both sides over chained steps; sums in another order
F32_RTOL, F32_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    return write_criteo_tsv(tmp_path_factory.mktemp("stream") / "train.tsv", ROWS)


COLUMNS = datasets.criteo_columns(embedding_dim=DIM, hash_buckets=BUCKETS)


@functools.lru_cache(maxsize=None)
def _jax_trainer():
    """One JAX Trainer for every run, so its compiled steps are shared."""
    from recommender_system_tpu.utils.datasets import criteo_columns

    cols = criteo_columns(embedding_dim=DIM, hash_buckets=BUCKETS)
    return JTrainer(JDeepFM(tuple(cols), hidden_units=HIDDEN), optimizer=optax.adagrad(LR),
                    seed=0)


def _stream(mod, path):
    return mod.stream_criteo(path, batch_size=BATCH, hash_buckets=BUCKETS, chunk_rows=300,
                             shuffle_buffer_rows=200, seed=1)


def _jax_start(path):
    trainer = _jax_trainer()
    first = next(iter(_stream(jdatasets, path)))[0]
    return trainer, trainer.init(first)


_JAX_RUNS = {}


def _jax_run(path, kind, steps_per_call=1, max_steps=0):
    key = (kind, steps_per_call, max_steps)
    if key not in _JAX_RUNS:
        trainer, state = _jax_start(path)
        start = jax.tree_util.tree_map(np.asarray, state.params)
        if kind == "stream":
            state, history = trainer.fit_stream(state, _stream(jdatasets, path),
                                                steps_per_call=steps_per_call,
                                                max_steps=max_steps)
        else:
            _, X, y, _, _ = jdatasets.load_criteo(path, embedding_dim=DIM,
                                                  hash_buckets=BUCKETS)
            state, history = trainer.fit(state, X, y, batch_size=BATCH, epochs=2)
        _JAX_RUNS[key] = (start, jax.tree_util.tree_map(np.asarray, state), history)
    return _JAX_RUNS[key]


def _port_trainer(params, fused):
    model = load_jax_params(DeepFM(tuple(COLUMNS), hidden_units=HIDDEN, device="cpu",
                                   generator=torch.Generator().manual_seed(0)), params)
    return Trainer(model, Adagrad(LR), fused_embedding=FusedAdagrad(LR) if fused else None,
                   device="cpu")


def _view(trainer):
    """Parameters, and each one's Adagrad accumulator (a table's fused slot
    under the name the dense Adagrad gives it)."""
    out = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}
    for n, slots in trainer.opt_state.items():
        out.update({f"{k}:{n}": v.numpy().copy() for k, v in slots.items()})
    for n, (acc,) in trainer.fused_slots.items():
        out[f"sum_of_squares:{n}"] = acc.numpy().copy()
    return out


def _jax_view(state):
    trainer = _port_trainer(state.params, fused=False)
    return _view(load_jax_opt_state(trainer, state.opt_state, step=int(state.step)))


# case -> (port fused, steps_per_call, max_steps)
STREAM_CASES = {
    "per_batch_plain": (False, 1, 0),
    "per_batch_fused": (True, 1, 0),
    "packed_plain": (False, K, 0),
    "packed_fused": (True, K, 0),
    "packed_fused_max_steps": (True, K, 10),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_fit_stream_follows_jax(tsv, case):
    fused, steps_per_call, max_steps = STREAM_CASES[case]
    start, state, history = _jax_run(tsv, "stream", steps_per_call, max_steps)
    trainer = _port_trainer(start, fused)
    timings = {}
    got = trainer.fit_stream(_stream(datasets, tsv), steps_per_call=steps_per_call,
                             max_steps=max_steps, timings=timings)
    assert trainer.step == int(state.step) == (12 if max_steps else ROWS // BATCH)
    np.testing.assert_allclose(got["loss"], history["loss"], rtol=F32_RTOL, atol=F32_ATOL)
    want = _jax_view(state)
    got_view = _view(trainer)
    assert got_view.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got_view[name], want[name], rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=name)
    assert timings["input_s"] > 0 and timings["step_s"] > 0
    assert (timings["pack_s"] > 0) == (steps_per_call > 1)


@pytest.mark.parametrize("fused", [False, True])
def test_fit_follows_jax(tsv, fused):
    """The in-memory ``fit`` draws each epoch's order as the JAX ``fit``
    does (``seed + epoch``)."""
    start, state, history = _jax_run(tsv, "fit")
    _, X, y, _, _ = datasets.load_criteo(tsv, embedding_dim=DIM, hash_buckets=BUCKETS)
    trainer = _port_trainer(start, fused)
    got = trainer.fit(X, y, batch_size=BATCH, epochs=2)
    assert trainer.step == int(state.step)
    np.testing.assert_allclose(got["loss"], history["loss"], rtol=F32_RTOL, atol=F32_ATOL)
    want = _jax_view(state)
    got_view = _view(trainer)
    for name in want:
        np.testing.assert_allclose(got_view[name], want[name], rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=name)


def test_packed_ids_past_int32_raise():
    trainer = Trainer(DeepFM(tuple(COLUMNS), hidden_units=HIDDEN, device="cpu",
                             generator=torch.Generator().manual_seed(0)),
                      Adagrad(LR), device="cpu")
    X, y = next(iter(datasets.iter_batches(
        datasets.synthetic_criteo(n_rows=BATCH, vocab=BUCKETS, embedding_dim=DIM)[1],
        np.zeros(BATCH, np.float32), BATCH)))
    X = dict(X, C1=X["C1"].astype(np.int64) + 2 ** 31)
    with pytest.raises(ValueError, match="outside int32 range"):
        trainer.fit_stream(iter([(X, y)] * 2), steps_per_call=2)
