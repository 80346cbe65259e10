"""The port's copies of the behaviour datasets against the JAX package's, on
files generated in ``tmp_path``: MovieLens ratings (``load_movielens_ratings``,
``build_behavior_dataset`` with and without ``negsample``), the retrieval rows
(``gen_sequence_dataset``, ``rows_to_batch``) and the Amazon reviews
(``synthetic_amazon_reviews``, ``load_amazon_reviews``,
``build_amazon_behavior_dataset`` with ``negsample_hist``), all bit-exact; the
port imports without pandas; one fused DIEN step on the Amazon columns
against the JAX Trainer."""
import dataclasses
import gzip
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import optax

from recommender_system_tpu.models import DIEN as JDIEN
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.utils import datasets as jdatasets
from recommender_system_tpu_torch import DIEN, FusedAdagrad, Trainer
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params
from recommender_system_tpu_torch.training import Adagrad
from recommender_system_tpu_torch.utils import datasets as tdatasets

ROOT = Path(__file__).resolve().parents[1]
LR = 0.05
# training: f32 on both sides over chained steps
F32_RTOL, F32_ATOL = 1e-4, 1e-6


def _write_ratings(path, seed=0, n=600):
    """An ml-100k ``u.data``: 30 users, 80 items, ratings 1-5, timestamps
    with ties."""
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.integers(1, 31, n), rng.integers(1, 81, n), rng.integers(1, 6, n),
                     875_000_000 + rng.integers(0, 400, n)], axis=1)
    rows = np.concatenate([rows, [[31, 5, 4, 875_000_000]]])  # a user with one rating
    path.write_text("".join("\t".join(map(str, r)) + "\n" for r in rows))
    return path


def _assert_same_columns(got, want):
    assert [type(c).__name__ for c in got] == [type(c).__name__ for c in want]
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]


def _assert_same_arrays(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_same_dataset(got, want):
    _assert_same_columns(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        if isinstance(w, dict):
            _assert_same_arrays(g, w)
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_movielens_ratings_bit_exact(tmp_path):
    path = str(_write_ratings(tmp_path / "u.data"))
    pd.testing.assert_frame_equal(tdatasets.load_movielens_ratings(path),
                                  jdatasets.load_movielens_ratings(path))


@pytest.mark.parametrize("negsample", [False, True], ids=["plain", "negsample"])
def test_build_behavior_dataset_bit_exact(tmp_path, negsample):
    ratings = jdatasets.load_movielens_ratings(str(_write_ratings(tmp_path / "u.data", seed=1)))
    kw = dict(seq_len=6, embedding_dim=4, like_threshold=2, test_frac=0.25,
              negsample=negsample, seed=3)
    got = tdatasets.build_behavior_dataset(ratings, **kw)
    want = jdatasets.build_behavior_dataset(ratings, **kw)
    _assert_same_dataset(got, want)
    assert ("neg_hist_item_id" in got[1]) == negsample
    assert len(got[2]) > 10 and len(got[4]) > 3


@pytest.mark.parametrize("negsample", [0, 2])
def test_gen_sequence_dataset_bit_exact(tmp_path, negsample):
    ratings = jdatasets.load_movielens_ratings(str(_write_ratings(tmp_path / "u.data", seed=2)))
    got = tdatasets.gen_sequence_dataset(ratings, seq_max_len=7, negsample=negsample, seed=4)
    want = jdatasets.gen_sequence_dataset(ratings, seq_max_len=7, negsample=negsample, seed=4)
    for g_rows, w_rows in zip(got, want):
        assert len(g_rows) == len(w_rows) > 0
        for g, w in zip(g_rows, w_rows):
            assert g[:3] == w[:3] and g[4] == w[4]
            np.testing.assert_array_equal(g[3], w[3])
        Xg, yg = tdatasets.rows_to_batch(g_rows, 7)
        Xw, yw = jdatasets.rows_to_batch(w_rows, 7)
        _assert_same_arrays(Xg, Xw)
        np.testing.assert_array_equal(yg, yw)
        assert yg.dtype == yw.dtype
    if negsample:
        assert (np.asarray([r[2] for r in got[0]]) == 0.0).sum() > 0


def _amazon_files(tmp_path, gz=False):
    reviews, meta = tmp_path / "reviews.json", tmp_path / "meta.json"
    want = jdatasets.synthetic_amazon_reviews(str(tmp_path / "j_reviews.json"),
                                              str(tmp_path / "j_meta.json"), n_users=40,
                                              n_items=60, n_cates=6,
                                              reviews_per_user=(3, 9), seed=5)
    got = tdatasets.synthetic_amazon_reviews(str(reviews), str(meta), n_users=40, n_items=60,
                                             n_cates=6, reviews_per_user=(3, 9), seed=5)
    assert got == want > 0
    assert reviews.read_bytes() == (tmp_path / "j_reviews.json").read_bytes()
    assert meta.read_bytes() == (tmp_path / "j_meta.json").read_bytes()
    if gz:
        for path in (reviews, meta):
            with gzip.open(f"{path}.gz", "wt") as f:
                f.write(path.read_text())
        return f"{reviews}.gz", f"{meta}.gz"
    return str(reviews), str(meta)


@pytest.mark.parametrize("gz", [False, True], ids=["json", "gzip"])
def test_amazon_reviews_bit_exact(tmp_path, gz):
    reviews, meta = _amazon_files(tmp_path, gz)
    for kw in (dict(meta_path=meta), dict(meta_path=None, max_rows=50)):
        got = tdatasets.load_amazon_reviews(reviews, **kw)
        want = jdatasets.load_amazon_reviews(reviews, **kw)
        pd.testing.assert_frame_equal(got[0], want[0])
        assert got[1:4] == want[1:4]
        np.testing.assert_array_equal(got[4], want[4])


def test_amazon_meta_in_python_literals(tmp_path):
    reviews, _ = _amazon_files(tmp_path)
    meta = tmp_path / "meta.py.json"
    meta.write_text("{'asin': 'B000000001', 'categories': [['root', 'cameras']]}\n\n"
                    "{'asin': 'B000000002', 'categories': [[]]}\n")
    got = tdatasets.load_amazon_reviews(reviews, str(meta))
    want = jdatasets.load_amazon_reviews(reviews, str(meta))
    pd.testing.assert_frame_equal(got[0], want[0])
    assert got[3] == want[3] == 3  # padding, cameras and unknown


@pytest.mark.parametrize("negsample_hist", [False, True], ids=["plain", "negsample_hist"])
def test_build_amazon_behavior_dataset_bit_exact(tmp_path, negsample_hist):
    reviews, meta = _amazon_files(tmp_path)
    kw = dict(seq_len=5, embedding_dim=4, negsample_hist=negsample_hist, seed=6)
    got = tdatasets.build_amazon_behavior_dataset(reviews, meta, **kw)
    want = jdatasets.build_amazon_behavior_dataset(reviews, meta, **kw)
    _assert_same_dataset(got, want)
    assert ("neg_hist_cate_id" in got[1]) == negsample_hist


def test_port_imports_without_pandas():
    """The port's modules never need pandas to import (the card's machine
    has none); only the behaviour-data readers import it, when called."""
    code = ("import sys, importlib, pkgutil\n"
            "sys.modules['pandas'] = None\n"
            "import recommender_system_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "from recommender_system_tpu_torch.utils import datasets\n"
            "try:\n"
            "    datasets.load_movielens_ratings('u.data')\n"
            "except ImportError:\n"
            "    print('needs pandas when called')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "needs pandas when called"


# --------------------------------------------- DIEN on the Amazon columns

def test_fused_dien_step_on_amazon_columns_matches_jax(tmp_path):
    """Two fused DIEN steps (item and category behaviour, sampled
    histories) on the built columns against the JAX Trainer's dense Adagrad:
    one table_d4 holds the user, item and category ids, looked up at five
    sites (the [B, 3] group, two histories, two sampled histories), one
    stream a step."""
    reviews, meta = _amazon_files(tmp_path)
    jcols, X, y, _, _ = jdatasets.build_amazon_behavior_dataset(
        reviews, meta, seq_len=5, embedding_dim=4, negsample_hist=True, seed=7)
    tcols = tdatasets.build_amazon_behavior_dataset(reviews, meta, seq_len=5, embedding_dim=4,
                                                    negsample_hist=True, seed=7)[0]
    kw = dict(behavior_feature_list=("item_id", "cate_id"), use_negsampling=True,
              att_hidden_units=(6, 3), hidden_units=(8, 4))
    B = 24
    batches = [({k: v[i * B:(i + 1) * B] for k, v in X.items()}, y[i * B:(i + 1) * B])
               for i in range(2)]
    jtrainer = JTrainer(JDIEN(tuple(jcols), **kw), optimizer=optax.adagrad(LR))
    state = jtrainer.init(batches[0][0])
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.3, np.shape(a)).astype(np.float32), state.params)
    state = state.replace(params=params)
    step = jtrainer._make_train_step()
    want_losses = []
    for Xb, yb in batches:
        state, loss = step(state, Xb, yb)
        want_losses.append(float(loss))

    def port(p):
        model = DIEN(tcols, **kw, device="cpu", generator=torch.Generator().manual_seed(0))
        return load_jax_params(model, p)

    trainer = Trainer(port(params), Adagrad(LR), fused_embedding=FusedAdagrad(LR), device="cpu")
    got = trainer.multi_step(
        {k: torch.from_numpy(np.stack([Xb[k] for Xb, _ in batches])) for k in X},
        torch.from_numpy(np.stack([yb for _, yb in batches])))
    np.testing.assert_allclose(got.numpy(), want_losses, rtol=F32_RTOL, atol=F32_ATOL)
    want = load_jax_opt_state(Trainer(port(state.params), Adagrad(LR), device="cpu"),
                              state.opt_state, step=int(state.step))
    for name, p in want.model.named_parameters():
        np.testing.assert_allclose(dict(trainer.model.named_parameters())[name].detach().numpy(),
                                   p.detach().numpy(), rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=name)
    for name, (acc,) in trainer.fused_slots.items():
        np.testing.assert_allclose(acc.numpy(), want.opt_state[name]["sum_of_squares"].numpy(),
                                   rtol=F32_RTOL, atol=F32_ATOL, err_msg=name)
