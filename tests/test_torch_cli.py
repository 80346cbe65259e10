"""The port's training CLI against the JAX package's: ``parse_args`` gives
the JAX ``ExperimentConfig``'s fields for the same argv; ``build_data``
builds the same columns and arrays for every dataset name (the DIEN
negatives and MMOE's second task included); ``make_loss_fn`` computes the
same losses; ``--mesh-data`` outside torchrun raises; without ``--device`` and with no card
the CLI raises; ``main`` prints one JSON line. ``run`` itself:
``tests/test_torch_cli_run.py``."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recommender_system_tpu import train as jtrain
from recommender_system_tpu.config import ExperimentConfig as JConfig
from recommender_system_tpu_torch import ExperimentConfig, train
from recommender_system_tpu_torch.utils import datasets
from tests.test_torch_behavior_data import _assert_same_dataset, _write_ratings
from tests.test_torch_criteo_data import write_criteo_tsv


ARGVS = {
    "defaults": [],
    "dcn": ["--model", "dcn", "--epochs", "3", "--hidden-units", "64", "32",
            "--hash-buckets", "1000", "--dnn-dtype", "bfloat16"],
    "north_star": ["--stream", "--data-path", "train.txt", "--fused-embedding", "adagrad",
                   "--batch-size", "16384", "--hash-buckets", "1000000",
                   "--stream-eval-path", "heldout.txt", "--stream-steps-per-call", "4",
                   "--stream-shuffle-rows", "100000", "--stream-max-steps", "16",
                   "--checkpoint-every", "8", "--checkpoint-dir", "ck", "--resume",
                   "--stream-chunk-rows", "1000", "--stream-prefetch", "3"],
    "everything_else": ["--model", "dssm", "--dataset", "movielens", "--dssm-loss",
                        "logistic", "--learning-rate", "0.05", "--optimizer", "adagrad",
                        "--weight-decay", "0.001", "--seed", "7", "--seq-len", "20",
                        "--max-rows", "999", "--embedding-dim", "16", "--mesh-data", "2",
                        "--mesh-model", "2", "--explicit-lookup", "--capacity-factor", "1.5",
                        "--profile-dir", "prof", "--log-every", "10"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_parse_args_matches_jax(case):
    argv = ARGVS[case]
    got = dataclasses.asdict(train.parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == dataclasses.asdict(jtrain.parse_args(argv))
    assert train.parse_args(argv).device is None
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    assert fields == {f.name for f in dataclasses.fields(JConfig)} | {"device"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_data")
    reviews, meta = root / "reviews.json", root / "meta.json"
    datasets.synthetic_amazon_reviews(str(reviews), str(meta), n_users=40, n_items=60,
                                      seed=3)
    datasets.synthetic_avazu(str(root / "avazu.csv"), n_rows=300, seed=1)
    return {"criteo": write_criteo_tsv(root / "train.tsv", 400),
            "movielens": str(_write_ratings(root / "u.data")),
            "amazon": f"{reviews},{meta}", "avazu": str(root / "avazu.csv")}


# case -> (config fields, data file key)
DATA_CASES = {
    "synthetic_deepfm": (dict(model="deepfm", dataset="synthetic"), None),
    "synthetic_din": (dict(model="din", dataset="synthetic"), None),
    "synthetic_dien": (dict(model="dien", dataset="synthetic"), None),
    "synthetic_dssm": (dict(model="dssm", dataset="synthetic"), None),
    "synthetic_mmoe": (dict(model="mmoe", dataset="synthetic"), None),
    "synthetic_behavior_din": (dict(model="din", dataset="synthetic_behavior"), None),
    "synthetic_behavior_mmoe": (dict(model="mmoe", dataset="synthetic_behavior"), None),
    "tokens_lstm": (dict(model="lstm", dataset="synthetic_tokens", hash_buckets=90), None),
    "tokens_transformer": (dict(model="transformer", dataset="synthetic", seq_len=12), None),
    "criteo_hashed": (dict(model="deepfm", dataset="criteo", hash_buckets=500), "criteo"),
    "criteo_label_encoded_mmoe": (dict(model="mmoe", dataset="criteo"), "criteo"),
    "avazu": (dict(model="deepfm", dataset="avazu", hash_buckets=300), "avazu"),
    "amazon_dien": (dict(model="dien", dataset="amazon", seq_len=8), "amazon"),
    "movielens_dien": (dict(model="dien", dataset="movielens", seq_len=5), "movielens"),
    "movielens_din": (dict(model="din", dataset="movielens"), "movielens"),
}


@pytest.mark.parametrize("case", sorted(DATA_CASES))
def test_build_data_matches_jax(case, files):
    fields, key = DATA_CASES[case]
    fields = dict(fields, max_rows=fields.get("max_rows", 300), embedding_dim=4, seed=2)
    if key:
        fields["data_path"] = files[key]
    got = train.build_data(ExperimentConfig(**fields))
    want = jtrain.build_data(JConfig(**fields))
    if isinstance(want[1], dict):
        _assert_same_dataset(got, want)
    else:  # token ids: no columns, arrays
        assert got[0] == want[0] == []
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if fields["model"] == "mmoe" and fields["dataset"].startswith("synthetic"):
        assert got[2].shape[1] == 2  # the second task
    if fields["model"] == "dien":
        assert "neg_hist_item_id" in got[1]


@pytest.mark.parametrize("dataset", ["criteo", "movielens"])
def test_build_data_falls_back_without_a_file(dataset):
    """Without ``--data-path`` the Criteo and MovieLens datasets are the
    synthetic stand-ins the JAX CLI falls back to where its default files
    are missing."""
    model = "deepfm" if dataset == "criteo" else "din"
    fields = dict(model=model, max_rows=300, embedding_dim=4)
    stand_in = "synthetic" if dataset == "criteo" else "synthetic_behavior"
    _assert_same_dataset(train.build_data(ExperimentConfig(dataset=dataset, **fields)),
                         jtrain.build_data(JConfig(dataset=stand_in, **fields)))


@pytest.mark.parametrize("model,dssm_loss", [("dssm", "inbatch"), ("dssm", "logistic"),
                                             ("deepfm", "inbatch")])
def test_make_loss_fn_matches_jax(model, dssm_loss):
    rng = np.random.default_rng(5)
    fields = dict(model=model, dssm_loss=dssm_loss, model_kwargs={"temperature": 0.2})
    ours = train.make_loss_fn(ExperimentConfig(**fields))
    theirs = jtrain.make_loss_fn(JConfig(**fields))
    labels = rng.integers(0, 2, 16).astype(np.float32)
    if model == "dssm":
        u, v = rng.normal(size=(2, 16, 8)).astype(np.float32)
        items = rng.integers(1, 6, 16).astype(np.int32)  # repeated items are masked
        got = ours((torch.as_tensor(u), torch.as_tensor(v)), torch.as_tensor(labels),
                   {"item_id": torch.as_tensor(items)})
        want = theirs((jnp.asarray(u), jnp.asarray(v)), jnp.asarray(labels),
                      {"item_id": jnp.asarray(items)})
    else:
        logits = rng.normal(size=(16, 1)).astype(np.float32)
        got = ours(torch.as_tensor(logits), torch.as_tensor(labels), {})
        want = theirs(jnp.asarray(logits), jnp.asarray(labels), {})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_mesh_data_raises():
    """``--mesh-data`` runs under torchrun only (``tests/test_torch_parallel.py``
    runs it there)."""
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--model", "deepfm", "--dataset", "synthetic", "--max-rows", "256",
                    "--epochs", "1", "--mesh-data", "2", "--device", "cpu"])


def test_without_device_and_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--model", "deepfm", "--dataset", "synthetic", "--max-rows", "256",
                    "--epochs", "1"])


def test_main_prints_one_json_line(capsys):
    result = train.main(["--device", "cpu", "--model", "deepfm", "--dataset", "synthetic",
                         "--max-rows", "512", "--epochs", "1", "--batch-size", "128"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert list(result) == ["model", "train_loss", "examples_per_sec", "auc", "logloss",
                            "accuracy"]
