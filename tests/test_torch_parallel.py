"""The port's mesh against the JAX package's (``tests/test_parallel.py``, on
a mesh of four CPU devices there, four gloo ranks here): the mod-sharded
lookup and its gradient, the overflow policy, the full-capacity exchange
that stands for GSPMD's gather, ``Trainer(mesh=...)`` against one device,
the row rule for every table width, checkpoints, logging by rank, the model
axis's set-up, and ``--mesh-data`` under torchrun."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_ranks as ranks_lib
from recommender_system_tpu.models import DeepFM as JDeepFM
from recommender_system_tpu.parallel.embedding import gspmd_lookup as j_gspmd_lookup
from recommender_system_tpu.parallel.embedding import mod_shard_table as j_mod_shard_table
from recommender_system_tpu.parallel.embedding import sharded_lookup as j_sharded_lookup
from recommender_system_tpu.parallel.mesh import make_mesh as j_make_mesh
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.utils.datasets import iter_batches as j_iter_batches
from recommender_system_tpu.utils.datasets import synthetic_criteo as j_synthetic_criteo
from recommender_system_tpu_torch import ExperimentConfig, train
from recommender_system_tpu_torch.parallel import (host_batch_slice, initialize, make_mesh,
                                                   mod_shard_table, unshard_table)
from recommender_system_tpu_torch.parallel.mesh import Mesh
from recommender_system_tpu_torch.training.checkpoint import latest_step, restore_checkpoint
from recommender_system_tpu_torch.utils.datasets import synthetic_criteo
from recommender_system_tpu_torch.utils.logging import get_logger, is_host_zero, seed_everything

N_RANKS = ranks_lib.WORLD
F32 = dict(rtol=1e-4, atol=1e-6)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = ranks_lib.RankPool(N_RANKS, tmp_path_factory.mktemp("gloo"))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(data=N_RANKS, model=1)


# ------------------------------------------------------ mod-sharded lookup

def test_mod_shard_roundtrip():
    table = np.random.default_rng(0).normal(size=(103, 8)).astype(np.float32)
    sharded = mod_shard_table(table, 8)
    np.testing.assert_array_equal(sharded, j_mod_shard_table(table, 8))
    np.testing.assert_array_equal(unshard_table(sharded, 103), table)


def test_alltoall_lookup_matches_gather(ranks, jmesh):
    rng = np.random.default_rng(1)
    V, d, B = 512, 16, 256
    table = rng.normal(size=(V, d)).astype(np.float32)
    ids = rng.integers(0, V, B).astype(np.int32)
    sharded = mod_shard_table(table, N_RANKS)
    results = ranks.run(ranks_lib.mod_lookup_on_mesh, sharded, ids, 8.0, False)
    for out, _ in results:  # every rank holds the global rows
        np.testing.assert_array_equal(out, table[ids])
    want = j_sharded_lookup(jnp.asarray(sharded), jnp.asarray(ids), jmesh, capacity_factor=8.0)
    np.testing.assert_array_equal(results[0][0], np.asarray(want))


def test_alltoall_lookup_gradient_is_scatter_add(ranks):
    rng = np.random.default_rng(2)
    V, d, B = 128, 4, 64
    table = rng.normal(size=(V, d)).astype(np.float32)
    ids = rng.integers(0, V, B).astype(np.int32)
    results = ranks.run(ranks_lib.mod_lookup_on_mesh, mod_shard_table(table, N_RANKS), ids,
                        8.0, True)
    grad = unshard_table(np.stack([g for _, g in results]), V)
    expected = np.zeros_like(table)
    np.add.at(expected, ids, 2 * table[ids])
    np.testing.assert_allclose(grad, expected, rtol=1e-5, atol=1e-6)


def test_alltoall_overflow_policy(ranks, jmesh):
    """Ids past a destination's capacity read zero vectors, not garbage:
    the same rows as the JAX package's."""
    V, d, B = 64, 4, 64
    table = np.random.default_rng(0).normal(size=(V, d)).astype(np.float32)
    ids = np.zeros(B, np.int32) + 8  # every id on shard 0
    sharded = mod_shard_table(table, N_RANKS)
    out = ranks.run(ranks_lib.mod_lookup_on_mesh, sharded, ids, 1.0, False)[0][0]
    ok = np.isclose(out, table[ids]).all(1)
    zero = np.isclose(out, 0.0).all(1)
    assert np.all(ok | zero) and ok.any() and zero.any()
    want = j_sharded_lookup(jnp.asarray(sharded), jnp.asarray(ids), jmesh, capacity_factor=1.0)
    np.testing.assert_array_equal(out, np.asarray(want))


def test_gspmd_lookup_matches_gather(ranks, jmesh):
    """The full-capacity block exchange: GSPMD's gather, exact."""
    rng = np.random.default_rng(3)
    d, B = 8, 128
    for V in (256, 258):  # 258 rows split unevenly over the ranks
        table = rng.normal(size=(V, d)).astype(np.float32)
        ids = rng.integers(0, V, B).astype(np.int32)
        ids[:40] = 7  # 40 ids on one shard: more than a capacity factor of 2 takes
        for out in ranks.run(ranks_lib.gspmd_on_mesh, table, ids):
            np.testing.assert_array_equal(out, table[ids])
    want = j_gspmd_lookup(jnp.asarray(table[:256]), jnp.asarray(ids % 256), jmesh)
    got = ranks.run(ranks_lib.gspmd_on_mesh, table[:256].copy(), ids % 256)[0]
    np.testing.assert_array_equal(got, np.asarray(want))



def test_collection_on_a_mesh_reads_every_column(ranks):
    """A sharded ``EmbeddingCollection`` looks its rows up through the
    exchange for every column, a frozen varlen column too, in train and in
    eval mode, as its whole tables would."""
    rng = np.random.default_rng(6)
    batch = {"user_id": rng.integers(1, 64, 32).astype(np.int32),
             "item_id": rng.integers(1, 64, 32).astype(np.int32),
             "hist_item_id": rng.integers(0, 64, (32, 4)).astype(np.int32)}
    for worst, shape in ranks.run(ranks_lib.collection_on_mesh, batch):
        assert worst == 0.0
        # 128 rows, 16 a wide row: 8 wide rows, rounded to 512 -> 8,192 rows
        assert shape == (512 * 16 // N_RANKS, 8)


# ------------------------------------------------------------------- Trainer

def test_trainer_with_mesh_matches_single_device(ranks, jmesh):
    """DP with row-sharded tables (the default Adam, the plain step, the
    lookup at full capacity): the table really is split, fit's history is
    the single-device one, and the JAX mesh Trainer's within its own test's
    tolerance."""
    jcols, X, y = j_synthetic_criteo(n_rows=256, vocab=64, embedding_dim=8)
    tcols = synthetic_criteo(n_rows=8, vocab=64, embedding_dim=8)[0]
    jtrainer = JTrainer(JDeepFM(tuple(jcols), hidden_units=(32, 16)), mesh=jmesh)
    state = jtrainer.init(next(j_iter_batches(X, y, 64))[0])
    params = jax.tree_util.tree_map(np.asarray, dict(state.params))
    _, j_hist = jtrainer.fit(state, X, y, batch_size=64, epochs=2)
    spec = {"columns": tcols, "hidden": (32, 16), "optimizer": ("adam", 1e-3)}
    fit_kw = dict(batch_size=64, epochs=2)
    results = ranks.run(ranks_lib.fit_on_mesh, "deepfm", spec, params, None, X, y, {},
                        fit_kw)
    name = "unified.embeddings.table_d9"
    assert [r["shard_rows"][name] for r in results] == [(512 * 14 // N_RANKS, 9)] * N_RANKS
    hist = results[0]["history"]
    assert "embedding_overflow" not in hist  # counted with a fused optimizer only
    assert hist["loss"][-1] < hist["loss"][0] + 1e-3
    single = ranks_lib.build_trainer("deepfm", spec, params)
    np.testing.assert_allclose(hist["loss"], single.fit(X, y, **fit_kw)["loss"], **F32)
    view = ranks_lib.view(single)
    for key, value in view.items():
        np.testing.assert_allclose(results[0]["view"][key], value, err_msg=key, **F32)
    np.testing.assert_allclose(hist["loss"], j_hist["loss"], rtol=2e-3, atol=2e-3)


def test_mmoe_on_a_data_mesh_and_the_model_axis_raises(ranks):
    """MMOE's experts stay replicated on a data mesh and train as on one
    device. The model axis that shards them works now
    (``tests/test_torch_model_axis.py``): the same ranks make a 2 x 2 mesh,
    and ``build_mesh`` asks torchrun for data x model ranks."""
    rng = np.random.default_rng(4)
    X = rng.random((256, 16)).astype(np.float32)
    y = np.stack([(X.sum(1) > 8).astype(np.float32), (X[:, 0] > 0.5).astype(np.float32)], 1)
    spec = {"in_features": 16, "optimizer": ("adam", 1e-2)}
    fit_kw = dict(batch_size=64, epochs=2)
    results = ranks.run(ranks_lib.fit_on_mesh, "mmoe", spec, None, None, X, y, {}, fit_kw)
    single = ranks_lib.build_trainer("mmoe", spec, None)
    np.testing.assert_allclose(results[0]["history"]["loss"], single.fit(X, y, **fit_kw)["loss"],
                               **F32)
    for key, value in ranks_lib.view(single).items():
        np.testing.assert_allclose(results[0]["view"][key], value, err_msg=key, **F32)
    assert results[0]["shard_rows"] == {}  # nothing of MMOE's is split without a model axis
    grid = ranks.run(ranks_lib.on_grid, (2, 2), ranks_lib.axes_on_mesh)
    assert [r[0][2:] for r in grid] == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0), (2, 2, 1, 1)]
    with pytest.raises(RuntimeError, match="nproc-per-node 4"):
        ExperimentConfig(mesh_data=2, mesh_model=2, device="cpu").build_mesh()


def test_wide_table_rows_split_as_the_jax_stacks():
    """Every table shards by row (the JAX package's rule without column
    sharding, which its exchange paths force): a shard holds the logical
    rows of its block of the JAX stack's 512-rounded wide rows."""
    mesh = Mesh(group=None, n=4, rank=1, data=4, model=1, device=torch.device("cpu"))
    # dim 64: 2 rows a 128-lane row, 32 wide rows rounded to 512
    assert mesh.shard_rows(64, 64) == (256, 1024)
    # dim 9: 14 rows a wide row; 26 fields of 64 ids, 119 wide rows -> 512
    assert mesh.shard_rows(1664, 9) == (1792, 7168)
    # dim 156 (FFM): one row a wide row, 1,000 rows rounded to 1,024
    assert mesh.shard_rows(1000, 156) == (256, 1024)
    with pytest.raises(ValueError, match="does not split"):
        Mesh(group=None, n=3, rank=0, data=3, model=1,
             device=torch.device("cpu")).shard_rows(64, 64)


def test_wide_table_fused_and_explicit_trainers_shard_by_row(ranks):
    """DIN at dim 64 (a [1024, 64] table_d64 on the mesh) with the fused
    step and with the explicit lookup: row blocks, and fit trains."""
    rng = np.random.default_rng(5)
    B = 64
    X = {"user_id": rng.integers(1, 64, B).astype(np.int32),
         "item_id": rng.integers(1, 64, B).astype(np.int32),
         "hist_item_id": rng.integers(0, 64, (B, 4)).astype(np.int32),
         "price": rng.normal(size=(B, 1)).astype(np.float32)}
    y = rng.integers(0, 2, B).astype(np.float32)
    base = {"hidden": (16,), "att": (8, 4), "optimizer": ("adagrad", 0.05),
            "schema": dict(vocab=64, dim=64, T=4)}
    for spec, mesh_kw in (({**base, "fused": ("adagrad", 0.05)}, dict(capacity_factor=8.0)),
                          (base, dict(capacity_factor=8.0, explicit_lookup=True))):
        results = ranks.run(ranks_lib.fit_on_mesh, "din", spec, None, None, X, y, mesh_kw,
                            dict(batch_size=B, epochs=1, shuffle=False))
        assert all(r["shard_rows"]["embeddings.table_d64"] == (256, 64) for r in results)
        assert np.isfinite(results[0]["history"]["loss"][0])
        assert results[0]["view"]["embeddings.table_d64"].shape == (128, 64)


# ------------------------------------------------- checkpoints and logging

def test_mesh_checkpoint_restores_on_one_device(ranks, tmp_path):
    """A checkpoint made on the mesh has the single-device layout: one
    device restores it bitwise and continues as the mesh did; the mesh
    restores it bitwise too."""
    _, X, y = j_synthetic_criteo(n_rows=256, vocab=64, embedding_dim=8, seed=2)
    tcols = synthetic_criteo(n_rows=8, vocab=64, embedding_dim=8)[0]
    batches = [({k: v[i * 64:(i + 1) * 64] for k, v in X.items()}, y[i * 64:(i + 1) * 64])
               for i in range(4)]
    spec = {"columns": tcols, "hidden": (16,), "optimizer": ("adagrad", 0.05),
            "fused": ("adagrad", 0.05)}
    directory = str(tmp_path / "ckpt")
    results = ranks.run(ranks_lib.checkpoint_on_mesh, "deepfm", spec, None, batches,
                        directory, dict(capacity_factor=8.0, explicit_lookup=True))
    assert all(r["restored_equal"] for r in results)
    assert latest_step(directory) == 3
    single = ranks_lib.build_trainer("deepfm", spec, None)
    restore_checkpoint(directory, single)
    restored = ranks_lib.view(single)
    assert restored.keys() == results[0]["saved"].keys()
    for key, value in results[0]["saved"].items():
        np.testing.assert_array_equal(restored[key], value, err_msg=key)
    last, _ = ranks_lib.steps(single, batches[-1:])
    np.testing.assert_allclose(last, results[0]["last"], **F32)
    for key, value in results[0]["final"].items():
        np.testing.assert_allclose(ranks_lib.view(single)[key], value, err_msg=key, **F32)


def test_logging_speaks_on_rank_zero_only(ranks):
    results = ranks.run(ranks_lib.logging_on_mesh)
    assert results[0] == (True, 20, 0)  # INFO
    assert all(r[:2] == (False, 40) for r in results[1:])  # ERROR
    # with no process group (this process) every logger speaks
    assert is_host_zero() and get_logger().level == 20
    gen = seed_everything(7, device="cpu")
    assert np.random.random() == np.random.RandomState(7).random_sample()
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator().manual_seed(7)))


def test_launch_takes_torchrun_ranks(ranks, monkeypatch):
    """``make_pod_mesh`` lays the mesh over every rank; ``host_batch_slice``
    is a rank's block of a global batch; ``initialize`` outside torchrun
    raises."""
    results = ranks.run(ranks_lib.launch_on_mesh, 1024)
    assert [r[0] for r in results] == [(N_RANKS, r, N_RANKS, 1) for r in range(N_RANKS)]
    assert [r[1] for r in results] == [slice(256 * r, 256 * (r + 1)) for r in range(N_RANKS)]
    assert host_batch_slice(10, rank=1, world_size=2) == slice(5, 10)
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        initialize()


# ----------------------------------------------------------------------- CLI

def test_cli_mesh_data_under_torchrun(tmp_path):
    """The README's multi-chip command on two gloo ranks (``--device cpu``):
    one JSON line from rank 0, a checkpoint in the single-device layout
    that one device restores and that scores the held-out rows as the mesh
    did."""
    ckpt = tmp_path / "ckpt"
    argv = ["--model", "deepfm", "--mesh-data", "2", "--fused-embedding", "adagrad",
            "--explicit-lookup", "--capacity-factor", "2.0", "--dataset", "synthetic",
            "--max-rows", "1280", "--epochs", "2", "--batch-size", "128", "--device", "cpu",
            "--checkpoint-dir", str(ckpt)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", "recommender_system_tpu_torch.train",
                          *argv], cwd=ROOT, capture_output=True, text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, out.stdout
    result = json.loads(lines[0])
    assert len(result["train_loss"]) == 2 and np.isfinite(result["train_loss"]).all()
    assert latest_step(str(ckpt)) == 2 * (1024 // 128)
    config = train.parse_args(["--model", "deepfm", "--fused-embedding", "adagrad",
                               "--dataset", "synthetic", "--max-rows", "1280",
                               "--device", "cpu"])
    columns, _, _, X_test, y_test = train.build_data(config)
    single = train.build_trainer(config, columns)
    restore_checkpoint(str(ckpt), single)
    metrics = single.evaluate(X_test, y_test)
    # the CLI prints them rounded to 4 places
    assert abs(metrics["auc"] - result["auc"]) <= 5.1e-5
    assert abs(metrics["logloss"] - result["logloss"]) <= 5.1e-5


def test_cli_mesh_needs_torchrun_and_one_model_axis():
    """Outside torchrun ``--mesh-data`` raises, and with ``--mesh-model``
    the message asks for data x model ranks (the model axis itself runs
    in ``tests/test_torch_model_axis.py``)."""
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--model", "deepfm", "--dataset", "synthetic", "--max-rows", "256",
                    "--epochs", "1", "--mesh-data", "2", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="nproc-per-node 4"):
        train.main(["--model", "deepfm", "--dataset", "synthetic", "--max-rows", "256",
                    "--epochs", "1", "--mesh-data", "2", "--mesh-model", "2",
                    "--device", "cpu"])
