"""The port's model axis against the JAX package's (``tests/test_parallel.py``
on ``make_mesh(4, 2)`` there; ``make_mesh(2, 2)`` on four of its eight CPU
devices and on four gloo ranks here): the placement rule (which tables are
column-sharded, MMOE's experts on their last axis), the column-sharded
lookup and its gradient, K=2 steps of FFM (plain), MMOE (plain and fused)
and DIN (fused: row sharding forced), a JAX mesh state carried onto the
grid, a checkpoint restored on one device, ``make_pod_mesh(2)`` and
``--mesh-model 2`` under torchrun."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import optax

import torch_mesh_ranks as ranks_lib
from recommender_system_tpu.layers.embedding import packed_take as j_packed_take
from recommender_system_tpu.layers.embedding import pack_stack as j_pack_stack
from recommender_system_tpu.models import DIN as JDIN
from recommender_system_tpu.models import FFM as JFFM
from recommender_system_tpu.models import MMOE as JMMOE
from recommender_system_tpu.models import DeepFM as JDeepFM
from recommender_system_tpu.ops import dispatch as j_dispatch
from recommender_system_tpu.parallel.mesh import make_mesh as j_make_mesh
from recommender_system_tpu.parallel.mesh import wide_table_sharding as j_wide_table_sharding
from recommender_system_tpu.training import FusedAdagrad as JFusedAdagrad
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.utils import features as jfeatures
from recommender_system_tpu.utils.datasets import synthetic_criteo as j_synthetic_criteo
from recommender_system_tpu_torch import train
from recommender_system_tpu_torch.convert import load_jax_opt_state
from recommender_system_tpu_torch.parallel.mesh import Mesh, param_shardings
from recommender_system_tpu_torch.training.checkpoint import latest_step, restore_checkpoint
from recommender_system_tpu_torch.utils import features as tfeatures
from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

GRID = (2, 2)
LR = 0.05
# the mesh tests' tolerances: against the port's single device (f32 summation
# order over ranks), and against the JAX mesh Trainer's plain step
F32 = dict(rtol=1e-4, atol=1e-6)
F32_JAX_MESH = dict(rtol=1e-4, atol=1e-5)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = ranks_lib.RankPool(ranks_lib.WORLD, tmp_path_factory.mktemp("gloo"))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jgrid():
    return j_make_mesh(*GRID, devices=jax.devices()[:4])


def _run(ranks, fn, *args):
    return ranks.run(ranks_lib.on_grid, GRID, fn, *args)


# ------------------------------------------------------------- the set-ups

def _criteo(n_rows=128, vocab=32, dim=8, n_sparse=26, n_dense=13, seed=0):
    """The JAX and the port's columns and one data set (Criteo's 26 + 13
    fields by default: FFM's table_d156 at k=4)."""
    jcols, X, y = j_synthetic_criteo(n_rows=n_rows, vocab=vocab, embedding_dim=dim,
                                     n_sparse=n_sparse, n_dense=n_dense, seed=seed)
    tcols = synthetic_criteo(n_rows=8, vocab=vocab, embedding_dim=dim, n_sparse=n_sparse,
                             n_dense=n_dense, seed=seed)[0]
    return jcols, tcols, X, y


def _din_cols(mod, dim=64):
    return ranks_lib.schema("din", mod, vocab=64, dim=dim, T=4)


def _din_batch(B=64, seed=5):
    rng = np.random.default_rng(seed)
    return ({"user_id": rng.integers(1, 64, B).astype(np.int32),
             "item_id": rng.integers(1, 64, B).astype(np.int32),
             "hist_item_id": rng.integers(0, 64, (B, 4)).astype(np.int32),
             "price": rng.normal(size=(B, 1)).astype(np.float32)},
            rng.integers(0, 2, B).astype(np.float32))


def _two_tasks(X, y):
    dense = np.concatenate([X[k] for k in X if X[k].dtype.kind == "f"], axis=1)
    return np.stack([y, (dense.sum(1) > np.median(dense.sum(1))).astype(np.float32)], 1)


def _jax_kinds(state):
    """Each sharded parameter's placement in a JAX state, named as the
    port names it."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(state.params):
        spec = tuple(leaf.sharding.spec)
        name = ".".join(p.key for p in path)
        if spec == ("data", "model"):
            out[name] = "columns"
        elif spec and spec[0] == ("data", "model"):
            out[name] = "rows"
        elif spec and spec[-1] == "model":
            out[name] = "experts"
    return out


# ------------------------------------------------------------ the rule

def _rule_cases():
    """name -> (JAX model, port model, batch, step options): plain, fused
    and explicit steps of the models whose tables the rule splits."""
    jffm, tffm, X, _ = _criteo()
    jdfm, tdfm, Xd, _ = _criteo(dim=64, n_sparse=4, n_dense=2)
    jmm, tmm, Xm, _ = _criteo(dim=64, n_sparse=4, n_dense=2)
    din_X, _ = _din_batch()
    kw = dict(device="cpu", generator=torch.Generator().manual_seed(0))
    from recommender_system_tpu_torch import DIN, FFM, MMOE, DeepFM
    fused = {"fused_embedding": "adagrad"}
    explicit = {"explicit_lookup": True}
    return {
        "ffm_plain": (lambda: JFFM(tuple(jffm), factor_dim=4),
                      lambda: FFM(tffm, factor_dim=4, **kw), X, {}),
        "deepfm_d64_plain": (lambda: JDeepFM(tuple(jdfm), hidden_units=(8,)),
                             lambda: DeepFM(tdfm, hidden_units=(8,), **kw), Xd, {}),
        "din_d64_plain": (lambda: JDIN(tuple(_din_cols(jfeatures)),
                                       behavior_feature_list=("item_id",)),
                          lambda: DIN(_din_cols(tfeatures), behavior_feature_list=("item_id",),
                                      **kw), din_X, {}),
        "din_d64_fused": (lambda: JDIN(tuple(_din_cols(jfeatures)),
                                       behavior_feature_list=("item_id",)),
                          lambda: DIN(_din_cols(tfeatures), behavior_feature_list=("item_id",),
                                      **kw), din_X, fused),
        "din_d64_explicit": (lambda: JDIN(tuple(_din_cols(jfeatures)),
                                          behavior_feature_list=("item_id",)),
                             lambda: DIN(_din_cols(tfeatures),
                                         behavior_feature_list=("item_id",), **kw),
                             din_X, explicit),
        "mmoe_d64_plain": (lambda: JMMOE(feature_columns=tuple(jmm)),
                           lambda: MMOE(feature_columns=tmm, **kw), Xm, {}),
        "mmoe_d64_fused": (lambda: JMMOE(feature_columns=tuple(jmm)),
                           lambda: MMOE(feature_columns=tmm, **kw), Xm, fused),
    }


RULE_KINDS = {
    "ffm_plain": {"field_embeddings.table_d156": "columns",
                  "linear.linear_tables.table_d1": "rows"},
    # 65 lanes (an unpacked stack) do not split over 2: row-sharded, as in JAX
    "deepfm_d64_plain": {"unified.embeddings.table_d65": "rows"},
    "din_d64_plain": {"embeddings.table_d64": "columns"},
    "din_d64_fused": {"embeddings.table_d64": "rows"},
    "din_d64_explicit": {"embeddings.table_d64": "rows"},
    "mmoe_d64_plain": {"embeddings.table_d64": "columns", "mmoe.experts": "experts",
                       "mmoe.expert_bias": "experts"},
    "mmoe_d64_fused": {"embeddings.table_d64": "rows", "mmoe.experts": "experts",
                       "mmoe.expert_bias": "experts"},
}


@pytest.mark.parametrize("case", sorted(RULE_KINDS))
def test_rule_table_matches_jax(jgrid, case):
    """The tables the JAX rule column-shards on make_mesh(2, 2) are exactly
    the port's column-sharded ones; MMOE's experts split on their last axis
    under the plain and the fused step; the rest (gates among them)
    replicated; ``param_shardings`` on the unsharded model says the same.
    The port's placement needs no collective, so a Mesh of rank 0 of a
    2 x 2 grid decides it here."""
    from recommender_system_tpu_torch import FusedAdagrad, Trainer

    jmodel, tmodel, X, opts = _rule_cases()[case]
    fused = opts.get("fused_embedding")
    explicit = opts.get("explicit_lookup", False)
    jtrainer = JTrainer(jmodel(), optimizer=optax.adagrad(LR), mesh=jgrid,
                        fused_embedding=JFusedAdagrad(LR) if fused else None,
                        explicit_lookup=explicit, capacity_factor=8.0)
    jkinds = _jax_kinds(jtrainer.init({k: v[:8] for k, v in X.items()}))
    grid = Mesh(group=None, n=4, rank=0, data=2, model=2, device=torch.device("cpu"))
    trainer = Trainer(tmodel(), fused_embedding=FusedAdagrad(LR) if fused else None,
                      device="cpu", mesh=grid, explicit_lookup=explicit, capacity_factor=8.0)
    kinds = {n: p.kind for n, p in trainer.sharded.items()}
    assert kinds == jkinds == RULE_KINDS[case]
    rule = param_shardings(dict(tmodel().named_parameters()), grid,
                           column_sharding=not (fused or explicit))
    assert rule == trainer.sharded
    shapes = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
    for name, kind in kinds.items():
        whole = trainer.sharded[name].shape
        if kind == "columns":  # a row block of 'data', half the columns
            assert shapes[name][1] == -(-whole[1] // 2)
        elif kind == "experts":
            assert shapes[name] == whole[:-1] + (whole[-1] // 2,)
    if "mmoe.gates" in shapes:
        assert shapes["mmoe.gates"] == tuple(trainer.model.mmoe.gates.shape)


def test_grid_axes_are_row_major(ranks):
    """Rank d * model + m; its data axis the ranks of model index m, its
    model axis those of data index d, as make_mesh(2, 2) reshapes the JAX
    devices."""
    results = _run(ranks, ranks_lib.axes_on_mesh)
    assert results == [((4, 0, 2, 2, 0, 0), [0, 2], [0, 1]),
                       ((4, 1, 2, 2, 0, 1), [1, 3], [0, 1]),
                       ((4, 2, 2, 2, 1, 0), [0, 2], [2, 3]),
                       ((4, 3, 2, 2, 1, 1), [1, 3], [2, 3])]
    assert np.asarray(j_make_mesh(*GRID, devices=jax.devices()[:4]).devices).tolist() == \
        np.asarray(jax.devices()[:4]).reshape(GRID).tolist()


# -------------------------------------------------------- the column lookup

@pytest.mark.parametrize("V,d,per", [(832, 156, 512), (100, 64, 512), (50, 65, 256)],
                         ids=["ffm_d156", "packed_d64", "padded_d65"])
def test_column_take_matches_gather(ranks, jgrid, V, d, per):
    """Every rank's full-width rows equal the single device's gather (and,
    at dim 64, the JAX package's GSPMD gather from its P('data', 'model')
    stack), the gradient of sum(out ** 2) is the scatter-add of every
    rank's cotangents, and a width that does not split (65 over 2) is padded
    to 33 columns a rank."""
    rng = np.random.default_rng(d)
    table = rng.normal(size=(V, d)).astype(np.float32)
    ids = rng.integers(0, V, 64).astype(np.int64)
    ids[:20] = 3  # 20 ids on one row block: more than a factor of 2 takes
    expected = np.zeros_like(table)
    np.add.at(expected, ids, 2 * table[ids])
    for rows, grad, shape in _run(ranks, ranks_lib.column_take_on_mesh, table, ids):
        np.testing.assert_array_equal(rows, table[ids])
        np.testing.assert_allclose(grad, expected, rtol=1e-5, atol=1e-6)
        assert shape == (per, -(-d // 2))
    if d == 64:
        stack = j_pack_stack(jax.numpy.asarray(table), d, rows=512)
        sharded = jax.device_put(stack, j_wide_table_sharding(jgrid))
        j_dispatch.set_mesh_mode(True)
        try:
            got = jax.jit(lambda s, r: j_packed_take(s, r, d))(sharded, ids.astype(np.int32))
        finally:
            j_dispatch.set_mesh_mode(False)
        np.testing.assert_array_equal(np.asarray(got), rows)


# ------------------------------------------------------------ the Trainer

def _jax_steps(jmodel, batches, fused=False, optimizer=None):
    """K steps of the JAX Trainer on make_mesh(2, 2): its start, losses and
    end state."""
    trainer = JTrainer(jmodel, optimizer=optimizer or optax.adagrad(LR), seed=3,
                       fused_embedding=JFusedAdagrad(LR) if fused else None,
                       mesh=j_make_mesh(*GRID, devices=jax.devices()[:4]))
    state = trainer.init(batches[0][0])
    params = jax.tree_util.tree_map(np.asarray, state.params)
    step = trainer._make_train_step()
    losses = []
    for X, y in batches:
        state, out = step(state, X, y)
        losses.append(float(out["loss"] if isinstance(out, dict) else out))
    return params, np.asarray(losses), state


def _jax_view(kind, spec, state):
    trainer = ranks_lib.build_trainer(kind, spec, jax.tree_util.tree_map(np.asarray,
                                                                         state.params))
    load_jax_opt_state(trainer, state.opt_state, step=int(state.step))
    return ranks_lib.view(trainer)


def _assert_views_close(got, want, tol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


def _hold(ranks, kind, spec, params, batches, mesh_kw=None):
    """K steps on the grid against the port's single device; returns rank
    0's result after checking every rank's replicated state bitwise."""
    results = _run(ranks, ranks_lib.train_on_mesh, kind, spec, params, None, batches,
                   mesh_kw or {})
    got = results[0]
    for r in results[1:]:
        for name, value in got["replicated"].items():
            np.testing.assert_array_equal(r["replicated"][name], value, err_msg=name)
    single = ranks_lib.build_trainer(kind, spec, params)
    s_losses, _ = ranks_lib.steps(single, batches)
    np.testing.assert_allclose(got["losses"], s_losses, **F32)
    _assert_views_close(got["view"], ranks_lib.view(single), F32)
    return got, results


def test_ffm_plain_steps_on_the_grid(ranks):
    """FFM at Criteo's field count (its table_d156 column-sharded, its dim-1
    table row-sharded), K=2 plain Adagrad steps: the port's single device
    and the JAX make_mesh(2, 2) Trainer."""
    jcols, tcols, X, y = _criteo()
    batches = [({k: v[i * 64:(i + 1) * 64] for k, v in X.items()}, y[i * 64:(i + 1) * 64])
               for i in range(2)]
    params, j_losses, j_state = _jax_steps(JFFM(tuple(jcols), factor_dim=4), batches)
    spec = {"columns": tcols, "k": 4, "optimizer": ("adagrad", LR)}
    got, results = _hold(ranks, "ffm", spec, params, batches)
    assert got["placements"] == {"field_embeddings.table_d156": "columns",
                                 "linear.linear_tables.table_d1": "rows"}
    # 832 rows of one wide row each, 512-rounded to 1,024: 512 a data index
    assert all(r["shard_rows"]["field_embeddings.table_d156"] == (512, 78) for r in results)
    np.testing.assert_allclose(got["losses"], j_losses, rtol=2e-4)
    _assert_views_close(got["view"], _jax_view("ffm", spec, j_state), F32_JAX_MESH)


@pytest.mark.parametrize("variant", ["plain_dense_input", "fused_columns"])
def test_mmoe_steps_on_the_grid(ranks, variant):
    """MMOE with its 4 experts split 2 a model rank, K=2 steps: on a dense
    input with Adam (the JAX package's own EP test's set-up), and on
    feature columns with FusedAdagrad (the tables row-sharded); the port's
    single device and the JAX make_mesh(2, 2) plain Trainer (the fused
    Adagrad equals optax's Adagrad on the dense gradient)."""
    if variant == "plain_dense_input":
        rng = np.random.default_rng(4)
        X = rng.random((128, 16)).astype(np.float32)
        y = np.stack([(X.sum(1) > 8).astype(np.float32),
                      (X[:, 0] > 0.5).astype(np.float32)], 1)
        jmodel = JMMOE(num_tasks=2, num_experts=4, expert_units=16, tower_hidden_units=(8,))
        spec = {"in_features": 16, "optimizer": ("adam", 1e-2)}
        batches = [(X[i * 64:(i + 1) * 64], y[i * 64:(i + 1) * 64]) for i in range(2)]
        jopt = optax.adam(1e-2)
    else:
        jcols, tcols, X, y = _criteo(n_sparse=8, n_dense=4)
        y = _two_tasks(X, y)
        jmodel = JMMOE(feature_columns=tuple(jcols), num_tasks=2, num_experts=4,
                       expert_units=16, tower_hidden_units=(8,))
        spec = {"columns": tcols, "optimizer": ("adagrad", LR), "fused": ("adagrad", LR)}
        batches = [({k: v[i * 64:(i + 1) * 64] for k, v in X.items()},
                    y[i * 64:(i + 1) * 64]) for i in range(2)]
        jopt = optax.adagrad(LR)
    params, j_losses, j_state = _jax_steps(jmodel, batches, optimizer=jopt)
    got, results = _hold(ranks, "mmoe", spec, params, batches, dict(capacity_factor=8.0))
    assert got["placements"]["mmoe.experts"] == "experts"
    assert all(r["shard_rows"]["mmoe.experts"][-1] == 2 for r in results)
    if variant == "fused_columns":
        assert got["placements"]["embeddings.table_d8"] == "rows"
        assert got["overflow"] == [0, 0]
    np.testing.assert_allclose(got["losses"], j_losses, rtol=2e-4)
    if variant == "plain_dense_input":
        _assert_views_close(got["view"], _jax_view("mmoe", spec, j_state), F32_JAX_MESH)
    else:  # the JAX Adagrad's table accumulator is the fused slot
        want = _jax_view("mmoe", {**spec, "fused": None}, j_state)
        assert len(want) == len(got["view"])
        for name, value in want.items():
            key = name.replace("sum_of_squares:embeddings.", "slot0:embeddings.")
            np.testing.assert_allclose(got["view"][key], value, err_msg=name, **F32_JAX_MESH)


def test_din_fused_steps_force_rows_on_the_grid(ranks):
    """DIN at dim 64 with the fused step on the grid: its table_d64 stays
    row-sharded (the rule's column sharding would need the plain step) and
    K=2 steps equal the port's single device."""
    batches = [_din_batch(seed=s) for s in (5, 6)]
    spec = {"hidden": (16,), "att": (8, 4), "optimizer": ("adagrad", LR),
            "fused": ("adagrad", LR), "schema": dict(vocab=64, dim=64, T=4)}
    got, results = _hold(ranks, "din", spec, None, batches, dict(capacity_factor=8.0))
    assert got["placements"] == {"embeddings.table_d64": "rows"}
    assert all(r["shard_rows"]["embeddings.table_d64"] == (256, 64) for r in results)
    assert got["overflow"] == [0, 0]


def test_jax_grid_state_carries_onto_the_grid(ranks):
    """A JAX make_mesh(2, 2) Trainer's MMOE state after one plain step
    (column-sharded table_d64, experts split) goes into a port grid Trainer
    whose parameters are placed already, and the next step follows the JAX
    one."""
    jcols, tcols, X, y = _criteo(dim=64, n_sparse=4, n_dense=2)
    y = _two_tasks(X, y)
    batches = [({k: v[i * 64:(i + 1) * 64] for k, v in X.items()}, y[i * 64:(i + 1) * 64])
               for i in range(2)]
    jmodel = JMMOE(feature_columns=tuple(jcols), num_tasks=2, num_experts=4,
                   expert_units=16, tower_hidden_units=(8,))
    spec = {"columns": tcols, "optimizer": ("adagrad", LR)}
    _, _, one = _jax_steps(jmodel, batches[:1])
    _, j_losses, two = _jax_steps(jmodel, batches)
    params = jax.tree_util.tree_map(np.asarray, one.params)
    from test_torch_fused_mesh import _plain
    results = _run(ranks, ranks_lib.carry_jax_state_on_mesh, "mmoe", spec, params,
                   _plain(one.opt_state), int(one.step), batches[1:], {})
    got = results[0]
    np.testing.assert_allclose(got["losses"], j_losses[1:], rtol=2e-4)
    _assert_views_close(got["view"], _jax_view("mmoe", spec, two), F32_JAX_MESH)


# ----------------------------------------------- checkpoints and launch

def test_grid_checkpoint_restores_on_one_device(ranks, tmp_path):
    """A checkpoint made on the grid (a column-sharded table_d64 and the
    experts split) has the single-device layout: one device restores it
    bitwise and continues as the grid did; the grid restores it bitwise."""
    _, tcols, X, y = _criteo(dim=64, n_sparse=4, n_dense=2, seed=2)
    y = _two_tasks(X, y)
    batches = [({k: v[i * 32:(i + 1) * 32] for k, v in X.items()}, y[i * 32:(i + 1) * 32])
               for i in range(3)]
    spec = {"columns": tcols, "optimizer": ("adagrad", LR)}
    directory = str(tmp_path / "ckpt")
    results = _run(ranks, ranks_lib.checkpoint_on_mesh, "mmoe", spec, None, batches,
                   directory, {})
    assert all(r["restored_equal"] for r in results)
    assert latest_step(directory) == 2
    single = ranks_lib.build_trainer("mmoe", spec, None)
    restore_checkpoint(directory, single)
    restored = ranks_lib.view(single)
    assert restored.keys() == results[0]["saved"].keys()
    for key, value in results[0]["saved"].items():
        np.testing.assert_array_equal(restored[key], value, err_msg=key)
    assert restored["embeddings.table_d64"].shape == (4 * 32, 64)  # 4 fields of 32 ids
    assert restored["mmoe.experts"].shape[-1] == 4
    last, _ = ranks_lib.steps(single, batches[-1:])
    np.testing.assert_allclose(last, results[0]["last"], **F32)
    for key, value in results[0]["final"].items():
        np.testing.assert_allclose(ranks_lib.view(single)[key], value, err_msg=key, **F32)


def test_make_pod_mesh_forms_model_groups(ranks, monkeypatch):
    """make_pod_mesh(2): model groups of consecutive ranks, host_batch_slice
    the rows shard_batch gives each rank."""
    results = ranks.run(ranks_lib.launch_on_mesh, 1024, 2)
    assert [r[0] for r in results] == [(4, r, 2, 2) for r in range(4)]
    assert [r[1] for r in results] == [slice(256 * r, 256 * (r + 1)) for r in range(4)]
    results = _run(ranks, ranks_lib.axes_on_mesh)
    assert [r[2] for r in results] == [[0, 1], [0, 1], [2, 3], [2, 3]]


# ----------------------------------------------------------------------- CLI

def test_cli_mesh_model_under_torchrun(tmp_path):
    """``--mesh-data 2 --mesh-model 2`` under torchrun on four gloo ranks:
    MMOE at embedding dim 64 (its table_d64 column-sharded, its experts
    split); one JSON line, a checkpoint that one device restores and that
    scores the held-out rows as the grid did."""
    ckpt = tmp_path / "ckpt"
    argv = ["--model", "mmoe", "--embedding-dim", "64", "--optimizer", "adagrad",
            "--learning-rate", "0.05", "--dataset", "synthetic", "--max-rows", "640",
            "--epochs", "2", "--batch-size", "128", "--device", "cpu"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "4", "-m", "recommender_system_tpu_torch.train",
                          *argv, "--mesh-data", "2", "--mesh-model", "2",
                          "--checkpoint-dir", str(ckpt)],
                         cwd=ROOT, capture_output=True, text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, out.stdout
    result = json.loads(lines[0])
    assert len(result["train_loss"]) == 2 and np.isfinite(result["train_loss"]).all()
    assert latest_step(str(ckpt)) == 2 * (512 // 128)
    config = train.parse_args(argv)
    columns, _, _, X_test, y_test = train.build_data(config)
    single = train.build_trainer(config, columns)
    restore_checkpoint(str(ckpt), single)
    metrics = single.evaluate(X_test, y_test)
    for key in ("task0_auc", "task0_logloss", "task1_auc", "task1_logloss"):
        # the CLI prints them rounded to 4 places
        assert abs(metrics[key] - result[key]) <= 5.1e-5, key
