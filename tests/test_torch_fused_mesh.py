"""The port's exchange over row-sharded tables against the JAX package's
(``tests/test_fused_mesh.py``, on a mesh of four CPU devices there, four gloo
ranks here): ``alltoall_take``, ``sharded_fused_update`` for the three rules,
the overflow counts, and ``Trainer(mesh=...)`` fused and plain, with and
without the explicit lookup, for DeepFM, DIN, DSSM and DIEN. Each case is
held to the JAX mesh ``Trainer`` (one bf16 rounding of the cotangents where
the JAX kernels round them) and to the port's single-device step (f32
summation order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_mesh_ranks as ranks_lib
from recommender_system_tpu.models import DIN as JDIN
from recommender_system_tpu.models import DSSM as JDSSM
from recommender_system_tpu.models import DeepFM as JDeepFM
from recommender_system_tpu.parallel.fused import alltoall_take as j_alltoall_take
from recommender_system_tpu.parallel.fused import sharded_fused_update as j_sharded_update
from recommender_system_tpu.parallel.mesh import make_mesh as j_make_mesh
from recommender_system_tpu.training import FusedAdagrad as JFusedAdagrad
from recommender_system_tpu.training import FusedAdam as JFusedAdam
from recommender_system_tpu.training import FusedSGD as JFusedSGD
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.training.losses import inbatch_softmax_loss as j_inbatch
from recommender_system_tpu.utils import features as jfeatures
from recommender_system_tpu.utils.datasets import synthetic_criteo as j_synthetic_criteo
from recommender_system_tpu_torch.convert import load_jax_opt_state, unpack_stack
from recommender_system_tpu_torch.ops.fused_adagrad import (fused_adagrad_apply,
                                                            fused_adam_apply, fused_sgd_apply)
from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

N_RANKS = ranks_lib.WORLD
LR = 0.05
# f32 on both sides; the mesh sums the dense gradients, the batch moments
# and a row's cotangents over ranks in another order, over chained steps
F32 = dict(rtol=1e-4, atol=1e-6)
# the JAX fused kernels round every cotangent to bf16 before a row's sum
BF16 = dict(rtol=1e-2, atol=2e-4)
# against the JAX mesh Trainer's plain step, which sums over its devices in a
# third order: a table row whose gradient nearly cancels moves by
# lr * g / sqrt(acc), so its error is lr / sqrt(0.1) times the gradient's
F32_JAX_MESH = dict(rtol=1e-4, atol=1e-5)
# DSSM's in-batch softmax at temperature 0.05 over chained steps, against
# the JAX mesh Trainer: the tolerance of the JAX package's own test of its
# mesh DSSM against its single-device one (tests/test_fused_mesh.py)
JAX_DSSM_MESH = dict(rtol=5e-3, atol=5e-4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = ranks_lib.RankPool(N_RANKS, tmp_path_factory.mktemp("gloo"))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(data=N_RANKS, model=1)


def _block_shard(mesh, arr):
    return jax.device_put(
        arr, NamedSharding(mesh, P(mesh.axis_names) + (None,) * (arr.ndim - 1)))


def _assert_views_close(got, want, tol, skip=()):
    assert got.keys() == want.keys()
    for name in want:
        if name not in skip:
            np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


def _assert_replicated_bitwise(results):
    """Every rank holds the same replicated parameters, bit for bit."""
    first = results[0]["replicated"]
    assert first
    for r in results[1:]:
        assert r["replicated"].keys() == first.keys()
        for name, value in first.items():
            np.testing.assert_array_equal(r["replicated"][name], value, err_msg=name)


# ------------------------------------------------------------ alltoall_take

def test_alltoall_take_matches_gather(ranks, jmesh):
    rng = np.random.default_rng(0)
    R, L, N = 64, 16, 256
    stack = rng.normal(size=(R, L)).astype(np.float32)
    wids = rng.integers(0, R, N).astype(np.int32)
    results = ranks.run(ranks_lib.take_on_mesh, stack, wids, 8.0, False)
    got = np.concatenate([out for out, _, _ in results])
    np.testing.assert_array_equal(got, stack[wids])
    assert sum(ovf for _, ovf, _ in results) == 0
    want, overflow = j_alltoall_take(_block_shard(jmesh, jnp.asarray(stack)),
                                     jnp.asarray(wids), jmesh, capacity_factor=8.0)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert int(overflow) == 0


def test_alltoall_take_gradient_is_scatter_add(ranks):
    rng = np.random.default_rng(1)
    R, L, N = 32, 8, 64
    stack = rng.normal(size=(R, L)).astype(np.float32)
    wids = rng.integers(0, R, N).astype(np.int32)
    results = ranks.run(ranks_lib.take_on_mesh, stack, wids, 8.0, True)
    grad = np.concatenate([g for _, _, g in results])
    expected = np.zeros_like(stack)
    np.add.at(expected, wids, 2 * stack[wids])
    np.testing.assert_allclose(grad, expected, rtol=1e-5, atol=1e-6)


def test_alltoall_take_overflow_zeros_and_counts(ranks, jmesh):
    """Over-capacity ids read zero rows and are counted, the same entries
    and the same count as the JAX package's."""
    rng = np.random.default_rng(2)
    R, L, N = 64, 8, 64
    stack = rng.normal(size=(R, L)).astype(np.float32) + 1.0
    wids = np.full(N, 3, np.int32)  # everything on shard 0
    results = ranks.run(ranks_lib.take_on_mesh, stack, wids, 1.0, True)
    out = np.concatenate([o for o, _, _ in results])
    overflow = sum(ovf for _, ovf, _ in results)
    served = np.isclose(out, stack[wids]).all(1)
    zeroed = np.isclose(out, 0.0).all(1)
    assert np.all(served | zeroed) and served.any()
    assert overflow == int(zeroed.sum()) > 0
    want, j_overflow = j_alltoall_take(_block_shard(jmesh, jnp.asarray(stack)),
                                       jnp.asarray(wids), jmesh, capacity_factor=1.0)
    np.testing.assert_array_equal(out, np.asarray(want))
    assert overflow == int(j_overflow)
    # an overflowed id's gradient is dropped: the served ids' alone
    expected = np.zeros_like(stack)
    np.add.at(expected, wids[served], 2 * stack[wids[served]])
    np.testing.assert_allclose(np.concatenate([g for _, _, g in results]), expected,
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------- sharded_fused_update

_J_RULES = {"adagrad": JFusedAdagrad(0.05), "sgd": JFusedSGD(0.05), "adam": JFusedAdam(1e-2)}
DIM, PACK = 9, 14  # pack_factor(9)


def _single_device(rule, table, lids, ct, step):
    """The port's single-device fused rule on the whole table."""
    cfg = ranks_lib._FUSED[rule](_J_RULES[rule].learning_rate)
    t = torch.from_numpy(table.copy())
    slots = cfg.init_slots(t)
    cfg.apply(t, slots, torch.from_numpy(lids).to(torch.int64), torch.from_numpy(ct),
              step=step)
    return t.numpy(), [s.numpy() for s in slots]


def _jax_sharded(jmesh, rule, stack, lids, ct, step, capacity_factor=8.0):
    cfg = _J_RULES[rule]
    slots = cfg.init_slots(jnp.asarray(stack))
    got_stack, got_slots, overflow = j_sharded_update(
        cfg, _block_shard(jmesh, jnp.asarray(stack)),
        jax.tree.map(lambda s: _block_shard(jmesh, s), slots),
        jnp.asarray(lids), jnp.asarray(ct), jmesh, lr=float(cfg.learning_rate),
        step=jnp.int32(step), pack=PACK, dim=DIM, stream_dtype=jnp.float32,
        capacity_factor=capacity_factor)
    total = stack.shape[0] * PACK
    return (unpack_stack(np.asarray(got_stack), total, DIM),
            [unpack_stack(np.asarray(s), total, DIM) for s in jax.tree.leaves(got_slots)],
            int(overflow))


def _jax_reference(rule, stack, lids, ct, step):
    """The JAX package's f32 reference of the rule on the whole stack."""
    from recommender_system_tpu.ops.fused_adagrad import (fused_adagrad_ref, fused_adam_ref,
                                                          fused_sgd_ref)

    cfg = _J_RULES[rule]
    args = (jnp.asarray(lids), jnp.asarray(ct))
    kw = dict(pack=PACK, dim=DIM, lr=float(cfg.learning_rate))
    slots = cfg.init_slots(jnp.asarray(stack))
    if rule == "adagrad":
        out = fused_adagrad_ref(jnp.asarray(stack), slots[0], *args, eps=cfg.eps, **kw)
    elif rule == "sgd":
        out = fused_sgd_ref(jnp.asarray(stack), *args, **kw)
    else:
        out = fused_adam_ref(jnp.asarray(stack), slots[0], slots[1], *args,
                             step=jnp.int32(step), b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, **kw)
    total = stack.shape[0] * PACK
    return unpack_stack(np.asarray(out[0]), total, DIM), [
        unpack_stack(np.asarray(s), total, DIM) for s in out[1:]]


@pytest.mark.parametrize("rule", ["adagrad", "sgd", "adam"])
@pytest.mark.parametrize("R, N", [(512, 1024), (64, 160)], ids=["stack512", "stack64"])
def test_sharded_update_matches_single_device(ranks, rule, R, N):
    """sharded_fused_update == the port's single-device update (no
    overflow) == the JAX package's f32 reference of the rule on the whole
    stack (its sharded update runs the Pallas kernel on a 512-row stack,
    whose bf16 cotangents its own test allows, and that reference on a
    64-row one)."""
    rng = np.random.default_rng(3)
    stack = rng.normal(size=(R, 128)).astype(np.float32)
    table = unpack_stack(stack, R * PACK, DIM)
    lids = rng.integers(0, R * PACK, N).astype(np.int32)
    ct = rng.normal(size=(N, DIM)).astype(np.float32)
    results = ranks.run(ranks_lib.update_on_mesh, rule, _J_RULES[rule].learning_rate,
                        table, lids, ct, 1, 8.0)
    got = np.concatenate([t for t, _, _ in results])
    got_slots = [np.concatenate([s[i] for _, s, _ in results])
                 for i in range(len(results[0][1]))]
    assert sum(ovf for _, _, ovf in results) == 0
    want, want_slots = _single_device(rule, table, lids, ct, step=1)
    j_table, j_slots = _jax_reference(rule, stack, lids, ct, step=1)
    for a, b, c in zip([got] + got_slots, [want] + want_slots, [j_table] + j_slots):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)


def test_sharded_update_padded_stream_matches_ref(ranks, jmesh):
    """A global stream whose length is no multiple of the ranks is padded
    with ids no rank owns (``stream_slice``), as the JAX package pads it;
    at a starved capacity the dropped entries' count equals the JAX
    package's and the rest is the single-device update of the kept ones."""
    rng = np.random.default_rng(4)
    R, N = 64, 1021
    stack = rng.normal(size=(R, 128)).astype(np.float32)
    table = unpack_stack(stack, R * PACK, DIM)
    lids = rng.integers(0, R * PACK, N).astype(np.int32)
    ct = rng.normal(size=(N, DIM)).astype(np.float32)
    results = ranks.run(ranks_lib.update_on_mesh, "adagrad", LR, table, lids, ct, 0, 8.0)
    got = np.concatenate([t for t, _, _ in results])
    want, _ = _single_device("adagrad", table, lids, ct, step=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    starved = ranks.run(ranks_lib.update_on_mesh, "adagrad", LR, table, lids, ct, 0, 0.5)
    _, _, j_overflow = _jax_sharded(jmesh, "adagrad", stack, lids, ct, 0, capacity_factor=0.5)
    assert sum(ovf for _, _, ovf in starved) == j_overflow > 0


# ------------------------------------------------------- DeepFM on a mesh

DEEPFM_HIDDEN = (32, 16)


def _deepfm_setup(n=256, vocab=64):
    jcols, X, y = j_synthetic_criteo(n_rows=n, vocab=vocab, embedding_dim=8, seed=0)
    tcols = synthetic_criteo(n_rows=8, vocab=vocab, embedding_dim=8, seed=0)[0]
    return jcols, tcols, X, y


def _deepfm_spec(tcols, fused):
    spec = {"columns": tcols, "hidden": DEEPFM_HIDDEN, "optimizer": ("adagrad", LR)}
    if fused:
        spec["fused"] = ("adagrad", LR)
    return spec


def _jax_deepfm_run(jmesh, fused, explicit, capacity_factor, batches, jcols):
    """The JAX mesh Trainer's steps: its start, losses, overflow, end."""
    jmodel = JDeepFM(tuple(jcols), hidden_units=DEEPFM_HIDDEN)
    trainer = JTrainer(jmodel, optimizer=optax.adagrad(LR), seed=3,
                       fused_embedding=JFusedAdagrad(LR) if fused else None, mesh=jmesh,
                       capacity_factor=capacity_factor, explicit_lookup=explicit)
    state = trainer.init(batches[0][0])
    params = jax.tree_util.tree_map(np.asarray, state.params)
    step = trainer._make_train_step()
    losses, overflow = [], []
    for X, y in batches:
        state, out = step(state, X, y)
        if isinstance(out, dict):
            losses.append(float(out["loss"]))
            overflow.append(int(out["embedding_overflow"]))
        else:
            losses.append(float(out))
    return params, np.asarray(losses), overflow, state


def _jax_view(kind, spec, state):
    trainer = ranks_lib.build_trainer(kind, spec, jax.tree_util.tree_map(np.asarray,
                                                                         state.params))
    load_jax_opt_state(trainer, state.opt_state, step=int(state.step))
    return ranks_lib.view(trainer)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("explicit_lookup", [False, True],
                         ids=["gspmd_lookup", "explicit_lookup"])
def test_trainer_mesh_fused_matches_single_device(ranks, jmesh, fused, explicit_lookup):
    """Trainer(mesh=...) with the fused and with the plain step, with and
    without the explicit lookup, over 3 steps: the JAX mesh Trainer's losses
    (rtol 2e-4), tables and optimizer states, and the port's single-device
    Trainer's at f32 summation order; no overflow at a factor of 8; the
    table sharded by row and the replicated parameters bitwise equal."""
    jcols, tcols, X, y = _deepfm_setup()
    batches = [(X, y)] * 3
    params, j_losses, j_overflow, j_state = _jax_deepfm_run(
        jmesh, fused, explicit_lookup, 8.0, batches, jcols)
    spec = _deepfm_spec(tcols, fused)
    results = ranks.run(ranks_lib.train_on_mesh, "deepfm", spec, params, None, batches,
                        dict(capacity_factor=8.0, explicit_lookup=explicit_lookup))
    got = results[0]
    name = "unified.embeddings.table_d9"
    rows = 1664  # 26 fields of 64 ids
    # 512 wide rows of 14 logical rows, split over 4 ranks
    assert all(r["shard_rows"][name] == (512 * 14 // N_RANKS, 9) for r in results)
    _assert_replicated_bitwise(results)
    np.testing.assert_allclose(got["losses"], j_losses, rtol=2e-4)
    if fused:
        assert got["overflow"] == j_overflow == [0, 0, 0]
    _assert_views_close(got["view"], _jax_view("deepfm", spec, j_state),
                        BF16 if fused else F32_JAX_MESH)
    single = ranks_lib.build_trainer("deepfm", spec, params)
    s_losses, _ = ranks_lib.steps(single, batches)
    np.testing.assert_allclose(got["losses"], s_losses, **F32)
    _assert_views_close(got["view"], ranks_lib.view(single), F32)
    assert got["view"][name].shape == (rows, 9)



def _plain(node):
    """A JAX optimizer state with numpy leaves and ``OptState`` for optax's
    named tuples, which the ranks read without optax."""
    if hasattr(node, "_fields"):
        return ranks_lib.OptState(**{f: _plain(getattr(node, f)) for f in node._fields})
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_plain(v) for v in node)
    return np.asarray(node)


def test_jax_mesh_state_carries_into_a_mesh_trainer(ranks, jmesh):
    """A JAX mesh Trainer's state after 2 fused steps (global arrays) goes
    into a port mesh Trainer whose tables are sharded already (each rank
    takes its rows), and the next step follows the JAX one."""
    jcols, tcols, X, y = _deepfm_setup()
    batches = [(X, y)] * 3
    _, j_losses, _, _ = _jax_deepfm_run(jmesh, True, True, 8.0, batches, jcols)
    _, _, _, state = _jax_deepfm_run(jmesh, True, True, 8.0, batches[:2], jcols)
    spec = _deepfm_spec(tcols, True)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    got = ranks.run(ranks_lib.carry_jax_state_on_mesh, "deepfm", spec, params,
                    _plain(state.opt_state), int(state.step), batches[2:],
                    dict(capacity_factor=8.0, explicit_lookup=True))[0]
    np.testing.assert_allclose(got["losses"], j_losses[2:], rtol=2e-4)
    single = ranks_lib.build_trainer("deepfm", spec, params)
    load_jax_opt_state(single, state.opt_state, step=int(state.step))
    s_losses, _ = ranks_lib.steps(single, batches[2:])
    np.testing.assert_allclose(got["losses"], s_losses, **F32)
    _assert_views_close(got["view"], ranks_lib.view(single), F32)

def test_trainer_mesh_fused_fit_and_overflow_history(ranks, jmesh):
    """fit() on the mesh with the fused step: no overflow at a factor of 8,
    the single-device history; at a starved factor the overflow of each
    step equals the JAX package's, with and without the explicit lookup,
    and fit's history sums them."""
    jcols, tcols, X, y = _deepfm_setup()
    spec = _deepfm_spec(tcols, True)
    params = _jax_deepfm_run(jmesh, True, False, 8.0, [(X, y)], jcols)[0]
    fit_kw = dict(batch_size=64, epochs=2)
    results = ranks.run(ranks_lib.fit_on_mesh, "deepfm", spec, params, None, X, y,
                        dict(capacity_factor=8.0), fit_kw)
    hist = results[0]["history"]
    assert hist["embedding_overflow"] == [0, 0]
    single = ranks_lib.build_trainer("deepfm", spec, params).fit(X, y, **fit_kw)
    np.testing.assert_allclose(hist["loss"], single["loss"], **F32)
    assert hist["loss"][-1] < hist["loss"][0] + 1e-3

    batches = [({k: v[i * 64:(i + 1) * 64] for k, v in X.items()}, y[i * 64:(i + 1) * 64])
               for i in range(4)]
    for explicit in (False, True):
        _, _, j_overflow, _ = _jax_deepfm_run(jmesh, True, explicit, 0.05, batches, jcols)
        results = ranks.run(ranks_lib.train_on_mesh, "deepfm", spec, params, None, batches,
                            dict(capacity_factor=0.05, explicit_lookup=explicit))
        assert results[0]["overflow"] == j_overflow and min(j_overflow) > 0, explicit
    results = ranks.run(ranks_lib.fit_on_mesh, "deepfm", spec, params, None, X, y,
                        dict(capacity_factor=0.05), dict(batch_size=64, epochs=1,
                                                         shuffle=False))
    assert results[0]["history"]["embedding_overflow"] == [sum(
        _jax_deepfm_run(jmesh, True, False, 0.05, batches, jcols)[2])]


# ------------------------------------------------- DIN, DSSM, DIEN on a mesh

def _behaviour_batches(kind, n_batches=3, B=256, T=8, V=64, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        lengths = rng.integers(0, T + 1, size=B)
        hist = rng.integers(1, V, size=(B, T)).astype(np.int32)
        hist[np.arange(T)[None, :] >= lengths[:, None]] = 0
        X = {"user_id": rng.integers(1, V, size=B).astype(np.int32),
             "item_id": rng.integers(1, V, size=B).astype(np.int32),
             "hist_item_id": hist,
             "price": rng.normal(size=(B, 1)).astype(np.float32)}
        if kind == "dien":
            neg = rng.integers(1, V, size=hist.shape).astype(np.int32)
            X["neg_hist_item_id"] = np.where(hist > 0, neg, 0).astype(np.int32)
        if kind == "dssm":
            X = {k: X[k] for k in ("user_id", "hist_item_id", "item_id")}
        out.append((X, rng.integers(0, 2, size=B).astype(np.float32)))
    return out


def _hold_to_single_device(ranks, kind, spec, params=None, stats=None):
    """K=3 fused steps with the explicit lookup at a factor of 8 (which
    drops nothing: several lookup sites) against the port's single-device
    Trainer; returns rank 0's result."""
    batches = _behaviour_batches(kind)
    results = ranks.run(ranks_lib.train_on_mesh, kind, spec, params, stats, batches,
                        dict(capacity_factor=8.0, explicit_lookup=True))
    got = results[0]
    _assert_replicated_bitwise(results)
    if got["overflow"]:
        assert got["overflow"] == [0, 0, 0]
    single = ranks_lib.build_trainer(kind, spec, params, stats)
    s_losses, _ = ranks_lib.steps(single, batches)
    np.testing.assert_allclose(got["losses"], s_losses, **F32)
    _assert_views_close(got["view"], ranks_lib.view(single), F32)
    return got, batches


def test_din_mesh_fused_explicit_matches_single_device(ranks):
    """DIN, its [B] item and [B, T] history through one shared table (two
    sites, one stream a step), its BatchNorm and Dice on the global batch's
    moments: the port's single-device step, running statistics included."""
    spec = {"hidden": (16, 8), "att": (10, 5), "optimizer": ("adagrad", LR),
            "fused": ("adagrad", LR)}
    got, _ = _hold_to_single_device(ranks, "din", spec)
    assert any(k.endswith("running_var") for k in got["view"])


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_dssm_mesh_explicit_matches_single_device(ranks, fused):
    """DSSM's two towers through one collection, the in-batch softmax over
    the global batch: the port's single-device step, and with the plain
    step the JAX package's plain mesh Trainer (its fused DSSM step is
    wrong, ROADMAP)."""
    jcols = ranks_lib.schema("dssm", jfeatures)
    jmodel = JDSSM((jcols[0], jcols[2]), (jcols[1],), user_hidden_units=(16, 8),
                   item_hidden_units=(16, 8))
    batches = _behaviour_batches("dssm")
    spec = {"hidden": (16, 8), "optimizer": ("adagrad", LR)}
    if fused:
        spec["fused"] = ("adagrad", LR)

    def loss_fn(outputs, labels, b):
        return j_inbatch(*outputs, b["item_id"], temperature=0.05)

    jmesh = j_make_mesh(data=N_RANKS, model=1)
    trainer = JTrainer(jmodel, loss_fn=loss_fn, seed=3, optimizer=optax.adagrad(LR),
                       mesh=jmesh, capacity_factor=8.0, explicit_lookup=True)
    state = trainer.init(batches[0][0])
    params = jax.tree_util.tree_map(np.asarray, state.params)
    got, _ = _hold_to_single_device(ranks, "dssm", spec, params)
    if not fused:
        step = trainer._make_train_step()
        losses = []
        for X, y in batches:
            state, loss = step(state, X, y)
            losses.append(float(loss))
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-4)
        _assert_views_close(got["view"], _jax_view("dssm", spec, state), JAX_DSSM_MESH)


def test_dien_mesh_fused_explicit_matches_single_device(ranks):
    """DIEN: three sites of one table as one stream, GRU and AUGRU, the
    auxiliary loss over the global batch: the port's single-device step."""
    spec = {"hidden": (16, 8), "optimizer": ("adagrad", LR), "fused": ("adagrad", LR)}
    _hold_to_single_device(ranks, "dien", spec)
