"""The port's fused sparse SGD and lazy Adam (``ops/fused_adagrad.py``
``fused_sgd_*``, ``fused_adam_*``), their Trainer configs (``FusedSGD``,
``FusedAdam``) and the dense ``SGD`` against the JAX package's: the plain
references, the Pallas kernels in interpret mode and ``optax.sgd``. On the
CPU the wrappers run their plain versions."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from recommender_system_tpu.ops.fused_adagrad import fused_adam_apply as j_fused_adam_apply
from recommender_system_tpu.ops.fused_adagrad import fused_adam_ref as j_fused_adam_ref
from recommender_system_tpu.ops.fused_adagrad import fused_sgd_apply as j_fused_sgd_apply
from recommender_system_tpu.ops.fused_adagrad import fused_sgd_ref as j_fused_sgd_ref
from recommender_system_tpu_torch import FusedAdam, FusedSGD
from recommender_system_tpu_torch.convert import unpack_stack
from recommender_system_tpu_torch.ops.fused_adagrad import (
    adam_bias_corrections, fused_adam_apply, fused_adam_ref, fused_sgd_apply, fused_sgd_ref)
from recommender_system_tpu_torch.ops.kernels import check_sparse_rows_args
from recommender_system_tpu_torch.ops.stream_sort import sort_ids
from recommender_system_tpu_torch.training import SGD

SGD_LR, ADAM_LR = 0.05, 1e-2
# the same f32 operations in the same order on both sides; only the order of
# a row's duplicate sums (index_add_ against XLA's scatter) and XLA's pow
# may differ, by an ulp
REF_RTOL, REF_ATOL = 1e-6, 1e-7
# against the Pallas kernels: both sides sum the same bf16-rounded
# cotangents in f32, in another order (one-hot matrix products); Adam
# divides by sqrt(v), which carries a relative error of a sum to the update
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6

# (pack, dim, physical rows, N, hot row), the JAX stack lane-packed where
# pack > 1
CASES = {
    "unpacked_d128": (1, 128, 64, 300, None),
    "packed_d9": (14, 9, 128, 513, None),
    "packed_d8": (16, 8, 64, 700, None),
    "hot_row": (14, 9, 64, 1000, 5),
}


def _jax_state(pack, dim, rows_phys, seed, moments):
    """Stack and, for Adam, non-zero moments (v > 0), lane-packed as the JAX
    package keeps them."""
    rng = np.random.default_rng(seed)
    lanes = 128 if pack > 1 else dim
    stack = rng.normal(size=(rows_phys, lanes)).astype(np.float32)
    if not moments:
        return stack, np.zeros_like(stack), np.zeros_like(stack)
    m = (rng.normal(size=(rows_phys, lanes)) * 0.1).astype(np.float32)
    v = (rng.uniform(size=(rows_phys, lanes)) * 0.01).astype(np.float32)
    return stack, m, v


def _stream(rows, n, dim, seed, hot=None):
    rng = np.random.default_rng(seed)
    lids = rng.integers(0, rows, n).astype(np.int32)
    if hot is not None:
        lids[::2] = hot  # half the stream on one row
    return lids, rng.normal(size=(n, dim)).astype(np.float32)


def _unpack(a, pack, dim, rows_phys):
    return torch.from_numpy(unpack_stack(np.asarray(a), rows_phys * pack, dim).copy())


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _untouched(rows, lids):
    return np.setdiff1d(np.arange(rows), lids)


# ------------------------------------------------- plain references vs JAX

@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_sgd_ref_matches_jax(case):
    pack, dim, rows_phys, n, hot = CASES[case]
    stack, _, _ = _jax_state(pack, dim, rows_phys, seed=1, moments=False)
    rows = rows_phys * pack
    lids, ct = _stream(rows, n, dim, seed=2, hot=hot)
    (want,) = jax.jit(functools.partial(j_fused_sgd_ref, pack=pack, dim=dim, lr=SGD_LR))(
        jnp.asarray(stack), jnp.asarray(lids), jnp.asarray(ct))
    table = _unpack(stack, pack, dim, rows_phys)
    got = fused_sgd_ref(table, torch.from_numpy(lids).long(), torch.from_numpy(ct), SGD_LR)
    np.testing.assert_allclose(got.numpy(), unpack_stack(np.asarray(want), rows, dim),
                               rtol=REF_RTOL, atol=REF_ATOL)
    untouched = _untouched(rows, lids)
    np.testing.assert_array_equal(got.numpy()[untouched], table.numpy()[untouched])


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_adam_ref_matches_jax(case, step):
    pack, dim, rows_phys, n, hot = CASES[case]
    stack, m, v = _jax_state(pack, dim, rows_phys, seed=1, moments=step > 0)
    rows = rows_phys * pack
    lids, ct = _stream(rows, n, dim, seed=2, hot=hot)
    # the step goes in traced, as the Trainer passes it: a constant step
    # lets XLA fold the bias corrections with another pow
    want = jax.jit(lambda s, mm, vv, i, c, st: j_fused_adam_ref(
        s, mm, vv, i, c, pack=pack, dim=dim, lr=ADAM_LR, step=st))(
            *map(jnp.asarray, (stack, m, v, lids, ct)), jnp.int32(step))
    state = [_unpack(a, pack, dim, rows_phys) for a in (stack, m, v)]
    got = fused_adam_ref(*state, torch.from_numpy(lids).long(), torch.from_numpy(ct),
                         ADAM_LR, step)
    untouched = _untouched(rows, lids)
    for name, g, w, before in zip(("param", "m", "v"), got, want, state):
        np.testing.assert_allclose(g.numpy(), unpack_stack(np.asarray(w), rows, dim),
                                   rtol=REF_RTOL, atol=REF_ATOL, err_msg=name)
        np.testing.assert_array_equal(g.numpy()[untouched], before.numpy()[untouched])


@pytest.mark.parametrize("step", [0, 3, 99, 10_000])
def test_adam_bias_corrections_match_jax(step):
    """The reciprocal corrections, bit for bit as ``fused_adam_apply`` forms
    them."""
    t = jnp.asarray(step, jnp.float32) + 1.0
    want = [float(1.0 / (1.0 - jnp.power(jnp.float32(b), t))) for b in (0.9, 0.999)]
    assert list(adam_bias_corrections(step, 0.9, 0.999)) == want


# ------------------------------------------ wrappers vs the Pallas kernels

@functools.lru_cache(maxsize=None)
def _pallas(rule, case, step):
    """The case's inputs and the Pallas kernel's result (interpret mode)."""
    pack, dim, rows_phys, n, hot = CASES[case]
    stack, m, v = _jax_state(pack, dim, rows_phys, seed=3, moments=step > 0)
    lids, ct = _stream(rows_phys * pack, n, dim, seed=4, hot=hot)
    # the Pallas kernels round the cotangents to bf16; round both sides
    ct = _bf16(ct)
    kw = dict(pack=pack, dim=dim, tile_rows=64, chunk=128)
    if rule == "sgd":
        want = jax.jit(lambda s, i, c: j_fused_sgd_apply(s, i, c, lr=SGD_LR, **kw))(
            *map(jnp.asarray, (stack, lids, ct)))
    else:
        want = jax.jit(lambda s, mm, vv, i, c, st: j_fused_adam_apply(
            s, mm, vv, i, c, lr=ADAM_LR, step=st, **kw))(
                *map(jnp.asarray, (stack, m, v, lids, ct)), jnp.int32(step))
    return (stack, m, v), lids, ct, [np.asarray(w) for w in want]


@pytest.mark.parametrize("presort", [False, True], ids=["sorted_here", "presorted"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_sgd_apply_matches_pallas(case, presort):
    pack, dim, rows_phys, _, _ = CASES[case]
    (stack, _, _), lids, ct, (want,) = _pallas("sgd", case, 0)
    table = _unpack(stack, pack, dim, rows_phys)
    t_lids = torch.from_numpy(lids).long()
    before = fused_sgd_apply.launches
    out = fused_sgd_apply(table, t_lids, torch.from_numpy(ct), lr=SGD_LR,
                          presorted=sort_ids(t_lids) if presort else None)
    assert out is table  # in place
    assert fused_sgd_apply.launches == before  # the CPU launches nothing
    np.testing.assert_allclose(table.numpy(), unpack_stack(want, rows_phys * pack, dim),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_adam_apply_matches_pallas(case, step):
    pack, dim, rows_phys, _, _ = CASES[case]
    state, lids, ct, want = _pallas("adam", case, step)
    param, m, v = (_unpack(a, pack, dim, rows_phys) for a in state)
    t_lids = torch.from_numpy(lids).long()
    before = fused_adam_apply.launches
    out = fused_adam_apply(param, m, v, t_lids, torch.from_numpy(ct), lr=ADAM_LR, step=step,
                           presorted=sort_ids(t_lids))
    assert out[0] is param and out[1] is m and out[2] is v
    assert fused_adam_apply.launches == before
    for name, got, w in zip(("param", "m", "v"), out, want):
        np.testing.assert_allclose(got.numpy(), unpack_stack(w, rows_phys * pack, dim),
                                   rtol=KERNEL_RTOL, atol=KERNEL_ATOL, err_msg=name)


# ------------------------------------------------------------ lazy Adam

def _lazy_case():
    """Rows 0-9 of dim 9: row 2 named with all-zero cotangents, row 4 with
    cotangents that cancel exactly, row 6 non-zero in one column only, rows
    1, 3, 5 ordinary, the rest untouched; moments non-zero."""
    rng = np.random.default_rng(9)
    lids = np.array([1, 2, 3, 2, 4, 4, 5, 6, 2, 1], np.int64)
    ct = (rng.integers(-8, 9, size=(10, 9)) / 8).astype(np.float32)
    ct[lids == 2] = 0.0
    ct[4] = 0.5
    ct[5] = -0.5
    ct[7] = 0.0
    ct[7, 3] = 0.25
    param = rng.normal(size=(10, 9)).astype(np.float32)
    m = (rng.normal(size=(10, 9)) * 0.1).astype(np.float32)
    v = (rng.uniform(size=(10, 9)) * 0.01).astype(np.float32)
    return lids, ct, param, m, v


@pytest.mark.parametrize("step", [0, 3])
def test_fused_adam_is_lazy_per_row(step):
    lids, ct, *state = _lazy_case()
    want = j_fused_adam_ref(*map(jnp.asarray, (*state, lids.astype(np.int32), ct)), pack=1,
                            dim=9, lr=ADAM_LR, step=step)
    got = [torch.from_numpy(a.copy()) for a in state]
    fused_adam_apply(*got, torch.from_numpy(lids), torch.from_numpy(ct), lr=ADAM_LR, step=step)
    kept = [0, 2, 4, 7, 8, 9]  # untouched, all-zero, cancelling
    moved = [1, 3, 5, 6]
    for name, g, w, before in zip(("param", "m", "v"), got, want, state):
        np.testing.assert_array_equal(g.numpy()[kept], before[kept], err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=REF_RTOL, atol=REF_ATOL,
                                   err_msg=name)
        # a touched row moves in every column, also where its sum is zero
        assert (g.numpy()[moved] != before[moved]).all(), name


def test_fused_sgd_and_adam_take_empty_streams():
    table, m, v = torch.randn(6, 4), torch.randn(6, 4), torch.rand(6, 4)
    copies = [t.clone() for t in (table, m, v)]
    empty_ids, empty_ct = torch.zeros(0, dtype=torch.int64), torch.zeros(0, 4)
    fused_sgd_apply(table, empty_ids, empty_ct, lr=SGD_LR)
    fused_adam_apply(table, m, v, empty_ids, empty_ct, lr=ADAM_LR, step=0)
    for t, c in zip((table, m, v), copies):
        assert torch.equal(t, c)


def test_fused_sgd_sums_duplicates():
    table = torch.zeros(8, 4)
    fused_sgd_apply(table, torch.tensor([3, 3, 3]), torch.ones(3, 4), lr=0.5)
    torch.testing.assert_close(table[3], torch.full((4,), -1.5), rtol=0, atol=0)
    assert torch.equal(table[[0, 1, 2, 4, 5, 6, 7]], torch.zeros(7, 4))


# -------------------------------------------------- Trainer configs, SGD

def test_fused_configs_slots():
    table = torch.randn(5, 3)
    assert FusedSGD().init_slots(table) == ()
    assert FusedSGD().learning_rate == 0.01
    m, v = FusedAdam().init_slots(table)
    assert torch.equal(m, torch.zeros(5, 3)) and torch.equal(v, torch.zeros(5, 3))
    assert (FusedAdam().learning_rate, FusedAdam().b1, FusedAdam().b2, FusedAdam().eps) == (
        1e-3, 0.9, 0.999, 1e-8)


@pytest.mark.parametrize("config", ["sgd", "adam"])
def test_fused_configs_read_a_callable_learning_rate(config):
    """The learning rate is read at the step it is applied; Adam's bias
    corrections take the same step."""
    lids, ct = _stream(40, 60, 9, seed=5)
    lids, ct = torch.from_numpy(lids).long(), torch.from_numpy(ct)
    rates = {0: 0.03, 1: 0.02, 2: 0.01}
    seen = []
    cfg = (FusedSGD(lambda s: seen.append(s) or rates[s]) if config == "sgd"
           else FusedAdam(lambda s: seen.append(s) or rates[s]))
    table = torch.randn(40, 9, generator=torch.Generator().manual_seed(0))
    want, want_slots = table.clone(), cfg.init_slots(table)
    slots = cfg.init_slots(table)
    for step in range(3):
        cfg.apply(table, slots, lids, ct, step=step)
        if config == "sgd":
            fused_sgd_apply(want, lids, ct, lr=rates[step])
        else:
            fused_adam_apply(want, *want_slots, lids, ct, lr=rates[step], step=step)
    assert seen == [0, 1, 2]
    assert torch.equal(table, want)
    for s, w in zip(slots, want_slots):
        assert torch.equal(s, w)


@pytest.mark.parametrize("schedule", [False, True], ids=["constant", "schedule"])
def test_sgd_matches_optax(schedule):
    rng = np.random.default_rng(6)
    params = {"a": rng.normal(size=(7, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    lr = optax.linear_schedule(0.1, 0.01, 3) if schedule else 0.1
    tx = optax.sgd(lr)
    jp, state = dict(params), tx.init(params)
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
    port = SGD((lambda s: float(lr(s))) if schedule else lr)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = port.init(tp)
    assert tstate == {"a": {}, "b": {}}
    for step, g in enumerate(grads):
        port.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate, step)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------- the wrappers

def test_sparse_row_kernels_take_adams_three_tables():
    ids = torch.arange(4)
    ct = torch.zeros(4, 9)
    check_sparse_rows_args(ids, ids, ct, *(torch.zeros(10, 9) for _ in range(3)))
    with pytest.raises(ValueError, match="differ"):
        check_sparse_rows_args(ids, ids, ct, torch.zeros(10, 9), torch.zeros(10, 9),
                               torch.zeros(12, 9))


def test_wrappers_neither_launch_nor_fall_back_off_the_cpu():
    ids = torch.empty(4, dtype=torch.int64, device="meta")
    ct = torch.empty(4, 9, device="meta")
    table = torch.empty(10, 9, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_sgd_apply(table, ids, ct, lr=SGD_LR)
    with pytest.raises(ValueError, match="no kernel"):
        fused_adam_apply(table, table, table, ids, ct, lr=ADAM_LR, step=0)
    with pytest.raises(ValueError, match="different devices"):
        fused_adam_apply(torch.zeros(10, 9), table, table, ids, ct, lr=ADAM_LR, step=0)
