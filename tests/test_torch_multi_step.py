"""``Trainer.make_multi_step`` and ``make_multi_step_packed`` against the JAX
package's, and the step scalars that let a call of K steps be one CUDA graph
on the card.

On the CPU the K-step callable is the steps one by one, the plain version of
a graph replay: it is held to the JAX package's ``lax.scan`` on weights
carried across (``convert.load_jax_params``), K=3, for DeepFM fused and
plain, NFM with ``Adam`` + ``FusedAdam``, a callable learning rate, and the
packed call on ``_pack_group``'s arrays. The dense optimizers and the fused
rules read each step's scalars from a float32 tensor, as a graph does; both
forms are bitwise equal to the host-float code they replace over steps 0-4.
The capture, its replays and their launch counts run on the card
(``chip_smoke.py``, phase 3q)."""
import numpy as np
import pytest
import torch

import jax
import optax

import torch_mesh_ranks as ranks_lib
from recommender_system_tpu import models as jmodels
from recommender_system_tpu.training import FusedAdam as JFusedAdam
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.utils.datasets import synthetic_criteo as j_synthetic_criteo
from recommender_system_tpu_torch import NFM, DeepFM, FusedAdagrad, FusedAdam, FusedSGD, Trainer
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params
from recommender_system_tpu_torch.ops import kernels
from recommender_system_tpu_torch.ops.dispatch import add_launches, launch_counts
from recommender_system_tpu_torch.ops.fused_adagrad import (
    adam_bias_corrections, adam_scalars, fused_adagrad_apply, fused_adagrad_ref,
    fused_adam_apply, fused_adam_ref, fused_sgd_apply, fused_sgd_ref)
from recommender_system_tpu_torch.training import SGD, Adagrad, Adam
from recommender_system_tpu_torch.training.harness import _issuing_line, _signature
from recommender_system_tpu_torch.training.optim import DecayedWeights
from recommender_system_tpu_torch.utils.datasets import synthetic_criteo
from tests import test_torch_ctr_training as ctr_tests

K, B, HIDDEN = 3, 128, (16,)
LR, ADAM_LR = 0.05, 1e-2
# factor dim 8 (DeepFM), and 72 for NFM: a table 72 lanes wide is not a
# multiple of 128, so the JAX package's fused Adam runs its f32 reference
DATA = {8: dict(n_dense=4, n_sparse=6, vocab=50, embedding_dim=8),
        72: dict(n_dense=4, n_sparse=6, vocab=50, embedding_dim=72)}
# test_torch_deepfm_training.py::test_training_matches_jax's tolerances: f32
# on both sides, GEMMs and reductions summed in another order over K steps
F32_RTOL, F32_ATOL = 1e-4, 1e-6


def _schedule(step):
    return 0.1 - 0.02 * step


def _gen():
    return torch.Generator().manual_seed(0)


def _batches(dim, seed=1):
    """K batches from numpy seeds: JAX columns, port columns, X [K], y [K]."""
    jcols, X, y = j_synthetic_criteo(n_rows=K * B, seed=seed, **DATA[dim])
    tcols = synthetic_criteo(n_rows=8, seed=seed, **DATA[dim])[0]
    Xs = [{c: v[i * B:(i + 1) * B] for c, v in X.items()} for i in range(K)]
    return jcols, tcols, Xs, [y[i * B:(i + 1) * B] for i in range(K)]


# case -> (model, dim, JAX dense optimizer, JAX fused config, port dense
# optimizer, port fused config); each JAX run is the reference of its case
CASES = {
    "deepfm_fused": ("deepfm", 8, lambda: optax.adagrad(LR), None,
                     lambda: Adagrad(LR), lambda: FusedAdagrad(LR)),
    "deepfm_plain": ("deepfm", 8, lambda: optax.adagrad(LR), None,
                     lambda: Adagrad(LR), None),
    "nfm_adam_fused_adam": ("nfm", 72, lambda: optax.adam(ADAM_LR), lambda: JFusedAdam(ADAM_LR),
                            lambda: Adam(ADAM_LR), lambda: FusedAdam(ADAM_LR)),
    "deepfm_fused_schedule": ("deepfm", 8, lambda: optax.adagrad(_schedule), None,
                              lambda: Adagrad(_schedule), lambda: FusedAdagrad(_schedule)),
}
MODELS = {
    "deepfm": (lambda c: jmodels.DeepFM(tuple(c), hidden_units=HIDDEN),
               lambda c: DeepFM(c, hidden_units=HIDDEN, device="cpu", generator=_gen())),
    "nfm": (lambda c: jmodels.NFM(tuple(c), hidden_units=HIDDEN),
            lambda c: NFM(c, hidden_units=HIDDEN, device="cpu", generator=_gen())),
}


def _jax_start(case):
    """The JAX Trainer of ``case`` and its state, every table redrawn at std
    0.1 so that the embeddings have their say; the batches. NFM starts where
    ``test_torch_ctr_training.py``'s NFM parity case starts (its tables and
    BatchNorm statistics, its first K batches): from other draws, Adam
    normalises a row gradient of ~1e-6 left by cancelling contributions,
    which the two packages sum in another order, to a step of order lr, and
    one table element in 21,600 ended 4.6e-6 (relative 2.4e-4) from the
    JAX package's."""
    name, dim, make_opt, make_fused = CASES[case][:4]
    if name == "nfm":
        jcols, tcols, Xs, ys = ctr_tests._batches(dim)
        params, stats = ctr_tests._jax_init(name, dim)
        Xs, ys = Xs[:K], ys[:K]
    else:
        jcols, tcols, Xs, ys = _batches(dim)
    trainer = JTrainer(MODELS[name][0](jcols), optimizer=make_opt(), seed=0,
                       fused_embedding=make_fused() if make_fused else None)
    state = trainer.init(Xs[0])
    if name == "nfm":
        return trainer, state.replace(params=params, batch_stats=stats), tcols, Xs, ys
    rng = np.random.default_rng(3)

    def redraw(tree):
        return {k: redraw(v) if hasattr(v, "items") else
                (rng.normal(0.0, 0.1, v.shape).astype(np.float32) if k.startswith("table_d")
                 else np.asarray(v)) for k, v in tree.items()}

    state = state.replace(params=redraw(state.params))
    return trainer, state, tcols, Xs, ys


def _port_trainer(case, tcols, state, fused):
    name, _, _, _, make_opt, make_fused = CASES[case]
    stats = jax.tree_util.tree_map(np.asarray, dict(state.batch_stats)) or None
    model = load_jax_params(MODELS[name][1](tcols), state.params, stats)
    return Trainer(model, make_opt(), fused_embedding=make_fused() if fused else None,
                   device="cpu")


def _view(trainer):
    """Parameters, BatchNorm statistics and optimizer state by name; a
    table's fused slots under the names its dense optimizer gives them."""
    out = {n: t.detach().numpy().copy() for n, t in trainer.model.state_dict().items()}
    for n, slots in trainer.opt_state.items():
        out.update({f"{k}:{n}": v.numpy().copy() for k, v in slots.items()})
    names = {FusedAdagrad: ("sum_of_squares",), FusedAdam: ("mu", "nu"), FusedSGD: ()}
    for n, slots in trainer.fused_slots.items():
        for key, s in zip(names[type(trainer.fused_embedding)], slots):
            out[f"{key}:{n}"] = s.numpy().copy()
    return out


def _jax_view(case, tcols, state):
    trainer = _port_trainer(case, tcols, state, fused=CASES[case][3] is not None)
    return _view(load_jax_opt_state(trainer, state.opt_state, step=int(state.step)))


def _stacked(Xs, ys):
    return ({k: torch.from_numpy(np.stack([X[k] for X in Xs])) for k in Xs[0]},
            torch.from_numpy(np.stack(ys)))


def _assert_views_close(got, want):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_multi_step_matches_jax(case):
    jtrainer, state, tcols, Xs, ys = _jax_start(case)
    trainer = _port_trainer(case, tcols, state, fused=CASES[case][5] is not None)
    jbatches = {k: np.stack([X[k] for X in Xs]) for k in Xs[0]}
    state, want_losses = jtrainer.make_multi_step()(state, jbatches, np.stack(ys))
    got_losses = trainer.make_multi_step()(*_stacked(Xs, ys))
    assert got_losses.shape == (K,) and trainer.step == int(state.step) == K
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses), rtol=F32_RTOL,
                               atol=F32_ATOL)
    _assert_views_close(_view(trainer), _jax_view(case, tcols, state))


def test_make_multi_step_packed_matches_jax():
    """The port's packed call on the JAX ``_pack_group``'s arrays (equal to
    the port's own) against the JAX packed scan, and equal bitwise to the
    port's unpacked call on the same batches."""
    case = "deepfm_fused"
    jtrainer, state, tcols, Xs, ys = _jax_start(case)
    group = list(zip(Xs, ys))
    jspec = JTrainer._pack_spec(Xs[0])
    packed, labels = JTrainer._pack_group(jspec, group)
    trainer = _port_trainer(case, tcols, state, fused=True)
    spec = Trainer._pack_spec(Xs[0])
    own, own_labels = trainer._pack_group(spec, group)
    assert own.keys() == packed.keys() == {"i", "f"}
    for kind in packed:
        np.testing.assert_array_equal(own[kind].numpy(), packed[kind])
    np.testing.assert_array_equal(own_labels.numpy(), labels)
    state, want_losses = jtrainer.make_multi_step_packed(jspec)(state, packed, labels)
    got = trainer.make_multi_step_packed(spec)(
        {k: torch.from_numpy(v) for k, v in packed.items()},
        torch.from_numpy(labels.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_losses), rtol=F32_RTOL,
                               atol=F32_ATOL)
    _assert_views_close(_view(trainer), _jax_view(case, tcols, state))
    unpacked = _port_trainer(case, tcols, _jax_start(case)[1], fused=True)
    assert torch.equal(unpacked.make_multi_step()(*_stacked(Xs, ys)), got)
    for name, value in _view(unpacked).items():
        np.testing.assert_array_equal(_view(trainer)[name], value, err_msg=name)


# ---------------------------------------------- step scalars on the device

def _former_update(kind, opt, params, grads, state, step):
    """The dense optimizers' update as it read its scalars from host floats
    before they moved to device memory (the code it replaces)."""
    lr = opt.learning_rate(step) if callable(opt.learning_rate) else opt.learning_rate
    for name, p in params.items():
        g = grads[name]
        if kind == "sgd":
            p.add_(g * -lr)
        elif kind == "adagrad":
            acc = state[name]["sum_of_squares"]
            acc.add_(g * g)
            inv = torch.where(acc > 0, torch.rsqrt(acc + opt.eps), 0.0)
            p.add_((inv * g) * -lr)
        else:
            count = np.float32(step + 1)
            bc1 = float(np.float32(1) - np.float32(opt.b1) ** count)
            bc2 = float(np.float32(1) - np.float32(opt.b2) ** count)
            mu, nu = state[name]["mu"], state[name]["nu"]
            mu.copy_((1 - opt.b1) * g + opt.b1 * mu)
            nu.copy_((1 - opt.b2) * (g * g) + opt.b2 * nu)
            p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps) * -lr)


DENSE = {"sgd": lambda: SGD(_schedule), "adagrad": lambda: Adagrad(_schedule),
         "adam": lambda: Adam(_schedule), "adam_constant": lambda: Adam(ADAM_LR)}


@pytest.mark.parametrize("kind", sorted(DENSE))
@pytest.mark.parametrize("decay", [0.0, 0.01], ids=["plain", "decayed"])
def test_dense_optimizers_read_device_scalars_bitwise(kind, decay):
    """``update`` with the step's scalars as a float32 tensor, and with them
    from ``scalars(step)`` on the host, equal the former host-float code
    bitwise over steps 0-4 (``DecayedWeights`` passes them through)."""
    rng = np.random.default_rng(5)
    start = {"w": rng.normal(size=(7, 5)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
    opt = DENSE[kind]()
    if decay:
        opt = DecayedWeights(opt, decay)
    inner = opt.optimizer if decay else opt
    runs = []
    for _ in range(3):
        params = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
        runs.append((params, opt.init(params)))
    for step in range(5):
        grads = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
                 for k, v in start.items()}
        (former, fstate), (host, hstate), (device, dstate) = runs
        former_grads = ({n: g + decay * former[n] for n, g in grads.items()} if decay
                        else grads)
        _former_update(kind.split("_")[0], inner, former, former_grads, fstate, step)
        opt.update(host, grads, hstate, step)
        table = torch.tensor(opt.scalars(step), dtype=torch.float32)
        opt.update(device, grads, dstate, step, scalars=table)
        for name in start:
            assert torch.equal(host[name], former[name]), (step, name)
            assert torch.equal(device[name], former[name]), (step, name)
        for name, slots in fstate.items():
            for key, value in slots.items():
                assert torch.equal(hstate[name][key], value)
                assert torch.equal(dstate[name][key], value)


def test_dense_scalars_are_the_step_values():
    adam = Adam(_schedule)
    lr, bc1, bc2 = adam.scalars(2)
    assert lr == _schedule(2)
    assert bc1 == float(np.float32(1) - np.float32(0.9) ** np.float32(3))
    assert bc2 == float(np.float32(1) - np.float32(0.999) ** np.float32(3))
    assert SGD(0.3).scalars(7) == Adagrad(0.3).scalars(7) == (0.3,)
    assert DecayedWeights(adam, 0.1).scalars(2) == adam.scalars(2)


def _former_fused(rule, table, slots, lids, ct, lr, step):
    """The fused rules' plain versions with host-float scalars, as they were
    before the scalars moved to device memory."""
    g = torch.zeros_like(table).index_add_(0, lids, ct)
    if rule == "sgd":
        return (table - lr * g,)
    if rule == "adagrad":
        new_acc = slots[0] + g * g
        inv = torch.where(new_acc > 0, torch.rsqrt(new_acc + 1e-7), 0.0)
        return table - lr * g * inv, new_acc
    m, v = slots
    touched = (g != 0).any(dim=1, keepdim=True)
    bc1, bc2 = adam_bias_corrections(step, 0.9, 0.999)
    m_new = 0.9 * m + (1 - 0.9) * g
    v_new = 0.999 * v + (1 - 0.999) * g * g
    update = lr * (m_new * bc1) / (torch.sqrt(v_new * bc2) + 1e-8)
    return (torch.where(touched, table - update, table), torch.where(touched, m_new, m),
            torch.where(touched, v_new, v))


FUSED = {"adagrad": FusedAdagrad, "sgd": FusedSGD, "adam": FusedAdam}


@pytest.mark.parametrize("rule", sorted(FUSED))
def test_fused_rules_read_device_scalars_bitwise(rule):
    """Over steps 0-4 of a schedule, on streams with duplicate ids: the
    plain version and the CPU wrapper given the scalars tensor, the wrapper
    given host numbers, and the fused config at ``step`` and at the
    Trainer's scalars all equal the former host-float plain version
    bitwise."""
    rng = np.random.default_rng(7)
    start = rng.normal(0.0, 0.1, (40, 6)).astype(np.float32)
    cfg = FUSED[rule](_schedule)
    forms = ("former", "ref", "apply_tensor", "apply_host", "config_step", "config_tensor")
    states = {f: [torch.from_numpy(start.copy()),
                  *cfg.init_slots(torch.from_numpy(start))] for f in forms}
    for step in range(5):
        lids = torch.from_numpy(rng.integers(0, 40, 60)).long()
        ct = torch.from_numpy(rng.normal(size=(60, 6)).astype(np.float32))
        ct[:5] = 0.0  # rows whose summed gradient may be zero (lazy Adam)
        lr = _schedule(step)
        scalars = torch.tensor(cfg.scalars(step), dtype=torch.float32)
        host = dict(lr=lr, **({"step": step} if rule == "adam" else {}))
        ref = {"adagrad": lambda t, s: fused_adagrad_ref(t, s[0], lids, ct, scalars=scalars),
               "sgd": lambda t, s: (fused_sgd_ref(t, lids, ct, scalars=scalars),),
               "adam": lambda t, s: fused_adam_ref(t, *s, lids, ct, scalars=scalars)}[rule]
        apply = {"adagrad": lambda t, s, **kw: fused_adagrad_apply(t, s[0], lids, ct, **kw),
                 "sgd": lambda t, s, **kw: fused_sgd_apply(t, lids, ct, **kw),
                 "adam": lambda t, s, **kw: fused_adam_apply(t, *s, lids, ct, **kw)}[rule]
        for form, tensors in states.items():
            table, slots = tensors[0], tensors[1:]
            if form in ("former", "ref"):
                new = (_former_fused(rule, table, slots, lids, ct, lr, step) if form == "former"
                       else ref(table, slots))
                for t, value in zip(tensors, new):
                    t.copy_(value)
            elif form.startswith("apply"):
                apply(table, slots, **(host if form == "apply_host" else {"scalars": scalars}))
            else:
                cfg.apply(table, tuple(slots), lids, ct, step=step,
                          **({"scalars": scalars} if form == "config_tensor" else {}))
        for form in forms[1:]:
            for got, want in zip(states[form], states["former"]):
                assert torch.equal(got, want), (rule, step, form)
    assert not torch.equal(states["former"][0], torch.from_numpy(start))


def test_adam_scalars_are_lr_and_the_reciprocal_corrections():
    assert adam_scalars(0.5, 3, 0.9, 0.999) == (0.5, *adam_bias_corrections(3, 0.9, 0.999))
    assert FusedAdam(_schedule).scalars(3) == adam_scalars(_schedule(3), 3, 0.9, 0.999)
    assert FusedAdagrad(0.2).scalars(9) == FusedSGD(0.2).scalars(9) == (0.2,)


def test_fused_wrappers_need_the_step_scalars():
    table, acc = torch.zeros(4, 3), torch.ones(4, 3)
    ids, ct = torch.tensor([1, 2]), torch.ones(2, 3)
    with pytest.raises(TypeError, match="scalars"):
        fused_adagrad_apply(table, acc, ids, ct)
    with pytest.raises(TypeError, match="scalars"):
        fused_adam_apply(table, acc, acc.clone(), ids, ct, lr=0.1)
    with pytest.raises(ValueError, match="float32 tensor of 3"):
        kernels.check_hyper(torch.zeros(1), table, 3)
    with pytest.raises(ValueError, match="float32 tensor of 1"):
        kernels.check_hyper(torch.zeros(1, dtype=torch.float64), table, 1)


# ------------------------------------------------ the Trainer's K-step call

def _small_trainer(fused=True, optimizer=None):
    _, tcols, _, _ = _batches(8)
    model = DeepFM(tcols, hidden_units=HIDDEN, device="cpu", generator=_gen())
    return Trainer(model, optimizer or Adam(ADAM_LR),
                   fused_embedding=FusedAdam(ADAM_LR) if fused else None, device="cpu")


def test_scalars_table_holds_each_step_dense_then_fused():
    trainer = _small_trainer()
    trainer.step = 4
    table = trainer._stage_scalars(3)
    assert table.dtype == torch.float32 and table.shape == (3, 6)
    want = [Adam(ADAM_LR).scalars(s) + FusedAdam(ADAM_LR).scalars(s) for s in (4, 5, 6)]
    assert torch.equal(table, torch.tensor(want, dtype=torch.float32))
    assert trainer._n_dense == 3


def test_on_the_cpu_the_call_is_the_loop():
    """On the CPU ``make_multi_step()`` records no signature and equals the
    loop (``graphed=False``), ``multi_step`` and K ``train_step`` calls
    bitwise; on a card without a mesh the Trainer captures."""
    _, _, Xs, ys = _batches(8)
    runs = {}
    for form in ("callable", "loop", "multi_step", "train_step"):
        trainer = _small_trainer()
        if form == "train_step":
            losses = torch.stack([trainer.train_step({k: torch.from_numpy(v)
                                                      for k, v in X.items()},
                                                     torch.from_numpy(y))
                                  for X, y in zip(Xs, ys)])
        elif form == "multi_step":
            losses = trainer.multi_step(*_stacked(Xs, ys))
        else:
            losses = trainer.make_multi_step(graphed=form == "callable")(*_stacked(Xs, ys))
        assert not trainer._graphs and not trainer._warmed and trainer.step == K
        runs[form] = (losses, _view(trainer))
        assert not trainer.captures
        trainer.device = torch.device("cuda")
        assert trainer.captures
    for form, (losses, view) in runs.items():
        assert torch.equal(losses, runs["loop"][0]), form
        for name, value in view.items():
            np.testing.assert_array_equal(value, runs["loop"][1][name], err_msg=form)


def test_init_and_drop_graphs_empty_the_cache():
    trainer = _small_trainer()
    _, _, Xs, ys = _batches(8)
    trainer.multi_step(*_stacked(Xs, ys))
    spec = Trainer._pack_spec(Xs[0])
    call = trainer._packed_call(spec)
    assert trainer._packed_call(spec) is call and trainer._multi is not None
    for empty in (trainer.init, trainer.drop_graphs):
        trainer._graphs[("signature",)] = object()
        trainer._warmed.add(("signature",))
        trainer._pool = object()
        empty()
        assert trainer._graphs == {} and trainer._warmed == set()
        assert trainer._pool is None and trainer._multi is None
        assert trainer._packed_multi == {}
    assert trainer.step == 0


def test_signature_is_each_leaf_name_shape_and_dtype():
    batch = {"a": torch.zeros(3, 4, dtype=torch.int32), "b": torch.zeros(3, 4, 2)}
    labels = torch.zeros(3, 4)
    sig = _signature(batch, labels)
    assert sig == (("a", (3, 4), torch.int32), ("b", (3, 4, 2), torch.float32),
                   (None, (3, 4), torch.float32))
    assert _signature({**batch, "a": torch.zeros(2, 4, dtype=torch.int32)}, labels) != sig


def test_fit_trains_a_short_last_group_step_by_step(monkeypatch):
    """Full groups go through ``multi_step``; the short last one through
    ``train_step``, as the JAX package's ``fit`` does."""
    _, tcols, Xs, ys = _batches(8)
    X = {k: np.concatenate([x[k] for x in Xs]) for k in Xs[0]}
    y = np.concatenate(ys)
    trainer = _small_trainer()
    calls = []
    multi, single = trainer.multi_step, trainer.train_step
    monkeypatch.setattr(trainer, "multi_step",
                        lambda b, lb: calls.append(("multi", lb.shape[0])) or multi(b, lb))
    monkeypatch.setattr(trainer, "train_step",
                        lambda b, lb: calls.append(("single", 1)) or single(b, lb))
    trainer.fit(X, y, batch_size=64, steps_per_call=4, shuffle=False)  # 6 batches
    assert calls == [("multi", 4), ("single", 1), ("single", 1)]
    assert trainer.step == 6


def test_launch_counts_read_and_raise_every_counter():
    counts = launch_counts()
    assert set(counts) == {
        "cross_fused.launches", "cross_fused.global_launches", "fm_fused.launches",
        "fm_fused.global_launches", "din_attention_fused.launches",
        "din_attention_fused.global_launches", "din_attention_backward.launches",
        "din_attention_backward.global_launches", "din_attention_backward.wide_launches",
        "fused_adagrad_apply.launches",
        "fused_adagrad_apply.long_launches", "fused_sgd_apply.launches",
        "fused_sgd_apply.long_launches", "fused_adam_apply.launches",
        "fused_adam_apply.long_launches", "scatter_add_sorted.launches",
        "scatter_add_sorted.long_launches"}
    add_launches({"fused_adam_apply.launches": 8, "cross_fused.global_launches": 2,
                  "din_attention_backward.wide_launches": 3})
    after = launch_counts()
    assert after["fused_adam_apply.launches"] == counts["fused_adam_apply.launches"] + 8
    assert after["cross_fused.global_launches"] == counts["cross_fused.global_launches"] + 2
    assert (after["din_attention_backward.wide_launches"]
            == counts["din_attention_backward.wide_launches"] + 3)
    add_launches({"fused_adam_apply.launches": -8, "cross_fused.global_launches": -2,
                  "din_attention_backward.wide_launches": -3})
    assert launch_counts() == counts


def test_a_failed_capture_names_the_line_that_issued_the_op():
    try:
        try:
            kernels.check_hyper(torch.zeros(2), torch.zeros(1), 1)
        except ValueError:
            raise RuntimeError("capture invalidated")
    except RuntimeError as err:
        where = _issuing_line(err)
    assert "ops/kernels.py" in where and "raise ValueError" in where
    assert "float32 tensor of 1" in where


# ------------------------------------------------------------------ mesh

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = ranks_lib.RankPool(ranks_lib.WORLD, tmp_path_factory.mktemp("gloo"))
    yield pool
    pool.close()


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_under_a_mesh_the_call_is_the_loop(ranks, fused):
    """On four gloo ranks ``make_multi_step()`` is the loop of steps: it
    equals ``make_multi_step(graphed=False)`` bitwise, records no signature
    for a graph, and a mesh Trainer would not capture on a card either; its
    losses and state are the single device's."""
    case = "deepfm_fused"
    _, state, tcols, Xs, ys = _jax_start(case)
    spec = {"columns": tcols, "hidden": HIDDEN, "optimizer": ("adagrad", LR),
            **({"fused": ("adagrad", LR)} if fused else {})}
    params = jax.tree_util.tree_map(np.asarray, dict(state.params))
    batches = {k: np.stack([X[k] for X in Xs]) for k in Xs[0]}
    labels = np.stack(ys)
    # the fused update's exchange at full capacity: nothing dropped
    runs = ranks.run(ranks_lib.multi_step_on_mesh, "deepfm", spec, params, batches, labels,
                     {"capacity_factor": None})[0]
    (losses, view, recorded, captures), (loop_losses, loop_view, _, _) = runs[True], runs[False]
    assert recorded == 0 and not captures
    np.testing.assert_array_equal(losses, loop_losses)
    for name, value in loop_view.items():
        np.testing.assert_array_equal(view[name], value, err_msg=name)
    single = ranks_lib.build_trainer("deepfm", spec, params)
    want = single.make_multi_step()(*_stacked(Xs, ys))
    np.testing.assert_allclose(losses, want.numpy(), rtol=F32_RTOL, atol=F32_ATOL)
    for name, value in ranks_lib.view(single).items():
        np.testing.assert_allclose(view[name], value, rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=name)
