"""The port's Criteo CTR models (WideDeep, NFM, FM, FNN, and DCN trained)
against the JAX package's: forward on transplanted weights, fused Trainer
steps with ``SGD``/``FusedSGD``, ``Adam``/``FusedAdam`` and
``Adagrad``/``FusedAdagrad``, ``init_from_fm``, carrying a JAX run's
optimizer state across mid-run, and ``CTR_MODELS``."""
import functools

import numpy as np
import pytest
import torch

import jax
import optax

from recommender_system_tpu import models as jmodels
from recommender_system_tpu.layers.embedding import unpack_stack as j_unpack_stack
from recommender_system_tpu.training import FusedAdagrad as JFusedAdagrad
from recommender_system_tpu.training import FusedAdam as JFusedAdam
from recommender_system_tpu.training import FusedSGD as JFusedSGD
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.utils.datasets import synthetic_criteo as j_synthetic_criteo
import recommender_system_tpu_torch as port
from recommender_system_tpu_torch import (CTR_MODELS, DCN, FM, FNN, NFM, FusedAdagrad,
                                          FusedAdam, FusedSGD, Trainer, WideDeep,
                                          init_from_fm)
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params
from recommender_system_tpu_torch.training import SGD, Adagrad, Adam
from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

B, K, HIDDEN = 128, 4, (16,)
# factor dim 8 (lane-packed in the JAX package, whose fused kernels then
# run), and 72: a table 72 lanes wide is not a multiple of 128, so the JAX
# package's fused optimizers run their f32 XLA references there
DATA = {8: dict(n_dense=4, n_sparse=6, vocab=50, embedding_dim=8),
        72: dict(n_dense=4, n_sparse=6, vocab=50, embedding_dim=72)}
SGD_LR, ADAM_LR, ADAGRAD_LR = 0.05, 1e-2, 0.05
# f32 on both sides; GEMMs and the reductions over the batch and over a
# row's duplicate ids are summed in another order, over K chained steps
F32_RTOL, F32_ATOL = 1e-4, 1e-6
# the JAX package's fused kernels round every cotangent to bf16 (2**-9
# relative) before they sum a row's gradient; the port keeps them f32
BF16_RTOL, BF16_ATOL = 1e-2, 2e-4


def _gen():
    return torch.Generator().manual_seed(0)


def _batches(dim, seed=1, k=K, n=B):
    """K batches from numpy seeds: JAX columns, port columns, X [K] and y."""
    jcols, X, y = j_synthetic_criteo(n_rows=k * n, seed=seed, **DATA[dim])
    tcols = synthetic_criteo(n_rows=8, seed=seed, **DATA[dim])[0]
    Xs = [{c: v[i * n:(i + 1) * n] for c, v in X.items()} for i in range(k)]
    return jcols, tcols, Xs, [y[i * n:(i + 1) * n] for i in range(k)]


# name -> (JAX model, port model), each from its package's columns
MODELS = {
    "wide_deep": (lambda c: jmodels.WideDeep(tuple(c), hidden_units=HIDDEN),
                  lambda c: WideDeep(c, hidden_units=HIDDEN, device="cpu", generator=_gen())),
    "nfm": (lambda c: jmodels.NFM(tuple(c), hidden_units=HIDDEN),
            lambda c: NFM(c, hidden_units=HIDDEN, device="cpu", generator=_gen())),
    "fm": (lambda c: jmodels.FM(tuple(c)),
           lambda c: FM(c, device="cpu", generator=_gen())),
    "fnn": (lambda c: jmodels.FNN(tuple(c), hidden_units=HIDDEN),
            lambda c: FNN(c, hidden_units=HIDDEN, device="cpu", generator=_gen())),
    "dcn": (lambda c: jmodels.DCN(tuple(c), cross_layers=2, hidden_units=HIDDEN),
            lambda c: DCN(c, cross_layers=2, hidden_units=HIDDEN, device="cpu",
                          generator=_gen())),
}


def _redraw(tree, rng):
    """Every ``table_d*`` leaf redrawn at std 0.1, every ``dense_factors`` at
    0.1, so that the embeddings have their say."""
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out[key] = _redraw(value, rng)
        elif key.startswith("table_d") or key == "dense_factors":
            out[key] = rng.normal(0.0, 0.1, np.shape(value)).astype(np.float32)
        else:
            out[key] = np.asarray(value)
    return out


@functools.lru_cache(maxsize=None)
def _jax_init(name, dim):
    """The JAX model's variables, tables redrawn; a BatchNorm's statistics
    moved off their initial values."""
    jcols, _, Xs, _ = _batches(dim)
    variables = MODELS[name][0](jcols).init(jax.random.PRNGKey(0), Xs[0])
    params = _redraw(jax.tree_util.tree_map(np.asarray, dict(variables["params"])),
                     np.random.default_rng(3))
    stats = jax.tree_util.tree_map(np.asarray, dict(variables.get("batch_stats", {})))
    if stats:
        rng = np.random.default_rng(4)
        stats = {"bn": {"mean": rng.normal(0, 0.3, stats["bn"]["mean"].shape).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, stats["bn"]["var"].shape).astype(np.float32)}}
    return params, stats


def _port_model(name, dim, params, stats):
    _, tcols, _, _ = _batches(dim, k=1)
    return load_jax_params(MODELS[name][1](tcols), params, stats or None)


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("name,dim", [("wide_deep", 8), ("nfm", 8), ("fm", 8), ("fnn", 8),
                                      ("nfm", 72), ("fm", 72)])
def test_forward_matches_jax(name, dim):
    jcols, _, Xs, _ = _batches(dim, seed=0, k=1)
    params, stats = _jax_init(name, dim)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    want = np.asarray(MODELS[name][0](jcols).apply(variables, Xs[0]))
    model = _port_model(name, dim, params, stats).eval()
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in Xs[0].items()}).numpy()
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.std(want) > 0.01


def test_ctr_models_names():
    # every CTR model of the JAX package, under its name
    assert set(CTR_MODELS) == set(jmodels.CTR_MODELS)
    for name, cls in CTR_MODELS.items():
        assert cls.__name__ == jmodels.CTR_MODELS[name].__name__
    assert port.WideDeep is CTR_MODELS["wide_deep"] and port.NFM is CTR_MODELS["nfm"]


@pytest.mark.parametrize("name", ["wide_deep", "nfm", "fm", "fnn"])
def test_models_need_a_card_unless_told(monkeypatch, name):
    _, tcols, _, _ = _batches(8, k=1)
    cls = CTR_MODELS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        cls(tcols, generator=_gen())
    cls(tcols, device="cpu", generator=_gen())


# ------------------------------------------------------------ training

# kind -> (model, dim, JAX optimizer, JAX fused config, port optimizer,
# port fused config)
KINDS = {
    "wide_deep_sgd": ("wide_deep", 8, lambda: optax.sgd(SGD_LR), None,
                      lambda: SGD(SGD_LR), None),
    "wide_deep_fused_sgd": ("wide_deep", 8, lambda: optax.sgd(SGD_LR),
                            lambda: JFusedSGD(SGD_LR), lambda: SGD(SGD_LR),
                            lambda: FusedSGD(SGD_LR)),
    "nfm_fused_adam": ("nfm", 72, lambda: optax.adam(ADAM_LR), lambda: JFusedAdam(ADAM_LR),
                       lambda: Adam(ADAM_LR), lambda: FusedAdam(ADAM_LR)),
    "fm_fused_adam": ("fm", 72, lambda: optax.adam(ADAM_LR), lambda: JFusedAdam(ADAM_LR),
                      lambda: Adam(ADAM_LR), lambda: FusedAdam(ADAM_LR)),
    "dcn_adagrad": ("dcn", 8, lambda: optax.adagrad(ADAGRAD_LR), None,
                    lambda: Adagrad(ADAGRAD_LR), None),
    "dcn_fused_adagrad": ("dcn", 8, lambda: optax.adagrad(ADAGRAD_LR),
                          lambda: JFusedAdagrad(ADAGRAD_LR), lambda: Adagrad(ADAGRAD_LR),
                          lambda: FusedAdagrad(ADAGRAD_LR)),
}


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    """K steps of the JAX Trainer from the redrawn start: the states after 2
    and after K steps (as numpy) and the losses."""
    name, dim, make_opt, make_fused, _, _ = KINDS[kind]
    jcols, _, Xs, ys = _batches(dim)
    trainer = JTrainer(MODELS[name][0](jcols), optimizer=make_opt(), seed=0,
                       fused_embedding=make_fused() if make_fused else None)
    state = trainer.init(Xs[0])
    params, stats = _jax_init(name, dim)
    state = state.replace(params=params, **({"batch_stats": stats} if stats else {}))
    step = trainer._make_train_step()
    states, losses = {}, []
    for i in range(K):
        state, loss = step(state, Xs[i], ys[i])
        losses.append(float(loss))
        states[i + 1] = jax.tree_util.tree_map(np.asarray, state)
    return states, np.asarray(losses)


def _port_trainer(kind, params, stats, fused):
    """The port's Trainer of ``kind`` (its fused config where ``fused``, else
    the dense optimizer on the tables too) on a model filled from JAX."""
    name, dim, _, _, make_opt, make_fused = KINDS[kind]
    return Trainer(_port_model(name, dim, params, stats), make_opt(),
                   fused_embedding=make_fused() if fused else None, device="cpu")


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


def _jax_view(kind, state, fused):
    stats = jax.tree_util.tree_map(np.asarray, dict(state.batch_stats))
    trainer = _port_trainer(kind, state.params, stats, fused)
    return _view(load_jax_opt_state(trainer, state.opt_state, step=int(state.step)))


def _stacked(Xs, ys):
    batches = {k: torch.from_numpy(np.stack([X[k] for X in Xs])) for k in Xs[0]}
    return batches, torch.from_numpy(np.stack(ys))


def _assert_views_close(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)


# case -> (port kind with its fused config, JAX run, tolerance)
PARITY = {
    # SGD is linear in the gradient: the fused step equals optax.sgd on the
    # dense gradient, which the JAX package's plain step computes in f32
    "wide_deep_fused_sgd_vs_jax_dense": ("wide_deep_fused_sgd", "wide_deep_sgd",
                                         (F32_RTOL, F32_ATOL)),
    "wide_deep_fused_sgd_vs_jax_fused": ("wide_deep_fused_sgd", "wide_deep_fused_sgd",
                                         (BF16_RTOL, BF16_ATOL)),
    # lazy Adam against the JAX FusedAdam Trainer at a width where it runs
    # f32 (at lane-packed widths one bf16 rounding of a cotangent can turn a
    # row's first Adam step, lr * sign(g), around)
    "nfm_fused_adam_vs_jax_fused": ("nfm_fused_adam", "nfm_fused_adam", (F32_RTOL, F32_ATOL)),
    "fm_fused_adam_vs_jax_fused": ("fm_fused_adam", "fm_fused_adam", (F32_RTOL, F32_ATOL)),
    "dcn_fused_adagrad_vs_jax_dense": ("dcn_fused_adagrad", "dcn_adagrad",
                                       (F32_RTOL, F32_ATOL)),
    "dcn_fused_adagrad_vs_jax_fused": ("dcn_fused_adagrad", "dcn_fused_adagrad",
                                       (BF16_RTOL, BF16_ATOL)),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_fused_training_matches_jax(case):
    kind, jax_kind, (rtol, atol) = PARITY[case]
    name, dim = KINDS[kind][:2]
    params, stats = _jax_init(name, dim)
    states, losses = _jax_run(jax_kind)
    trainer = _port_trainer(kind, params, stats, fused=True)
    _, _, Xs, ys = _batches(dim)
    got_losses = trainer.multi_step(*_stacked(Xs, ys))
    assert trainer.step == K
    np.testing.assert_allclose(got_losses.numpy(), losses, rtol=rtol, atol=atol)
    want = _jax_view(kind, states[K], fused=KINDS[jax_kind][3] is not None)
    _assert_views_close(_view(trainer), want, rtol, atol)
    if name == "nfm":
        # the BatchNorm statistics moved with the batches
        assert not np.allclose(_view(trainer)["bn.running_mean"], stats["bn"]["mean"])


@pytest.mark.parametrize("kind", ["nfm_fused_adam", "wide_deep_fused_sgd"])
def test_jax_opt_state_carries_across(kind):
    """A JAX run of 2 steps with FusedAdam + optax.adam, or FusedSGD +
    optax.sgd, carried into the port, then 2 more steps in each."""
    states, losses = _jax_run(kind)
    name, dim = KINDS[kind][:2]
    stats = jax.tree_util.tree_map(np.asarray, dict(states[2].batch_stats))
    trainer = _port_trainer(kind, states[2].params, stats, fused=True)
    dense, slots = states[2].opt_state
    if kind == "wide_deep_fused_sgd":
        assert all(type(s).__name__ == "EmptyState" for s in dense)
        assert all(s == () for s in slots.values())
    else:
        assert all(len(s) == 2 for s in slots.values())
    load_jax_opt_state(trainer, states[2].opt_state, step=int(states[2].step))
    assert trainer.step == 2
    _, _, Xs, ys = _batches(dim)
    got = trainer.multi_step(*_stacked(Xs[2:], ys[2:]))
    rtol, atol = (F32_RTOL, F32_ATOL) if dim == 72 else (BF16_RTOL, BF16_ATOL)
    np.testing.assert_allclose(got.numpy(), losses[2:], rtol=rtol, atol=atol)
    _assert_views_close(_view(trainer), _jax_view(kind, states[K], fused=True), rtol, atol)


def test_load_jax_opt_state_places_adam_slots_and_count():
    states, _ = _jax_run("nfm_fused_adam")
    stats = jax.tree_util.tree_map(np.asarray, dict(states[2].batch_stats))
    trainer = _port_trainer("nfm_fused_adam", states[2].params, stats, fused=True)
    load_jax_opt_state(trainer, states[2].opt_state)
    assert trainer.step == 2  # from Adam's count
    (path, (m, v)), = states[2].opt_state[1].items()
    got_m, got_v = trainer.fused_slots[".".join(path)]
    np.testing.assert_array_equal(got_m.numpy(), j_unpack_stack(m, got_m.shape[0], 72))
    np.testing.assert_array_equal(got_v.numpy(), j_unpack_stack(v, got_v.shape[0], 72))
    with pytest.raises(KeyError, match="no JAX optimizer state"):
        load_jax_opt_state(_port_trainer("nfm_fused_adam", states[2].params, stats, True),
                           (states[2].opt_state[0], {}))


def test_load_jax_opt_state_needs_a_step_without_a_count():
    """optax.sgd's state (``EmptyState``s) carries no step count: without
    ``step`` the load raises rather than restart the run at step 0."""
    states, _ = _jax_run("wide_deep_fused_sgd")
    stats = jax.tree_util.tree_map(np.asarray, dict(states[2].batch_stats))
    trainer = _port_trainer("wide_deep_fused_sgd", states[2].params, stats, fused=True)
    with pytest.raises(ValueError, match="pass step="):
        load_jax_opt_state(trainer, states[2].opt_state)
    assert trainer.step == 0
    load_jax_opt_state(trainer, states[2].opt_state, step=2)
    assert trainer.step == 2


# ------------------------------------------------------------ FM -> FNN

def test_init_from_fm_matches_jax():
    jcols, tcols, Xs, _ = _batches(8, k=1)
    fm_params, _ = _jax_init("fm", 8)
    fnn_params, _ = _jax_init("fnn", 8)
    want = jmodels.init_from_fm({"params": fnn_params}, {"params": fm_params}, tuple(jcols))
    fm = _port_model("fm", 8, fm_params, None)
    fnn = _port_model("fnn", 8, fnn_params, None)
    assert init_from_fm(fnn, fm) is fnn
    table = fnn.embeddings.table_d8
    np.testing.assert_array_equal(
        table.detach().numpy(),
        j_unpack_stack(np.asarray(want["params"]["embeddings"]["table_d8"]), table.shape[0], 8))
    assert torch.equal(table, fm.unified.embeddings.table_d9[:, :8])
    # the FNN's forward reads the copied factors
    want_out = jmodels.FNN(tuple(jcols), hidden_units=HIDDEN).apply(want, Xs[0])
    with torch.inference_mode():
        got = fnn.eval()({k: torch.from_numpy(v) for k, v in Xs[0].items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want_out), rtol=0, atol=1e-5)


def test_init_from_fm_refuses_a_smaller_fnn():
    _, tcols, _, _ = _batches(8, k=1)
    fm = FM(tcols, device="cpu", generator=_gen())
    small = FNN(tcols[:4] + tcols[-2:], hidden_units=HIDDEN, device="cpu", generator=_gen())
    with pytest.raises(ValueError, match="rows"):
        init_from_fm(small, fm)
