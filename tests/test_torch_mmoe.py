"""The port's multi-task path against the JAX package's: ``MMoELayer`` and
``TowerLayer`` on transplanted Flax weights (a copy that transposes
``experts`` fails), MMOE's forward on feature columns and on a raw dense
input, K=4 fused and plain MMOE steps against the JAX Trainer, and
``predict`` / ``evaluate`` / ``Scorer`` with per-task outputs."""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import optax

from recommender_system_tpu.layers.interaction import MMoELayer as JMMoELayer
from recommender_system_tpu.layers.interaction import TowerLayer as JTowerLayer
from recommender_system_tpu.models import MMOE as JMMOE
from recommender_system_tpu.serving import Scorer as JScorer
from recommender_system_tpu.training import FusedAdagrad as JFusedAdagrad
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.utils import datasets as jdatasets
from recommender_system_tpu_torch import MMOE, FusedAdagrad, Scorer, Trainer
from recommender_system_tpu_torch import convert
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params
from recommender_system_tpu_torch.layers import MMoELayer, TowerLayer
from recommender_system_tpu_torch.training import Adagrad
from recommender_system_tpu_torch.utils import datasets as tdatasets

LR = 0.05
ATOL = 1e-5  # f32 forward on both sides; einsums summed in another order
# training: f32 on both sides over K chained steps; the JAX fused kernel
# rounds every cotangent to bf16 (2**-9 relative) before it sums a row
F32_RTOL, F32_ATOL = 1e-4, 1e-6
BF16_RTOL, BF16_ATOL = 1e-2, 2e-4

B, STEPS, D_IN = 48, 4, 12
TASKS, EXPERTS, UNITS, TOWER = 2, 3, 6, (5,)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _redrawn(variables, seed, std=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, std, np.shape(a)).astype(np.float32), variables)


def _x(seed, n=B, d=D_IN):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# ------------------------------------------------------------ the layers

def test_mmoe_layer_matches_flax():
    x = _x(1)
    params = _redrawn(JMMoELayer(EXPERTS, UNITS, TASKS).init(jax.random.PRNGKey(0), x), 2)
    want = JMMoELayer(EXPERTS, UNITS, TASKS).apply(params, x)
    layer = MMoELayer(D_IN, EXPERTS, UNITS, TASKS, device=torch.device("cpu"), generator=_gen())
    assert {n: tuple(p.shape) for n, p in layer.named_parameters()} == {
        "experts": (D_IN, UNITS, EXPERTS), "expert_bias": (UNITS, EXPERTS),
        "gates": (TASKS, D_IN, EXPERTS), "gate_bias": (TASKS, EXPERTS)}
    load_jax_params(layer, params["params"])
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    assert len(got) == len(want) == TASKS
    for g, w in zip(got, want):
        assert g.shape == (B, UNITS)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL)


def test_mmoe_layer_without_biases_matches_flax():
    x = _x(3)
    jlayer = JMMoELayer(EXPERTS, UNITS, TASKS, use_expert_bias=False, use_gate_bias=False)
    params = _redrawn(jlayer.init(jax.random.PRNGKey(0), x), 4)
    layer = MMoELayer(D_IN, EXPERTS, UNITS, TASKS, use_expert_bias=False, use_gate_bias=False,
                      device=torch.device("cpu"), generator=_gen())
    assert layer.expert_bias is None and layer.gate_bias is None
    load_jax_params(layer, params["params"])
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    for g, w in zip(got, jlayer.apply(params, x)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_tower_layer_matches_flax(activation):
    x = _x(5, d=UNITS)
    jtower = JTowerLayer((7, 4), 1, activation=activation)
    params = _redrawn(jtower.init(jax.random.PRNGKey(0), x), 6)
    tower = TowerLayer(UNITS, (7, 4), 1, activation=activation, device=torch.device("cpu"),
                       generator=_gen())
    load_jax_params(tower, params["params"])
    with torch.no_grad():
        got = tower(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jtower.apply(params, x)),
                               rtol=1e-5, atol=ATOL)


# ------------------------------------------------------------ the model

def _data(n=B * STEPS, seed=0):
    """Criteo-shaped columns at a small size and model_step.py's two
    labels, ``[y, y[::-1]]``."""
    cols, X, y = jdatasets.synthetic_criteo(n_rows=n, n_dense=3, n_sparse=5, vocab=40,
                                            embedding_dim=4, seed=seed)
    return cols, X, np.stack([y, y[::-1].astype(np.float32)], axis=1)


def _tcols():
    cols, _, _ = tdatasets.synthetic_criteo(n_rows=8, n_dense=3, n_sparse=5, vocab=40,
                                            embedding_dim=4)
    return cols


def _jmmoe(**kw):
    return JMMOE(num_tasks=TASKS, num_experts=EXPERTS, expert_units=UNITS,
                 tower_hidden_units=TOWER, **kw)


def _port_mmoe(params, **kw):
    model = MMOE(num_tasks=TASKS, num_experts=EXPERTS, expert_units=UNITS,
                 tower_hidden_units=TOWER, device="cpu", generator=_gen(), **kw)
    return load_jax_params(model, params)


@functools.lru_cache(maxsize=None)
def _params():
    cols, X, _ = _data()
    params = _jmmoe(feature_columns=tuple(cols)).init(jax.random.PRNGKey(0), X)["params"]
    return _redrawn(params, 7)


def _torch(X):
    return {k: torch.from_numpy(v) for k, v in X.items()}


def test_mmoe_on_feature_columns_matches_flax():
    cols, X, _ = _data()
    want = _jmmoe(feature_columns=tuple(cols)).apply({"params": _params()}, X)
    model = _port_mmoe(_params(), feature_columns=_tcols())
    with torch.no_grad():
        got = model(_torch(X))
    assert isinstance(got, list) and len(got) == TASKS
    for g, w in zip(got, want):
        assert g.shape == (B * STEPS, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL)
    assert min(np.std(np.asarray(w)) for w in want) > 0.01


def _dense_params(d, seed):
    x = _x(8, d=d)
    return x, _redrawn(_jmmoe().init(jax.random.PRNGKey(0), x), seed)


def test_mmoe_on_a_dense_input_matches_flax():
    x, variables = _dense_params(D_IN, 9)
    want = _jmmoe().apply(variables, x)
    model = _port_mmoe(variables["params"], in_features=D_IN)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL)
    with pytest.raises(ValueError, match="pass in_features"):
        MMOE(device="cpu", generator=_gen())


def test_a_copy_that_transposes_experts_fails(monkeypatch):
    """With D == E, ``experts [D, H, E]`` transposed keeps its shape: a copy
    that transposes it passes every shape check and gives wrong outputs,
    which the comparison with Flax catches."""
    x, variables = _dense_params(EXPERTS, 10)
    want = _jmmoe().apply(variables, x)
    original = convert._copy_leaf

    def transposing(path, value, name, target):
        if path[-1] == "experts":
            value = value.T
        original(path, value, name, target)

    monkeypatch.setattr(convert, "_copy_leaf", transposing)
    mutant = _port_mmoe(variables["params"], in_features=EXPERTS)
    with torch.no_grad():
        got = mutant(torch.from_numpy(x))
    assert not all(np.allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL)
                   for g, w in zip(got, want))
    monkeypatch.setattr(convert, "_copy_leaf", original)
    with torch.no_grad():
        good = _port_mmoe(variables["params"], in_features=EXPERTS)(torch.from_numpy(x))
    for g, w in zip(good, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL)


def test_mmoe_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        MMOE(feature_columns=_tcols(), generator=_gen())


# ------------------------------------------------------------ training

def _batches():
    _, X, y = _data()
    return [({k: v[i * B:(i + 1) * B] for k, v in X.items()}, y[i * B:(i + 1) * B])
            for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_run(fused):
    cols, _, _ = _data()
    trainer = JTrainer(_jmmoe(feature_columns=tuple(cols)), optimizer=optax.adagrad(LR),
                       fused_embedding=JFusedAdagrad(LR) if fused else None)
    batches = _batches()
    state = trainer.init(batches[0][0]).replace(params=_params())
    step = trainer._make_train_step()
    losses, states = [], []
    for X, y in batches:
        state, loss = step(state, X, y)
        losses.append(float(loss))
        states.append(jax.tree_util.tree_map(np.asarray, state))
    return states, np.asarray(losses)


def _port_trainer(params, fused):
    return Trainer(_port_mmoe(params, feature_columns=_tcols()), Adagrad(LR), device="cpu",
                   fused_embedding=FusedAdagrad(LR) if fused else None)


def _view(trainer):
    out = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}
    for n, slots in trainer.opt_state.items():
        out.update({f"{k}:{n}": v.numpy().copy() for k, v in slots.items()})
    for n, (acc,) in trainer.fused_slots.items():
        out[f"sum_of_squares:{n}"] = acc.numpy().copy()
    return out


def _jax_view(state, fused):
    trainer = _port_trainer(state.params, fused)
    return _view(load_jax_opt_state(trainer, state.opt_state, step=int(state.step)))


# case -> (port fused, JAX fused, tolerance)
PARITY = {
    "fused_vs_jax_dense": (True, False, (F32_RTOL, F32_ATOL)),
    "fused_vs_jax_fused": (True, True, (BF16_RTOL, BF16_ATOL)),
    "plain_vs_jax_plain": (False, False, (F32_RTOL, F32_ATOL)),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_mmoe_training_matches_jax(case):
    fused, jfused, (rtol, atol) = PARITY[case]
    states, want_losses = _jax_run(jfused)
    trainer = _port_trainer(_params(), fused)
    batches = _batches()
    stacked = {k: torch.from_numpy(np.stack([X[k] for X, _ in batches])) for k in batches[0][0]}
    got = trainer.multi_step(stacked, torch.from_numpy(np.stack([y for _, y in batches])))
    np.testing.assert_allclose(got.numpy(), want_losses, rtol=rtol, atol=atol)
    got_view, want = _view(trainer), _jax_view(states[-1], jfused)
    assert got_view.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got_view[name], want[name], rtol=rtol, atol=atol,
                                   err_msg=name)
    assert want_losses[-1] < want_losses[0]


def test_mmoe_predict_evaluate_and_scorer_match_jax():
    states, _ = _jax_run(False)
    state = states[-1]
    cols, X, y = _data(n=75, seed=11)
    jtrainer = JTrainer(_jmmoe(feature_columns=tuple(cols)), optimizer=optax.adagrad(LR))
    trainer = _port_trainer(state.params, False)
    want = jtrainer.predict(state, X, batch_size=32)
    got = trainer.predict(X, batch_size=32)
    assert got.shape == want.shape == (75, TASKS)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    want_m = jtrainer.evaluate(state, X, y, batch_size=32)
    got_m = trainer.evaluate(X, y, batch_size=32)
    assert got_m.keys() == want_m.keys() == {f"task{t}_{m}" for t in range(TASKS)
                                             for m in ("auc", "logloss")}
    for key in want_m:
        np.testing.assert_allclose(got_m[key], want_m[key], rtol=1e-5, atol=1e-6, err_msg=key)
    jscorer = JScorer(_jmmoe(feature_columns=tuple(cols)),
                      types.SimpleNamespace(params=state.params, batch_stats={}), batch_size=32)
    scorer = Scorer(trainer.model, batch_size=32, device="cpu")
    for n in (1, 40, 75):
        Xn = {k: v[:n] for k, v in X.items()}
        got, want = scorer(Xn), jscorer(Xn)
        assert got.shape == want.shape == (n, TASKS)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
