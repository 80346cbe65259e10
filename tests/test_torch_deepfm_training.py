"""The port's DeepFM training path against the JAX package's: metrics, loss,
interactions, dropout, the DeepFM forward on transplanted weights, the
fused and plain Trainer steps, evaluation, and carrying a JAX run's optimizer
state across (``convert.load_jax_opt_state``)."""
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from recommender_system_tpu.layers.core import DNN as JDNN
from recommender_system_tpu.models import DeepFM as JDeepFM
from recommender_system_tpu.ops.interactions import bi_interaction as j_bi_interaction
from recommender_system_tpu.ops.interactions import fm_interaction as j_fm_interaction
from recommender_system_tpu.training import FusedAdagrad as JFusedAdagrad
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.training.losses import bce_with_logits as j_bce_with_logits
from recommender_system_tpu.utils import metrics as jmetrics
from recommender_system_tpu.utils.datasets import synthetic_criteo as j_synthetic_criteo
from recommender_system_tpu_torch import DeepFM, FusedAdagrad, Trainer
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params
from recommender_system_tpu_torch.layers.core import DNN
from recommender_system_tpu_torch.ops.interactions import bi_interaction, fm_interaction
from recommender_system_tpu_torch.training import Adagrad, Adam, bce_with_logits
from recommender_system_tpu_torch.utils import metrics
from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

LR = 0.05
B, K, HIDDEN = 128, 4, (16,)
DATA = dict(n_dense=4, n_sparse=6, vocab=50, embedding_dim=8)
# f32 on both sides; the GEMMs and the reductions over the batch and over a
# row's duplicate ids are summed in another order, over K chained steps
F32_RTOL, F32_ATOL = 1e-4, 1e-6
# the JAX package's fused kernel rounds every cotangent to bf16 (2**-9
# relative) before it sums a row's gradient; the port keeps them f32
BF16_RTOL, BF16_ATOL = 1e-2, 2e-4


def _gen():
    return torch.Generator().manual_seed(0)


def _flat(tree, prefix=""):
    """A nested dict of arrays -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ----------------------------------------------------------------- metrics

def _scores(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    labels = (rng.uniform(size=n) < 0.3).astype(np.float32)
    scores = rng.uniform(size=n).astype(np.float32)
    scores[:50] = 0.5  # ties
    scores[50:60] = [0.0, 1.0, 1.0 - 1e-9, 1e-9, 0.999999, 0.25, 0.75, 0.5, 1.0, 0.0]
    return labels, scores


def test_metrics_bit_exact():
    labels, scores = _scores()
    for fn in ("auc", "logloss", "accuracy"):
        assert getattr(metrics, fn)(labels, scores) == getattr(jmetrics, fn)(labels, scores)
    assert np.isnan(metrics.auc(np.ones(4), scores[:4]))
    got, want = metrics.StreamingAUC(), jmetrics.StreamingAUC()
    for lo in range(0, len(labels), 300):
        sl = slice(lo, lo + 300)
        got.update(labels[sl], scores[sl])
        want.update(labels[sl], scores[sl])
    weights = (np.arange(300) % 3 > 0).astype(np.float32)
    got.update(labels[:300], scores[:300], weights)
    want.update(labels[:300], scores[:300], weights)
    np.testing.assert_array_equal(got.pos, want.pos)
    np.testing.assert_array_equal(got.neg, want.neg)
    assert got.result() == want.result()


# ------------------------------------------------ loss and interactions

@pytest.mark.parametrize("weighted", [False, True])
def test_bce_with_logits_matches_jax(weighted):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(B, 1)) * 5).astype(np.float32)
    labels = (rng.uniform(size=B) < 0.5).astype(np.float32)
    w = (rng.uniform(size=B) < 0.7).astype(np.float32) if weighted else None
    want = j_bce_with_logits(jnp.asarray(logits), jnp.asarray(labels),
                             None if w is None else jnp.asarray(w))
    got = bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                          None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_interactions_match_jax():
    rng = np.random.default_rng(2)
    e = rng.normal(size=(B, 6, 8)).astype(np.float32)
    x = rng.normal(size=(B, 20)).astype(np.float32)
    v = rng.normal(size=(20, 8)).astype(np.float32)
    np.testing.assert_allclose(bi_interaction(torch.from_numpy(e)).numpy(),
                               np.asarray(j_bi_interaction(jnp.asarray(e))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fm_interaction(torch.from_numpy(x), torch.from_numpy(v)).numpy(),
                               np.asarray(j_fm_interaction(jnp.asarray(x), jnp.asarray(v))),
                               rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------------- dropout

def test_dropout_draws_from_its_generator():
    rate = 0.3
    dnn = DNN(64, (512,), activation="linear", dropout_rate=rate, device="cpu",
              generator=_gen()).train()
    x = torch.ones(256, 64)
    masks = [dnn(x, generator=torch.Generator().manual_seed(7)) != 0 for _ in range(2)]
    assert torch.equal(masks[0], masks[1])
    other = dnn(x, generator=torch.Generator().manual_seed(8)) != 0
    assert not torch.equal(masks[0], other)
    n = masks[0].numel()
    kept = masks[0].float().mean().item()
    assert abs(kept - (1 - rate)) < 3 * np.sqrt(rate * (1 - rate) / n)
    with pytest.raises(ValueError, match="Generator"):
        dnn(x)
    dnn.eval()
    torch.testing.assert_close(dnn(x), dnn(x, generator=torch.Generator().manual_seed(9)))


@pytest.mark.parametrize("kw", [dict(use_bn=True), dict(activation="dice")],
                         ids=["batchnorm", "dice"])
def test_batch_statistics_wait_for_sequence_slice(kw):
    """Train-mode BatchNorm and Dice, which the sequence-model slice brought:
    the tower normalises with the batch statistics and leaves Flax's running
    statistics."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(64, 8)) * 2 + 0.5).astype(np.float32)
    jdnn = JDNN((4,), **kw)
    variables = jdnn.init(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.3, np.shape(a)).astype(np.float32), variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    want, mutated = jdnn.apply({"params": params, "batch_stats": stats}, x, train=True,
                               mutable=["batch_stats"])
    dnn = load_jax_params(DNN(8, (4,), device="cpu", generator=_gen(), **kw), params,
                          stats).train()
    got = dnn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    flat = _flat(mutated["batch_stats"])
    assert flat
    for path, value in flat.items():
        *scope, key = path.split("/")
        name = ".".join(scope + [{"mean": "running_mean", "var": "running_var"}[key]])
        np.testing.assert_allclose(dnn.get_buffer(name).numpy(), np.asarray(value),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


# ------------------------------------------------------- DeepFM vs JAX

def _batches(seed, k=K, n=B):
    """K batches from numpy seeds: JAX columns, port columns, X [K] and y."""
    jcols, X, y = j_synthetic_criteo(n_rows=k * n, seed=seed, **DATA)
    tcols = synthetic_criteo(n_rows=8, seed=seed, **DATA)[0]
    Xs = [{c: v[i * n:(i + 1) * n] for c, v in X.items()} for i in range(k)]
    return jcols, tcols, Xs, [y[i * n:(i + 1) * n] for i in range(k)]


def _jax_params(jmodel, X0, seed=3):
    """JAX init, with the table redrawn at std 0.1 so that the FM term and
    the embeddings have their say."""
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), X0)["params"])
    params = jax.tree_util.tree_map(lambda a: a, dict(params))
    rng = np.random.default_rng(seed)
    table = params["unified"]["embeddings"]["table_d9"]
    params["unified"] = dict(params["unified"])
    params["unified"]["embeddings"] = {
        "table_d9": rng.normal(0.0, 0.1, table.shape).astype(np.float32)}
    return params


def _port_model(tcols, params, dnn_dtype=None):
    model = DeepFM(tcols, hidden_units=HIDDEN, dnn_dtype=dnn_dtype, device="cpu",
                   generator=_gen())
    return load_jax_params(model, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepfm_forward_matches_jax(dtype):
    bf16 = dtype == "bfloat16"
    jcols, tcols, Xs, _ = _batches(seed=0, k=1)
    jmodel = JDeepFM(tuple(jcols), hidden_units=HIDDEN,
                     dnn_dtype=jnp.bfloat16 if bf16 else None)
    params = _jax_params(jmodel, Xs[0])
    # table_d9 is lane-packed 14 rows to a 128-lane row: lanes 126-127 unused
    assert params["unified"]["embeddings"]["table_d9"].shape[1] == 128
    want = np.asarray(jmodel.apply({"params": params}, Xs[0]))
    model = _port_model(tcols, params, torch.bfloat16 if bf16 else None).eval()
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in Xs[0].items()}).numpy()
    assert got.shape == want.shape == (B, 1)
    # bf16 rounds the tower's inputs, weights and activations; the two
    # frameworks round the dots' f32 sums at different places
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 if bf16 else 1e-5)
    assert np.std(want) > 0.05


# ---------------------------------------------------------------- training

JAX_KINDS = {
    "adagrad": (lambda: optax.adagrad(LR), False),
    "fused": (lambda: optax.adagrad(LR), True),
    "adam": (lambda: optax.adam(1e-2), False),
}
PORT_OPTIMIZERS = {"adagrad": lambda: Adagrad(LR), "fused": lambda: Adagrad(LR),
                   "adam": lambda: Adam(1e-2)}


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    """K steps of the JAX Trainer from redrawn weights: the start, the
    states after 2 and after K steps (as numpy), and the losses."""
    make_opt, fused = JAX_KINDS[kind]
    jcols, _, Xs, ys = _batches(seed=1)
    jmodel = JDeepFM(tuple(jcols), hidden_units=HIDDEN)
    trainer = JTrainer(jmodel, optimizer=make_opt(), seed=0,
                       fused_embedding=JFusedAdagrad(LR) if fused else None)
    state = trainer.init(Xs[0])
    params = _jax_params(jmodel, Xs[0])
    state = state.replace(params=params)
    step = trainer._make_train_step()
    states, losses = {}, []
    for i in range(K):
        state, loss = step(state, Xs[i], ys[i])
        losses.append(float(loss))
        states[i + 1] = jax.tree_util.tree_map(np.asarray, state)
    return params, states, np.asarray(losses)


def _port_trainer(kind, params, fused):
    _, tcols, _, _ = _batches(seed=1, k=1)
    return Trainer(_port_model(tcols, params), PORT_OPTIMIZERS[kind](),
                   fused_embedding=FusedAdagrad(LR) if fused else None, device="cpu")


def _view(trainer):
    """Parameters and optimizer state by name, the fused slots under the
    name the dense Adagrad gives a table's accumulator."""
    out = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}
    for n, slots in trainer.opt_state.items():
        out.update({f"{k}:{n}": v.numpy().copy() for k, v in slots.items()})
    for n, (acc,) in trainer.fused_slots.items():
        out[f"sum_of_squares:{n}"] = acc.numpy().copy()
    return out


def _jax_view(kind, state, fused):
    trainer = _port_trainer(kind, state.params, fused)
    return _view(load_jax_opt_state(trainer, state.opt_state, step=int(state.step)))


def _stacked(Xs, ys):
    batches = {k: torch.from_numpy(np.stack([X[k] for X in Xs])) for k in Xs[0]}
    return batches, torch.from_numpy(np.stack(ys))


def _assert_views_close(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)


# (port optimizer, port fused, JAX run, tolerance)
PARITY = {
    # the port's fused step against the JAX package's dense optax Adagrad,
    # which its own tests hold equal to its fused step
    "fused_vs_jax_dense": ("fused", True, "adagrad", (F32_RTOL, F32_ATOL)),
    "fused_vs_jax_fused": ("fused", True, "fused", (BF16_RTOL, BF16_ATOL)),
    "plain_adagrad": ("adagrad", False, "adagrad", (F32_RTOL, F32_ATOL)),
    "plain_adam": ("adam", False, "adam", (F32_RTOL, F32_ATOL)),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_training_matches_jax(case):
    kind, fused, jax_kind, (rtol, atol) = PARITY[case]
    params, states, losses = _jax_run(jax_kind)
    trainer = _port_trainer(kind, params, fused)
    _, _, Xs, ys = _batches(seed=1)
    got_losses = trainer.multi_step(*_stacked(Xs, ys))
    assert trainer.step == K
    np.testing.assert_allclose(got_losses.numpy(), losses, rtol=rtol, atol=atol)
    want = _jax_view(jax_kind, states[K], JAX_KINDS[jax_kind][1])
    _assert_views_close(_view(trainer), want, rtol, atol)


@pytest.mark.parametrize("kind", sorted(JAX_KINDS))
def test_jax_opt_state_carries_across(kind):
    """A JAX run of 2 steps, carried into the port, then 2 more steps in each."""
    fused = JAX_KINDS[kind][1]
    _, states, losses = _jax_run(kind)
    trainer = _port_trainer(kind, states[2].params, fused)
    load_jax_opt_state(trainer, states[2].opt_state, step=int(states[2].step))
    assert trainer.step == 2
    _, _, Xs, ys = _batches(seed=1)
    got = trainer.multi_step(*_stacked(Xs[2:], ys[2:]))
    rtol, atol = (BF16_RTOL, BF16_ATOL) if fused else (F32_RTOL, F32_ATOL)
    np.testing.assert_allclose(got.numpy(), losses[2:], rtol=rtol, atol=atol)
    _assert_views_close(_view(trainer), _jax_view(kind, states[K], fused), rtol, atol)


def test_load_jax_opt_state_rejects_what_it_cannot_place():
    params, states, _ = _jax_run("fused")
    dense_state, slots = states[2].opt_state
    with pytest.raises(KeyError, match="table_d9"):
        # a fused state into a trainer that has no fused slots
        load_jax_opt_state(_port_trainer("adagrad", params, False), states[2].opt_state)
    with pytest.raises(KeyError, match="no JAX optimizer state"):
        load_jax_opt_state(_port_trainer("fused", params, True), (dense_state, {}))
    with pytest.raises(KeyError, match="has no counterpart"):
        extra = {**slots, ("unified", "embeddings", "table_d4"):
                 slots[("unified", "embeddings", "table_d9")]}
        load_jax_opt_state(_port_trainer("fused", params, True), (dense_state, extra))


def test_multi_step_equals_single_steps():
    params, _, _ = _jax_run("adagrad")
    _, _, Xs, ys = _batches(seed=1)
    stepped, multi = (_port_trainer("fused", params, True) for _ in range(2))
    singles = [stepped.train_step({k: torch.from_numpy(v) for k, v in X.items()},
                                  torch.from_numpy(y)) for X, y in zip(Xs, ys)]
    losses = multi.multi_step(*_stacked(Xs, ys))
    torch.testing.assert_close(losses, torch.stack(singles), rtol=0, atol=0)
    _assert_views_close(_view(multi), _view(stepped), 0, 0)


def test_lr_schedule_reads_the_step():
    params, _, _ = _jax_run("adagrad")
    _, tcols, Xs, ys = _batches(seed=1)
    seen = []
    trainer = Trainer(_port_model(tcols, params), Adagrad(LR),
                      fused_embedding=FusedAdagrad(lambda s: seen.append(s) or LR),
                      device="cpu")
    trainer.multi_step(*_stacked(Xs, ys))
    assert seen == list(range(K))


def test_fit_and_evaluate_match_jax_metrics():
    params, _, _ = _jax_run("adagrad")
    _, X, y = synthetic_criteo(n_rows=1000, seed=5, **DATA)
    trainer = _port_trainer("fused", params, True)
    history = trainer.fit(X, y, batch_size=B, epochs=2, steps_per_call=3)
    assert trainer.step == 2 * (1000 // B)
    assert len(history["loss"]) == 2 and np.isfinite(history["loss"]).all()

    probs = trainer.predict(X, batch_size=300)[:, 0]
    got = trainer.evaluate(X, y, batch_size=300)
    assert got == {"auc": jmetrics.auc(y, probs), "logloss": jmetrics.logloss(y, probs),
                   "accuracy": jmetrics.accuracy(y, probs)}
    stream = jmetrics.StreamingAUC()
    for lo in range(0, 1000, 300):
        stream.update(y[lo:lo + 300], probs[lo:lo + 300])
    assert trainer.evaluate(X, y, batch_size=300, streaming=True)["auc"] == stream.result()



def test_evaluate_matches_jax_trainer():
    """The port's evaluate and the JAX Trainer's on one trained JAX state."""
    jcols, _, _, _ = _batches(seed=1, k=1)
    _, states, _ = _jax_run("adagrad")
    _, X, y = synthetic_criteo(n_rows=1000, seed=5, **DATA)
    trainer = _port_trainer("adagrad", states[K].params, False)
    jtrainer = JTrainer(JDeepFM(tuple(jcols), hidden_units=HIDDEN))
    for streaming in (False, True):
        got = trainer.evaluate(X, y, batch_size=300, streaming=streaming)
        want = jtrainer.evaluate(states[K], X, y, batch_size=300, streaming=streaming)
        assert got.keys() == want.keys()
        for key in want:
            # logits agree to ~1e-6 (f32, sums in another order)
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)


# ------------------------------------------------------------ entry points

def test_trainer_needs_a_card_unless_told(monkeypatch):
    params, _, _ = _jax_run("adagrad")
    model = _port_trainer("adagrad", params, False).model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        Trainer(model, Adagrad(LR))
    with pytest.raises(RuntimeError, match="no CUDA"):
        DeepFM(model.unified.embeddings.feature_columns, generator=_gen())
    with pytest.raises(TypeError, match="Mesh"):
        Trainer(model, Adagrad(LR), device="cpu", mesh=object())
    # without a mesh the exchange's options are ignored, as in the JAX package
    trainer = Trainer(model, Adagrad(LR), device="cpu", capacity_factor=0.5,
                      explicit_lookup=True)
    assert trainer.mesh is None and not trainer.tracks_overflow


def test_port_imports_without_jax():
    """The port and chip_smoke.py import with jax, flax, optax and the JAX
    package refused."""
    root = Path(__file__).resolve().parent.parent
    code = """
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "recommender_system_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import recommender_system_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
import chip_smoke
print("ok", len(sys.modules))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
