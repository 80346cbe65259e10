"""The port's DIEN and the general loss path of its ``Trainer`` against the
JAX package's: ``default_loss``, a custom ``loss_fn``, ``weight_decay``
(``optax.add_decayed_weights`` chained before Adam, its state carried
across), the DIEN forward on transplanted weights (logits and the auxiliary
loss, with and without negative sampling, with and without ``query_proj``),
K=4 fused and plain training steps, ``predict``, ``evaluate`` and
``Scorer``; ``din_attention(remat=True)``'s gradients against JAX's
``din_attention_remat``; per-task outputs in ``predict`` and ``evaluate``."""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from recommender_system_tpu.models import DIEN as JDIEN
from recommender_system_tpu.ops.din_vjp import din_attention_remat as j_din_attention_remat
from recommender_system_tpu.serving import Scorer as JScorer
from recommender_system_tpu.training import FusedAdagrad as JFusedAdagrad
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.training.harness import default_loss as j_default_loss
from recommender_system_tpu.training.losses import bce_with_logits as j_bce_with_logits
from recommender_system_tpu.utils import features as jfeatures
from recommender_system_tpu_torch import CTR_MODELS, DIEN, FusedAdagrad, Scorer, Trainer
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params
from recommender_system_tpu_torch.ops.attention import din_attention
from recommender_system_tpu_torch.training import Adagrad, Adam, DecayedWeights, default_loss
from recommender_system_tpu_torch.training.losses import bce_with_logits, logits_of
from recommender_system_tpu_torch.utils import features as tfeatures

LR, ADAM_LR, WD = 0.05, 1e-2, 1e-4
ATOL = 1e-5  # f32 forward on both sides; sums in another order
# training: f32 on both sides over K chained steps; the JAX fused kernel
# rounds every cotangent to bf16 (2**-9 relative) before it sums a row
F32_RTOL, F32_ATOL = 1e-4, 1e-6
BF16_RTOL, BF16_ATOL = 1e-2, 2e-4
# gradients through the attention: chained sums over T and the batch
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

T, USERS, ITEMS, DIM = 6, 40, 60, 8
B, STEPS = 32, 4
HIDDEN, ATT = (16, 8), (10, 5)


def _gen():
    return torch.Generator().manual_seed(0)


def _schema(mod, neg=True):
    """``benchmarks/model_step.py``'s DIEN schema at a small size: the
    history and the sampled history share the item table."""
    cols = [mod.SparseFeat("user_id", USERS, DIM),
            mod.SparseFeat("item_id", ITEMS, DIM, embedding_name="item_id"),
            mod.VarLenSparseFeat(mod.SparseFeat("hist_item_id", ITEMS, DIM,
                                                embedding_name="item_id"), maxlen=T),
            mod.DenseFeat("price", 1)]
    if neg:
        cols.insert(3, mod.VarLenSparseFeat(mod.SparseFeat(
            "neg_hist_item_id", ITEMS, DIM, embedding_name="item_id"), maxlen=T))
    return cols


def _batch(seed, n=B):
    """As ``model_step.py`` builds a DIEN batch, with lengths from 0 (rows
    with no valid position), padding id 0 and a sampled history padded
    alike."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, T + 1, size=n)
    pad = np.arange(T)[None, :] >= lengths[:, None]
    hist = rng.integers(1, ITEMS, size=(n, T)).astype(np.int32)
    neg = rng.integers(1, ITEMS, size=(n, T)).astype(np.int32)
    hist[pad], neg[pad] = 0, 0
    X = {"user_id": rng.integers(1, USERS, size=n).astype(np.int32),
         "item_id": rng.integers(1, ITEMS, size=n).astype(np.int32),
         "hist_item_id": hist, "neg_hist_item_id": neg,
         "price": rng.normal(size=(n, 1)).astype(np.float32)}
    return X, rng.integers(0, 2, size=n).astype(np.float32)


# name -> DIEN keywords, the same for both packages
CONFIGS = {
    "negsampling": dict(use_negsampling=True),
    "negsampling_query_proj": dict(use_negsampling=True, gru_hidden=12),
    "plain": dict(),
    "plain_query_proj": dict(gru_hidden=12),
}


def _jdien(config="negsampling"):
    return JDIEN(tuple(_schema(jfeatures)), behavior_feature_list=("item_id",),
                 att_hidden_units=ATT, hidden_units=HIDDEN, **CONFIGS[config])


def _port_dien(params, config="negsampling"):
    model = DIEN(_schema(tfeatures), behavior_feature_list=("item_id",),
                 att_hidden_units=ATT, hidden_units=HIDDEN, device="cpu", generator=_gen(),
                 **CONFIGS[config])
    return load_jax_params(model, params)


def _torch(X):
    return {k: torch.from_numpy(v) for k, v in X.items()}


@functools.lru_cache(maxsize=None)
def _eval_params(config):
    """Every parameter redrawn, so that every term has its say."""
    rng = np.random.default_rng(9)
    params = _jdien(config).init(jax.random.PRNGKey(0), _batch(0)[0])["params"]
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.3, np.shape(a)).astype(np.float32), params)


# ------------------------------------------------------------ the forward

@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_dien_eval_matches_jax(config):
    params = _eval_params(config)
    X, _ = _batch(1)
    want_logits, want_aux = _jdien(config).apply({"params": params}, X)
    model = _port_dien(params, config).eval()
    with torch.inference_mode():
        logits, aux = model(_torch(X))
    assert logits.shape == want_logits.shape == (B, 1)
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=ATOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=1e-5, atol=ATOL)
    assert np.std(np.asarray(want_logits)) > 0.1
    if CONFIGS[config].get("use_negsampling"):
        assert float(want_aux) > 0.1
    else:
        assert float(aux) == 0.0
    assert ("query_proj" in params) == ("gru_hidden" in CONFIGS[config])
    assert (model.query_proj is not None) == ("gru_hidden" in CONFIGS[config])


def test_dien_train_mode_forward_matches_eval():
    """No BatchNorm and no dropout: train mode computes what eval mode
    does."""
    model = _port_dien(_eval_params("negsampling"))
    X = _torch(_batch(2)[0])
    with torch.no_grad():
        train = model.train()(X)
        evaluated = model.eval()(X)
    for a, b in zip(train, evaluated):
        assert torch.equal(a, b)


def test_dien_needs_neg_hist_for_negsampling():
    cols = _schema(jfeatures, neg=False)
    jmodel = JDIEN(tuple(cols), use_negsampling=True, hidden_units=HIDDEN)
    X = {k: v for k, v in _batch(3)[0].items() if k != "neg_hist_item_id"}
    with pytest.raises(ValueError, match="use_negsampling=True but batch/columns lack"):
        jmodel.init(jax.random.PRNGKey(0), X)
    with pytest.raises(ValueError, match="use_negsampling=True but batch/columns lack"):
        DIEN(_schema(tfeatures, neg=False), use_negsampling=True, hidden_units=HIDDEN,
             device="cpu", generator=_gen())


def test_dien_needs_a_card_unless_told(monkeypatch):
    assert CTR_MODELS["dien"] is DIEN
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        DIEN(_schema(tfeatures), generator=_gen())


# ------------------------------------------------------------ the losses

def test_default_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(B, 1)).astype(np.float32)
    tasks = [rng.normal(size=(B, 1)).astype(np.float32) for _ in range(2)]
    labels = rng.integers(0, 2, B).astype(np.float32)
    labels2 = rng.integers(0, 2, (B, 2)).astype(np.float32)
    aux = np.float32(0.375)
    cases = [
        (logits, labels, logits, labels),
        ((logits, aux), labels, (logits, aux), labels),
        (tasks, labels2, tasks, labels2),
    ]
    for j_out, j_y, t_out, t_y in cases:
        want = float(j_default_loss(jax.tree_util.tree_map(jnp.asarray, j_out), jnp.asarray(j_y)))
        t_out = (tuple(map(torch.as_tensor, t_out)) if isinstance(t_out, tuple)
                 else [torch.as_tensor(t) for t in t_out] if isinstance(t_out, list)
                 else torch.as_tensor(t_out))
        got = float(default_loss(t_out, torch.as_tensor(t_y)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(float(default_loss((torch.as_tensor(logits), torch.tensor(aux)),
                                                  torch.as_tensor(labels))),
                               float(bce_with_logits(torch.as_tensor(logits),
                                                     torch.as_tensor(labels))) + aux, rtol=1e-6)
    with pytest.raises(ValueError, match=r"needs labels of shape \[B, 2\]"):
        j_default_loss([jnp.asarray(t) for t in tasks], jnp.asarray(labels))
    with pytest.raises(ValueError, match=r"needs labels of shape \[B, 2\]"):
        default_loss([torch.as_tensor(t) for t in tasks], torch.as_tensor(labels))


def test_logits_of_reads_outputs_as_predict_and_the_scorer_do():
    logits = torch.arange(6.0).reshape(3, 2)
    assert logits_of(logits) is logits
    assert logits_of((logits, torch.tensor(0.5))) is logits
    torch.testing.assert_close(logits_of([logits[:, :1], logits[:, 1:]]), logits)


def _half_aux(outputs, labels, batch):
    """A custom loss: half the auxiliary loss, BCE weighted by the price's
    sign (reads the batch)."""
    logits, aux = outputs
    return _weighted_bce(logits, labels, batch["price"][:, 0] > 0) + 0.5 * aux


def _weighted_bce(logits, labels, positive):
    if isinstance(logits, torch.Tensor):
        return bce_with_logits(logits, labels, 1.0 + positive.to(torch.float32))
    return j_bce_with_logits(logits, labels, 1.0 + positive.astype(jnp.float32))


# ------------------------------------------------------------ training

def _recording():
    """An optax transformation that passes the updates on and keeps them as
    its state: after ``add_decayed_weights`` it records each step's decayed
    gradient ``g + wd * p``."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


# kind -> (JAX dense optimizer, JAX fused optimizer, loss_fn, weight decay)
JAX_KINDS = {
    "adagrad": (lambda: optax.adagrad(LR), None, None, 0.0),
    "fused": (lambda: optax.adagrad(LR), lambda: JFusedAdagrad(LR), None, 0.0),
    "custom_loss": (lambda: optax.adagrad(LR), None, _half_aux, 0.0),
    "adam_wd": (lambda: optax.adam(ADAM_LR), None, None, WD),
    "adam_wd_recorded": (lambda: optax.chain(_recording(), optax.adam(ADAM_LR)), None, None,
                         WD),
}
PORT_OPTIMIZERS = {"adagrad": lambda: Adagrad(LR), "fused": lambda: Adagrad(LR),
                   "custom_loss": lambda: Adagrad(LR), "adam_wd": lambda: Adam(ADAM_LR),
                   "adam_wd_recorded": lambda: Adam(ADAM_LR)}


def _batches():
    return [_batch(10 + i) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    """STEPS steps of the JAX Trainer from every parameter redrawn (at the
    initial values the attention's gradients are ~1e-8, where Adam's
    ``m / (sqrt(v) + 1e-8)`` turns f32 rounding into whole steps): the
    start params, the state after each step, the losses."""
    optimizer, fused, loss_fn, wd = JAX_KINDS[kind]
    kw = {"loss_fn": loss_fn} if loss_fn else {}
    trainer = JTrainer(_jdien(), optimizer=optimizer(), seed=0, weight_decay=wd,
                       fused_embedding=fused() if fused else None, **kw)
    batches = _batches()
    state = trainer.init(batches[0][0])
    params = _eval_params("negsampling")
    state = state.replace(params=params)
    step = trainer._make_train_step()
    losses, states = [], []
    for X, y in batches:
        state, loss = step(state, X, y)
        losses.append(float(loss))
        states.append(jax.tree_util.tree_map(np.asarray, state))
    return params, states, np.asarray(losses)


def _port_trainer(kind, params, fused):
    _, _, loss_fn, wd = JAX_KINDS[kind]
    kw = {"loss_fn": loss_fn} if loss_fn else {}
    return Trainer(_port_dien(params), PORT_OPTIMIZERS[kind](),
                   fused_embedding=FusedAdagrad(LR) if fused else None, device="cpu",
                   weight_decay=wd, **kw)


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


def _multi_step(trainer, batches):
    stacked = {k: torch.from_numpy(np.stack([X[k] for X, _ in batches])) for k in batches[0][0]}
    return trainer.multi_step(stacked, torch.from_numpy(np.stack([y for _, y in batches])))


def _assert_views(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)


# case -> (port fused, JAX run, tolerance)
PARITY = {
    # the port's fused step against the JAX package's dense optax Adagrad
    "fused_vs_jax_dense": (True, "adagrad", (F32_RTOL, F32_ATOL)),
    "fused_vs_jax_fused": (True, "fused", (BF16_RTOL, BF16_ATOL)),
    "plain_vs_jax_plain": (False, "adagrad", (F32_RTOL, F32_ATOL)),
    "plain_custom_loss": (False, "custom_loss", (F32_RTOL, F32_ATOL)),
    "plain_adam_weight_decay": (False, "adam_wd_recorded", (F32_RTOL, F32_ATOL)),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_dien_training_matches_jax(case):
    fused, kind, (rtol, atol) = PARITY[case]
    params, states, losses = _jax_run(kind)
    trainer = _port_trainer(kind, params, fused)
    if kind == "adam_wd_recorded":
        _adam_matches_jax_within_its_sensitivity(trainer, params, states, losses, rtol, atol)
        return
    got = _multi_step(trainer, _batches())
    assert trainer.step == STEPS
    np.testing.assert_allclose(got.numpy(), losses, rtol=rtol, atol=atol)
    _assert_views(_view(trainer), _jax_view(kind, states[-1], JAX_KINDS[kind][1] is not None),
                  rtol, atol)


# Adam with weight decay: where a gradient all but cancels its decay term the
# Adam step is ill-conditioned. At attention.w2[1, 3] the first step's
# gradient is 3.78e-6 against wd * p = -3.78e-6, so g + wd * p = 8.3e-9, next
# to Adam's eps of 1e-8; m_hat / (sqrt(v_hat) + eps) then moves by ~8e7 per
# unit of gradient, and an f32 difference of 3e-11 in g (1e-5 of it) moves
# the parameter by ~1e-5 after 4 steps at lr 1e-2. So each step's decayed
# gradients are held at f32 tolerance, ADAM_GRAD_RTOL of the size of their
# terms (|g| + |wd * p|) plus ADAM_GRAD_FLOOR (attention.b3's gradient is
# exactly zero, a softmax being blind to a shift of every score, and both
# sides give rounding noise of up to 7.9e-10 there); the moments and the
# parameters are held at F32_RTOL / F32_ATOL plus what the gradient
# differences each step measured move them by through Adam, to first order
# (_adam_bounds). That bound passes 1e-6 at about 15 of the model's 9,370
# parameters (attention.w2[1, 3] 3.7e-5, against a difference of 5.8e-6).
ADAM_GRAD_RTOL, ADAM_GRAD_FLOOR = 1e-4, 4e-9
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _named(tree):
    """A JAX parameter-shaped tree by the port's parameter names."""
    return {n: p.detach().numpy().copy() for n, p in _port_dien(tree).named_parameters()}


def _adam_bounds(grads, deltas, moments):
    """First-order bounds on the differences of Adam's moments (per step)
    and of the parameters after the last step, given the differences
    ``deltas[t]`` of the decayed gradients ``grads[t]``; the
    sensitivities are taken at the JAX run's moments ``moments[t] = (mu,
    nu)``. One step is ``p -= lr * u`` with ``u = m_hat / (sqrt(v_hat) +
    eps)``, so ``|dp| <= lr * sum_t (|dm_hat| / (sqrt(v_hat) + eps) +
    |m_hat| |dv_hat| / (2 sqrt(v_hat) (sqrt(v_hat) + eps)^2))``."""
    dm = dv = dp = 0.0
    out = []
    for t, (g, d, (mu, nu)) in enumerate(zip(grads, deltas, moments)):
        dm = B1 * dm + (1 - B1) * d
        dv = B2 * dv + (1 - B2) * (2 * np.abs(g) * d + d * d)
        bc1, bc2 = 1 - B1 ** (t + 1), 1 - B2 ** (t + 1)
        m_hat, sv = mu / bc1, np.sqrt(nu / bc2)
        dv_term = np.divide(np.abs(m_hat), 2 * sv * (sv + ADAM_EPS) ** 2,
                            out=np.zeros_like(sv), where=sv > 0)
        dp = dp + ADAM_LR * (dm / bc1 / (sv + ADAM_EPS) + dv_term * dv / bc2)
        out.append((dm, dv))
    return out, dp


def _assert_within(got, want, rtol, atol, bound, name):
    excess = np.abs(got - want) - (atol + rtol * np.abs(want) + bound)
    assert excess.max() <= 0, (f"{name}: {np.argmax(excess)} off by "
                               f"{np.abs(got - want).ravel()[np.argmax(excess)]:.3g}")


def _adam_matches_jax_within_its_sensitivity(trainer, params, states, losses, rtol, atol):
    """Step by step: the losses at f32 tolerance, the decayed gradients at
    ``ADAM_GRAD_RTOL`` and ``ADAM_GRAD_FLOOR``, the moments and the final
    parameters at f32 tolerance plus ``_adam_bounds`` of the measured
    gradient differences."""
    named = dict(trainer.model.named_parameters())
    before_jax = _named(params)
    got_losses, grads, deltas, moments = [], [], [], []
    for t, batch in enumerate(_batches()):
        before = {n: p.detach().clone() for n, p in named.items()}
        got_losses.append(float(_multi_step(trainer, [batch])[0]))
        _, (recorded, (adam, _)) = states[t].opt_state
        want = _named(recorded)
        mu, nu = _named(adam.mu), _named(adam.nu)
        step_grads, step_deltas = {}, {}
        for n, p in named.items():
            got = (p.grad + WD * before[n]).numpy()
            raw = np.abs(want[n] - WD * before_jax[n]) + WD * np.abs(before_jax[n])
            _assert_within(got, want[n], 0.0, 0.0, ADAM_GRAD_RTOL * raw + ADAM_GRAD_FLOOR,
                           f"step {t} gradient {n}")
            step_grads[n], step_deltas[n] = want[n], np.abs(got - want[n])
        grads.append(step_grads)
        deltas.append(step_deltas)
        moments.append({n: (mu[n], nu[n]) for n in named})
        before_jax = _named(states[t].params)
    assert trainer.step == STEPS
    np.testing.assert_allclose(got_losses, losses, rtol=rtol, atol=atol)
    final = states[-1].replace(opt_state=(states[-1].opt_state[0], states[-1].opt_state[1][1]))
    want_view = _jax_view("adam_wd_recorded", final, False)
    got_view = _view(trainer)
    assert got_view.keys() == want_view.keys()
    for n in named:
        per_step, dp = _adam_bounds([g[n] for g in grads], [d[n] for d in deltas],
                                    [m[n] for m in moments])
        dm, dv = per_step[-1]
        _assert_within(got_view[n], want_view[n], rtol, atol, dp, n)
        _assert_within(got_view[f"mu:{n}"], want_view[f"mu:{n}"], rtol, atol, dm, f"mu:{n}")
        _assert_within(got_view[f"nu:{n}"], want_view[f"nu:{n}"], rtol, atol, dv, f"nu:{n}")


def test_weight_decay_state_carries_across():
    """The JAX run's chained state ``(EmptyState(), adam)`` after two steps,
    carried into the port, which takes the last two: it ends where the JAX
    run ends."""
    _, states, losses = _jax_run("adam_wd")
    mid = states[1]
    assert type(mid.opt_state[0]).__name__ == "EmptyState"
    trainer = load_jax_opt_state(_port_trainer("adam_wd", mid.params, False), mid.opt_state)
    assert trainer.step == 2 and isinstance(trainer.optimizer, DecayedWeights)
    got = _multi_step(trainer, _batches()[2:])
    np.testing.assert_allclose(got.numpy(), losses[2:], rtol=F32_RTOL, atol=F32_ATOL)
    _assert_views(_view(trainer), _jax_view("adam_wd", states[-1], False), F32_RTOL, F32_ATOL)


def test_weight_decay_changes_the_step():
    params, _, _ = _jax_run("adagrad")
    runs = []
    for wd in (0.0, 0.5):
        trainer = Trainer(_port_dien(params), Adagrad(LR), device="cpu", weight_decay=wd)
        _multi_step(trainer, _batches()[:1])
        runs.append(trainer.model.deep.dense_0.weight.detach().clone())
    assert not torch.allclose(*runs, rtol=1e-6, atol=1e-7)


class _RecordingAdagrad(FusedAdagrad):
    def apply(self, table, slots, lids, ct, *, presorted=None, **kw):
        self.calls.append((lids.shape[0], presorted is None))
        super().apply(table, slots, lids, ct, presorted=presorted, **kw)


def test_dien_fused_step_feeds_one_stream():
    """DIEN looks up table_d8 at three sites: the [B, 2] user and item
    group, the [B, T] history and the [B, T] sampled history; the fused step
    sends them as one stream."""
    params, _, _ = _jax_run("adagrad")
    opt = _RecordingAdagrad(LR)
    object.__setattr__(opt, "calls", [])
    trainer = Trainer(_port_dien(params), Adagrad(LR), fused_embedding=opt, device="cpu")
    X, y = _batch(10)
    trainer.train_step(_torch(X), torch.from_numpy(y))
    assert opt.calls == [(B * 2 + 2 * B * T, True)]


# ------------------------------------------------------ predict and serve

def test_predict_and_evaluate_take_the_logits_of_the_tuple():
    params, _, _ = _jax_run("adagrad")
    jtrainer = JTrainer(_jdien(), optimizer=optax.adagrad(LR))
    trainer = _port_trainer("adagrad", params, False)
    X, y = _batch(20, n=45)
    jstate = types.SimpleNamespace(params=params, batch_stats={})
    want = jtrainer.predict(jstate, X, batch_size=16)
    got = trainer.predict(X, batch_size=16)
    assert got.shape == want.shape == (45, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for streaming in (False, True):
        want_m = jtrainer.evaluate(jstate, X, y, batch_size=16, streaming=streaming)
        got_m = trainer.evaluate(X, y, batch_size=16, streaming=streaming)
        assert got_m.keys() == want_m.keys() == {"auc", "logloss", "accuracy"}
        for key in want_m:
            np.testing.assert_allclose(got_m[key], want_m[key], rtol=1e-5, atol=1e-6)


def test_scorer_serves_dien_like_jax():
    params = _eval_params("negsampling")
    jscorer = JScorer(_jdien(), types.SimpleNamespace(params=params, batch_stats={}),
                      batch_size=16)
    scorer = Scorer(_port_dien(params), batch_size=16, device="cpu")
    X, _ = _batch(21, n=45)
    for n in (1, 20, 45):
        Xn = {k: v[:n] for k, v in X.items()}
        got, want = scorer(Xn), jscorer(Xn)
        assert got.shape == want.shape == (n, 1) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


class _TwoTasks(torch.nn.Module):
    """Two logits per row from a dense column, as a multi-task model
    returns them."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(1, 1)
        self.b = torch.nn.Linear(1, 1)
        with torch.no_grad():
            self.a.weight.fill_(2.0)
            self.a.bias.fill_(0.25)
            self.b.weight.fill_(-1.5)
            self.b.bias.fill_(-0.5)

    def forward(self, batch, generator=None):
        x = batch["price"]
        return [self.a(x), self.b(x)]


def test_multi_task_outputs_in_predict_evaluate_and_the_step():
    rng = np.random.default_rng(5)
    X = {"price": rng.normal(size=(40, 1)).astype(np.float32)}
    y = np.stack([(X["price"][:, 0] > 0), rng.integers(0, 2, 40)], axis=1).astype(np.float32)
    trainer = Trainer(_TwoTasks(), Adagrad(LR), device="cpu")
    probs = trainer.predict(X, batch_size=16)
    assert probs.shape == (40, 2)
    metrics = trainer.evaluate(X, y, batch_size=16)
    assert set(metrics) == {"task0_auc", "task0_logloss", "task1_auc", "task1_logloss"}
    assert metrics["task0_auc"] == 1.0
    from recommender_system_tpu_torch.utils import metrics as metrics_lib
    np.testing.assert_allclose(metrics["task1_logloss"], metrics_lib.logloss(y[:, 1], probs[:, 1]))
    with torch.no_grad():
        logits = [t.numpy() for t in _TwoTasks()({"price": torch.from_numpy(X["price"])})]
    want = np.mean([float(j_bce_with_logits(jnp.asarray(logit), jnp.asarray(y[:, t])))
                    for t, logit in enumerate(logits)])
    loss = trainer.train_step({"price": torch.from_numpy(X["price"])}, torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)


# --------------------------------------------------- the attention's remat

@pytest.mark.parametrize("return_scores", [False, True], ids=["pooled", "scores"])
def test_din_attention_remat_gradients_match_jax(return_scores):
    rng = np.random.default_rng(6)
    Bq, Tq, Kq, H1, H2 = 16, 5, 8, 10, 5
    q = rng.normal(size=(Bq, Kq)).astype(np.float32)
    keys = rng.normal(size=(Bq, Tq, Kq)).astype(np.float32)
    lengths = rng.integers(0, Tq + 1, Bq)
    mask = np.arange(Tq)[None, :] < lengths[:, None]
    weights = [(rng.normal(size=s) * 0.3).astype(np.float32) for s in
               ((4 * Kq, H1), (H1,), (H1, H2), (H2,), (H2, 1), (1,))]
    cot = rng.normal(size=(Bq, Tq if return_scores else Kq)).astype(np.float32)

    def jloss(q, keys, *w):
        out = j_din_attention_remat(q, keys, jnp.asarray(mask), *w, "sigmoid", True,
                                    return_scores, None)
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=tuple(range(8)))(q, keys, *weights)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, keys, *weights)]
    out = din_attention(args[0], args[1], torch.from_numpy(mask), *args[2:],
                        return_scores=return_scores, remat=True)
    got = torch.autograd.grad(out, args, torch.from_numpy(cot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)
