"""The port's retrieval path against the JAX package's: ``inbatch_softmax_loss``
(with and without the log-Q correction, with duplicate ids; value and
gradients), ``sampled_softmax_loss`` on the JAX package's own draws (uniform,
frequency with distortion, adaptive after ``update_adaptive_counts``) and the
port's draws against their proposal (chi-square), DSSM's forward and towers
on transplanted weights, ``EmbeddingCollection(columns=...)`` and its sorted
stream, K=4 fused and plain DSSM steps against the JAX *plain* Trainer, the
JAX fused Trainer's fault on DSSM, ``RetrievalIndex.query`` and
``recall_at_n``."""
import functools

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp
import optax

from recommender_system_tpu.layers.embedding import EmbeddingCollection as JCollection
from recommender_system_tpu.models import DSSM as JDSSM
from recommender_system_tpu.serving import RetrievalIndex as JRetrievalIndex
from recommender_system_tpu.training import FusedAdagrad as JFusedAdagrad
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.training import losses as jlosses
from recommender_system_tpu.utils import features as jfeatures
from recommender_system_tpu.utils.metrics import recall_at_n as j_recall_at_n
from recommender_system_tpu_torch import DSSM, FusedAdagrad, RetrievalIndex, Trainer
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params
from recommender_system_tpu_torch.layers.embedding import EmbeddingCollection
from recommender_system_tpu_torch.ops import embedding_grad
from recommender_system_tpu_torch.ops.stream_sort import blocked_sort, sort_ids
from recommender_system_tpu_torch.training import Adagrad
from recommender_system_tpu_torch.training import losses
from recommender_system_tpu_torch.utils import features as tfeatures
from recommender_system_tpu_torch.utils.metrics import recall_at_n

LR, TEMPERATURE = 0.05, 0.05
# f32 forward on both sides; sums (norms, matmuls) taken in another order
ATOL = 1e-5
# losses and their gradients: f32 on both sides, a [B, B] softmax
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-6
# training: f32 on both sides over K chained steps
F32_RTOL, F32_ATOL = 1e-4, 1e-6

USERS, ITEMS, T, DIM = 40, 70, 6, 8
B, STEPS = 32, 4
HIDDEN = (16, 8)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _columns(mod):
    """``benchmarks/model_step.py``'s DSSM columns at a small size: the user
    tower's ``user_id`` and mean-pooled history, the item tower's
    ``item_id``, the history on the item table."""
    user = (mod.SparseFeat("user_id", USERS, DIM),
            mod.VarLenSparseFeat(mod.SparseFeat("hist_item_id", ITEMS, DIM,
                                                embedding_name="item_id"), maxlen=T))
    item = (mod.SparseFeat("item_id", ITEMS, DIM, embedding_name="item_id"),)
    return user, item


def _batch(seed, n=B):
    """As ``model_step.py`` builds a DSSM batch (lengths from 1, padding id
    0), with a few repeated items, so that the in-batch mask has work."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=n)
    hist = rng.integers(1, ITEMS, size=(n, T)).astype(np.int32)
    hist[np.arange(T)[None, :] >= lengths[:, None]] = 0
    item = rng.integers(1, ITEMS, size=n).astype(np.int32)
    item[1::7] = item[0]
    return {"user_id": rng.integers(1, USERS, size=n).astype(np.int32),
            "hist_item_id": hist, "item_id": item}


def _torch(X):
    return {k: torch.from_numpy(v) for k, v in X.items()}


def _jdssm(**kw):
    return JDSSM(*_columns(jfeatures), user_hidden_units=HIDDEN, item_hidden_units=HIDDEN,
                 **kw)


def _port_dssm(params, **kw):
    model = DSSM(*_columns(tfeatures), user_hidden_units=HIDDEN, item_hidden_units=HIDDEN,
                 device="cpu", generator=_gen(), **kw)
    return load_jax_params(model, params)


@functools.lru_cache(maxsize=None)
def _params():
    """Every parameter redrawn, the table at a std that gives the towers'
    inputs a say."""
    rng = np.random.default_rng(9)
    params = _jdssm().init(jax.random.PRNGKey(0), _batch(0))["params"]
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.3, np.shape(a)).astype(np.float32), params)


def _loss(outputs, labels, batch):
    u, v = outputs
    if isinstance(u, torch.Tensor):
        return losses.inbatch_softmax_loss(u, v, batch["item_id"], temperature=TEMPERATURE)
    return jlosses.inbatch_softmax_loss(u, v, batch["item_id"], temperature=TEMPERATURE)


# ------------------------------------------------------------ the losses

def _embeddings(seed, n=B, d=DIM, normalize=True):
    rng = np.random.default_rng(seed)
    u, v = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(2))
    if normalize:
        u, v = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (u, v))
    return u, v


INBATCH = {"plain": (False, False), "log_q": (True, False), "duplicates": (False, True),
           "log_q_duplicates": (True, True)}


@pytest.mark.parametrize("case", sorted(INBATCH))
def test_inbatch_softmax_loss_matches_jax(case):
    with_probs, duplicates = INBATCH[case]
    u, v = _embeddings(1)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, ITEMS, B).astype(np.int32)
    if duplicates:
        ids[3::5] = ids[0]
    else:
        ids = rng.permutation(np.arange(1, ITEMS))[:B].astype(np.int32)
    probs = rng.dirichlet(np.ones(ITEMS)).astype(np.float32) if with_probs else None

    def jloss(u, v):
        return jlosses.inbatch_softmax_loss(
            u, v, jnp.asarray(ids), None if probs is None else jnp.asarray(probs),
            temperature=TEMPERATURE)

    want, want_grads = jax.value_and_grad(jloss, argnums=(0, 1))(u, v)
    tu, tv = (torch.from_numpy(x).requires_grad_(True) for x in (u, v))
    got = losses.inbatch_softmax_loss(tu, tv, torch.from_numpy(ids),
                                      None if probs is None else torch.from_numpy(probs),
                                      temperature=TEMPERATURE)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    for g, w in zip((tu.grad, tv.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LOSS_RTOL, atol=GRAD_ATOL)
    assert float(want) > 0.1


def test_inbatch_softmax_masks_a_rows_other_copies():
    """A duplicate of row i's item elsewhere in the batch does not count
    against row i: with every row on one item and one vector, the loss is
    0."""
    u = torch.nn.functional.normalize(torch.randn(8, DIM, generator=_gen()), dim=-1)
    ids = torch.full((8,), 3)
    assert float(losses.inbatch_softmax_loss(u, u.clone(), ids)) == pytest.approx(0.0, abs=1e-6)


def _table(seed, n_items=ITEMS):
    return np.random.default_rng(seed).normal(0.0, 0.5, (n_items, DIM)).astype(np.float32)


def _samplers():
    rng = np.random.default_rng(3)
    freq = rng.zipf(1.5, ITEMS).astype(np.float64)
    return {
        "uniform": jlosses.NegativeSampler("uniform", num_sampled=17),
        "frequency": jlosses.NegativeSampler("frequency", num_sampled=17, item_probs=freq,
                                             distortion=0.75),
        "adaptive": jlosses.NegativeSampler("adaptive", num_sampled=17, distortion=0.5),
    }


def _port_sampler(jsampler):
    return losses.NegativeSampler(jsampler.sampler, jsampler.num_sampled, jsampler.item_probs,
                                  jsampler.distortion)


def _jax_draws(jsampler, key, counts):
    """The negatives ``jlosses.sampled_softmax_loss`` draws with ``key``:
    the same calls on the same key."""
    if jsampler.sampler == "uniform":
        return np.asarray(jax.random.randint(key, (jsampler.num_sampled,), 1, ITEMS))
    base = counts if jsampler.sampler == "adaptive" else jnp.asarray(jsampler.item_probs)
    p = base ** jsampler.distortion
    p = p / jnp.sum(p)
    return np.asarray(jax.random.categorical(key, jnp.log(jnp.clip(p, 1e-12, None)),
                                             shape=(jsampler.num_sampled,)))


@pytest.mark.parametrize("kind", ["uniform", "frequency", "adaptive"])
def test_sampled_softmax_matches_jax_on_its_draws(kind):
    jsampler = _samplers()[kind]
    u, _ = _embeddings(4)
    table = _table(5)
    pos = np.random.default_rng(6).integers(1, ITEMS, B).astype(np.int32)
    key = jax.random.PRNGKey(7)
    jcounts = tcounts = None
    if kind == "adaptive":
        jcounts = jlosses.init_adaptive_counts(ITEMS)
        tcounts = losses.init_adaptive_counts(ITEMS, device="cpu")
        for seed in (8, 9):
            seen = np.random.default_rng(seed).integers(0, 10, (B, 2)).astype(np.int32)
            jcounts = jlosses.update_adaptive_counts(jcounts, jnp.asarray(seen))
            before = tcounts.clone()
            updated = losses.update_adaptive_counts(tcounts, torch.from_numpy(seen))
            assert torch.equal(tcounts, before)  # functional: a new tensor
            tcounts = updated
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))

    def jloss(u, table):
        return jlosses.sampled_softmax_loss(u, table, jnp.asarray(pos), jsampler, key,
                                            temperature=TEMPERATURE, adaptive_counts=jcounts)

    want, want_grads = jax.value_and_grad(jloss, argnums=(0, 1))(u, table)
    neg = torch.from_numpy(np.array(_jax_draws(jsampler, key, jcounts)))
    p = losses._proposal(_port_sampler(jsampler), tcounts)
    tu, tt = (torch.from_numpy(x).requires_grad_(True) for x in (u, table))
    tpos = torch.from_numpy(pos)
    got = losses._sampled_softmax_given(tu, tt, tpos, neg, losses._log_q(p, ITEMS, tpos),
                                        losses._log_q(p, ITEMS, neg), temperature=TEMPERATURE)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    for g, w in zip((tu.grad, tt.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LOSS_RTOL, atol=GRAD_ATOL)
    if kind == "uniform":
        assert neg.min() >= 1


@pytest.mark.parametrize("kind", ["uniform", "frequency", "adaptive"])
def test_port_draws_follow_the_proposal(kind):
    """Chi-square of 200,000 of the port's draws against the proposal
    (uniform on ``[1, n_items)``), at a 1e-4 false-alarm rate."""
    sampler = _port_sampler(_samplers()[kind])
    counts = None
    if kind == "adaptive":
        seen = torch.from_numpy(np.random.default_rng(10).integers(0, 12, 400))
        counts = losses.update_adaptive_counts(losses.init_adaptive_counts(ITEMS, device="cpu"),
                                               seen)
    p = losses._proposal(sampler, counts)
    n = 200_000
    draws = losses._draw_negatives(p, ITEMS, n, _gen(11))
    assert draws.shape == (n,) and draws.dtype == torch.int64
    observed = np.bincount(draws.numpy(), minlength=ITEMS).astype(np.float64)
    if p is None:
        assert observed[0] == 0
        expected = np.full(ITEMS - 1, n / (ITEMS - 1))
        observed = observed[1:]
    else:
        expected = p.double().numpy() * n
    stat = float(((observed - expected) ** 2 / expected).sum())
    assert stat < stats.chi2.ppf(1 - 1e-4, len(expected) - 1), stat
    # and the port's own loss runs on its own draws
    u = torch.from_numpy(_embeddings(12)[0])
    pos = torch.from_numpy(np.random.default_rng(13).integers(1, ITEMS, B))
    loss = losses.sampled_softmax_loss(u, torch.from_numpy(_table(14)), pos, sampler,
                                       _gen(15), adaptive_counts=counts)
    assert torch.isfinite(loss) and float(loss) > 0


def test_frequency_proposal_is_made_once_a_device(monkeypatch):
    """The frequency proposal is copied from the host at its first use and
    kept: the second call returns the same storage and copies nothing (a
    captured step on a card draws from it), and the loss on it still
    matches JAX's on its draws."""
    jsampler = _samplers()["frequency"]
    sampler = _port_sampler(jsampler)
    first = losses._proposal(sampler, device="cpu")

    def copy_from_host(*args, **kwargs):
        raise AssertionError("item_probs copied from the host again")

    monkeypatch.setattr(losses.torch, "as_tensor", copy_from_host)
    p = losses._proposal(sampler, device=torch.device("cpu"))
    assert p is first and p.data_ptr() == first.data_ptr()
    assert losses._proposal(sampler) is first
    u, _ = _embeddings(4)
    table = _table(5)
    pos = np.random.default_rng(6).integers(1, ITEMS, B).astype(np.int32)
    key = jax.random.PRNGKey(7)
    want = jlosses.sampled_softmax_loss(u, table, jnp.asarray(pos), jsampler, key,
                                        temperature=TEMPERATURE)
    neg = torch.from_numpy(np.array(_jax_draws(jsampler, key, None)))
    tpos = torch.from_numpy(pos)
    got = losses._sampled_softmax_given(torch.from_numpy(u), torch.from_numpy(table), tpos, neg,
                                        losses._log_q(p, ITEMS, tpos),
                                        losses._log_q(p, ITEMS, neg), temperature=TEMPERATURE)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_adaptive_sampling_needs_counts():
    jsampler = _samplers()["adaptive"]
    u, _ = _embeddings(16)
    pos = np.arange(1, B + 1) % ITEMS
    with pytest.raises(ValueError, match="adaptive sampling needs adaptive_counts"):
        jlosses.sampled_softmax_loss(u, _table(17), jnp.asarray(pos), jsampler,
                                     jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="adaptive sampling needs adaptive_counts"):
        losses.sampled_softmax_loss(torch.from_numpy(u), torch.from_numpy(_table(17)),
                                    torch.from_numpy(pos), _port_sampler(jsampler), _gen())


def test_sampled_softmax_draws_on_the_tables_device():
    """A generator on another device than the item table raises before any
    draw (the uniform corrections would land on the generator's device)."""
    pos = torch.arange(1, B + 1) % ITEMS
    table = torch.empty(ITEMS, DIM, device="meta")
    u = torch.empty(B, DIM, device="meta")
    for kind in ("uniform", "frequency"):
        with pytest.raises(ValueError, match="draw on the table's device"):
            losses.sampled_softmax_loss(u, table, pos, _port_sampler(_samplers()[kind]), _gen())
    assert losses._same_device(torch.device("cuda"), torch.device("cuda:0"))
    assert not losses._same_device(torch.device("cuda:1"), torch.device("cuda:0"))
    assert not losses._same_device(torch.device("cpu"), torch.device("cuda:0"))


# ------------------------------------------------------------ the model

def test_dssm_towers_match_jax():
    params = _params()
    X = _batch(1)
    jmodel = _jdssm()
    want_u, want_v = jmodel.apply({"params": params}, X)
    want_user = jmodel.apply({"params": params}, X, method=jmodel.user_embedding)
    want_item = jmodel.apply({"params": params}, X, method=jmodel.item_embedding)
    model = _port_dssm(params).eval()
    with torch.inference_mode():
        u, v = model(_torch(X))
        user, item = model.user_embedding(_torch(X)), model.item_embedding(_torch(X))
    assert u.shape == v.shape == (B, HIDDEN[-1])
    for got, want in ((u, want_u), (v, want_v), (user, want_user), (item, want_item)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(u, dim=-1).numpy(), 1.0, atol=1e-6)
    assert np.std(np.asarray(want_u)) > 0.1


def test_dssm_unnormalised_matches_jax():
    params = _params()
    X = _batch(2)
    want_u, want_v = _jdssm(embedding_l2_normalize=False).apply({"params": params}, X)
    with torch.inference_mode():
        u, v = _port_dssm(params, embedding_l2_normalize=False).eval()(_torch(X))
    np.testing.assert_allclose(u.numpy(), np.asarray(want_u), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=1e-5, atol=ATOL)


def test_dssm_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        DSSM(*_columns(tfeatures), generator=_gen())


def _collection_columns(mod):
    """Three columns of dim 4 on three tables, and a varlen column sharing
    the second's table."""
    return (mod.SparseFeat("a", 30, 4), mod.SparseFeat("b", 25, 4),
            mod.SparseFeat("c", 20, 4),
            mod.VarLenSparseFeat(mod.SparseFeat("hb", 25, 4, embedding_name="b"), maxlen=5))


SUBSETS = {"a": ("a",), "c_b": ("c", "b"), "b_hb": ("b", "hb"), "all": ("a", "b", "c", "hb")}


@pytest.mark.parametrize("subset", sorted(SUBSETS))
def test_collection_columns_match_jax(subset):
    jcols, tcols = _collection_columns(jfeatures), _collection_columns(tfeatures)
    pick = SUBSETS[subset]
    rng = np.random.default_rng(18)
    X = {"a": rng.integers(0, 30, 16), "b": rng.integers(0, 25, 16),
         "c": rng.integers(0, 20, 16), "hb": rng.integers(0, 25, (16, 5))}
    X = {k: v.astype(np.int32) for k, v in X.items()}
    X["hb"][:, 3:] = 0
    jcoll = JCollection(jcols)
    jsub = tuple(c for c in jcols if c.name in pick)
    variables = jcoll.init(jax.random.PRNGKey(0), X)
    variables = jax.tree_util.tree_map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32), variables)
    want = jcoll.apply(variables, X, columns=jsub)
    coll = EmbeddingCollection(tcols, device=torch.device("cpu"), generator=_gen())
    load_jax_params(coll, variables["params"])
    got = coll(_torch(X), columns=tuple(c for c in tcols if c.name in pick))
    assert list(got.sparse) == list(want.sparse)
    assert list(got.pooled) == list(want.pooled)
    for name in want.sparse:
        np.testing.assert_array_equal(got.sparse[name].detach().numpy(),
                                      np.asarray(want.sparse[name]))
    for name in want.pooled:
        np.testing.assert_allclose(got.pooled[name].detach().numpy(),
                                   np.asarray(want.pooled[name]), rtol=1e-6, atol=1e-6)
    assert {d: names for d, (names, _) in got.fused.items()} == \
        {d: names for d, (names, _) in want.fused.items()}


def test_column_subset_takes_the_generic_sort():
    """A column subset that is not the whole dim group carries no sort
    layout: its ``[B, F']`` rows take the generic stable sort, whose stream
    equals a ``blocked_sort`` of the subset's own table ranges. The whole
    group keeps its layout."""
    coll = EmbeddingCollection(_collection_columns(tfeatures), device=torch.device("cpu"),
                               generator=_gen())
    fcs = {fc.name: fc for fc in coll._by_dim[4]}
    rng = np.random.default_rng(19)
    X = _torch({"a": rng.integers(0, 30, 64), "b": rng.integers(0, 25, 64),
                "c": rng.integers(0, 20, 64)})
    for names, ranges in ((("b",), [(30, 25)]), (("c", "a"), [(55, 20), (0, 30)])):
        coll.capture = []
        coll(X, columns=[fcs[n] for n in names])
        (site,) = coll.capture
        assert site.layout is None and site.presorted() is None
        slid, order = sort_ids(site.rows2d.reshape(-1))
        for got, want in zip((slid, order), blocked_sort(site.rows2d, ranges)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    coll.capture = []
    coll(X, columns=list(fcs.values()))
    assert coll.capture[0].layout is coll._layout(4)
    coll.capture = None
    assert set(coll.state_dict()) == {"table_d4"}


def test_plain_step_sorts_each_site():
    """DSSM's plain step: one scatter-add per lookup site (the user group,
    the history, the item group), each stream from the generic sort."""
    calls = []
    original = embedding_grad.scatter_add_sorted

    def recording(slid, order, ct, num_rows):
        calls.append((slid.numel(), ct.shape))
        return original(slid, order, ct, num_rows)

    trainer = Trainer(_port_dssm(_params()), Adagrad(LR), loss_fn=_loss, device="cpu")
    X = _torch(_batch(20))
    try:
        embedding_grad.scatter_add_sorted = recording
        trainer.train_step(X, torch.zeros(B))
    finally:
        embedding_grad.scatter_add_sorted = original
    assert sorted(n for n, _ in calls) == [B, B, B * T]


# ------------------------------------------------------------ training

def _batches():
    return [(_batch(30 + i), np.zeros(B, np.float32)) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_run(fused):
    """STEPS steps of the JAX Trainer (optax.adagrad; its fused Adagrad
    with ``fused``) from the redrawn parameters."""
    trainer = JTrainer(_jdssm(), optimizer=optax.adagrad(LR), loss_fn=_loss,
                       fused_embedding=JFusedAdagrad(LR) if fused else None)
    batches = _batches()
    state = trainer.init(batches[0][0]).replace(params=_params())
    step = trainer._make_train_step()
    losses_, states = [], []
    for X, y in batches:
        state, loss = step(state, X, y)
        losses_.append(float(loss))
        states.append(jax.tree_util.tree_map(np.asarray, state))
    return states, np.asarray(losses_)


def _port_trainer(params, fused):
    return Trainer(_port_dssm(params), Adagrad(LR), loss_fn=_loss, device="cpu",
                   fused_embedding=FusedAdagrad(LR) if fused else None)


def _view(trainer):
    """Parameters and optimizer state by name, the fused slot under the
    name the dense Adagrad gives a table's accumulator."""
    out = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}
    for n, slots in trainer.opt_state.items():
        out.update({f"{k}:{n}": v.numpy().copy() for k, v in slots.items()})
    for n, (acc,) in trainer.fused_slots.items():
        out[f"sum_of_squares:{n}"] = acc.numpy().copy()
    return out


def _multi_step(trainer, batches):
    stacked = {k: torch.from_numpy(np.stack([X[k] for X, _ in batches])) for k in batches[0][0]}
    return trainer.multi_step(stacked, torch.from_numpy(np.stack([y for _, y in batches])))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_dssm_training_matches_jax_plain_trainer(fused):
    """The port's fused and plain steps against the JAX package's plain
    Trainer (dense optax Adagrad), never its fused one (see
    ``test_jax_fused_trainer_drops_the_user_towers_rows``)."""
    states, want_losses = _jax_run(False)
    trainer = _port_trainer(_params(), fused)
    got = _multi_step(trainer, _batches())
    assert trainer.step == STEPS
    np.testing.assert_allclose(got.numpy(), want_losses, rtol=F32_RTOL, atol=F32_ATOL)
    want = _view(load_jax_opt_state(_port_trainer(states[-1].params, False),
                                    states[-1].opt_state, step=int(states[-1].step)))
    got_view = _view(trainer)
    assert got_view.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got_view[name], want[name], rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=name)
    assert want_losses[-1] < want_losses[0]


def test_jax_fused_trainer_drops_the_user_towers_rows():
    """The JAX package's fused DSSM step: both towers' lookups sow their
    single-valued group as ``grad_d{dim}_sparse``, so the item tower's rows
    replace the user tower's and the perturbation sums both towers'
    cotangents. No touched ``user_id`` row moves, where the dense step and
    the port's fused step move every one."""
    X, y = _batches()[0]
    (jfused,), _ = _jax_run_one(True)
    (jdense,), _ = _jax_run_one(False)
    start = _port_dssm(_params()).embeddings.table_d8.detach().numpy()
    users = np.unique(X["user_id"])

    def moved(table):
        return int((np.abs(table[users] - start[users]).max(axis=1) > 0).sum())

    def table_of(state):
        return _port_dssm(state.params).embeddings.table_d8.detach().numpy()

    trainer = _port_trainer(_params(), True)
    _multi_step(trainer, [(X, y)])
    assert moved(table_of(jfused)) == 0
    assert moved(table_of(jdense)) == len(users)
    assert moved(trainer.model.embeddings.table_d8.detach().numpy()) == len(users)


def _jax_run_one(fused):
    trainer = JTrainer(_jdssm(), optimizer=optax.adagrad(LR), loss_fn=_loss,
                       fused_embedding=JFusedAdagrad(LR) if fused else None)
    X, y = _batches()[0]
    state = trainer.init(X).replace(params=_params())
    state, loss = trainer._make_train_step()(state, X, y)
    return (state,), float(loss)


class _RecordingAdagrad(FusedAdagrad):
    def apply(self, table, slots, lids, ct, *, presorted=None, **kw):
        self.calls.append((lids.shape[0], presorted is None))
        super().apply(table, slots, lids, ct, presorted=presorted, **kw)


def test_dssm_fused_step_feeds_one_stream():
    """Two calls of one collection, three lookup sites of table_d8 (the
    user group, the history, the item group): one stream a step."""
    opt = _RecordingAdagrad(LR)
    object.__setattr__(opt, "calls", [])
    trainer = Trainer(_port_dssm(_params()), Adagrad(LR), fused_embedding=opt, loss_fn=_loss,
                      device="cpu")
    trainer.train_step(_torch(_batch(21)), torch.zeros(B))
    assert opt.calls == [(B + B * T + B, True)]


# ------------------------------------------------------------ retrieval

def _catalog():
    return {"item_id": np.arange(1, ITEMS, dtype=np.int32)}


def _assert_same_topk(got_ids, got_scores, want_ids, want_scores, atol):
    """Scores equal within ``atol``; ids equal wherever the score is apart
    from its neighbours' by more than ``atol`` (a tie may come in either
    order)."""
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=atol)
    gaps = np.diff(want_scores, axis=-1)
    apart = np.ones(want_scores.shape, bool)
    apart[:, 1:] &= np.abs(gaps) > atol
    apart[:, :-1] &= np.abs(gaps) > atol
    np.testing.assert_array_equal(got_ids[apart], want_ids[apart])


def test_retrieval_index_matches_jax():
    params = _params()
    jstate = JTrainer(_jdssm()).init(_batch(0)).replace(params=params)
    jindex = JRetrievalIndex(_jdssm(), jstate, _catalog())
    index = RetrievalIndex(_port_dssm(params), _catalog(), device="cpu")
    assert index.item_embeddings.shape == (ITEMS - 1, HIDDEN[-1])
    X = _batch(22, n=24)
    users = {k: X[k] for k in ("user_id", "hist_item_id")}
    for k in (1, 10):
        want_ids, want_scores = jindex.query(users, k=k)
        got_ids, got_scores = index.query(users, k=k)
        assert got_ids.shape == got_scores.shape == (24, k)
        assert got_ids.dtype == want_ids.dtype and got_scores.dtype == np.float32
        _assert_same_topk(got_ids, got_scores, want_ids, np.asarray(want_scores), ATOL)
        assert (np.diff(got_scores, axis=-1) <= 0).all()
    truth = X["item_id"]
    np.testing.assert_equal(recall_at_n(got_ids, truth), j_recall_at_n(want_ids, truth))


def test_recall_at_n_bit_exact():
    rng = np.random.default_rng(23)
    preds = rng.integers(0, 30, (200, 10))
    truth = rng.integers(0, 30, 200)
    assert recall_at_n(preds, truth) == j_recall_at_n(preds, truth)
    assert recall_at_n([[1, 2], [3, 4], [5, 6]], [2, 9, 5]) == 2 / 3
    assert recall_at_n([], []) == j_recall_at_n([], []) == 0.0


def test_retrieval_index_needs_the_model_on_its_device(monkeypatch):
    model = _port_dssm(_params())
    with pytest.raises(ValueError, match="RetrievalIndex serves on meta"):
        RetrievalIndex(model, _catalog(), device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        RetrievalIndex(model, _catalog())
