"""The port's DIN path against the JAX package's: the sequence ops
(``ops/seqpool.py``), the varlen lookup, Flax-exact BatchNorm and Dice in
train mode, ``synthetic_behavior``, the DIN forward on transplanted
``params`` and ``batch_stats``, ``Scorer`` on DIN requests, two training
steps (fused and plain, BatchNorm statistics included) and the two-site
sparse update against the JAX package's split-stream kernel."""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from recommender_system_tpu.layers.embedding import EmbeddingCollection as JEmbeddingCollection
from recommender_system_tpu.layers.embedding import UnifiedEmbedding as JUnifiedEmbedding
from recommender_system_tpu.layers.embedding import unpack_stack as j_unpack_stack
from recommender_system_tpu.models import DIN as JDIN
from recommender_system_tpu.ops import seqpool as jseqpool
from recommender_system_tpu.ops.fused_adagrad import fused_adagrad_apply as j_fused_adagrad_apply
from recommender_system_tpu.serving import Scorer as JScorer
from recommender_system_tpu.training import FusedAdagrad as JFusedAdagrad
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.utils import datasets as jdatasets
from recommender_system_tpu.utils import features as jfeatures
from recommender_system_tpu_torch import DIN, FusedAdagrad, Scorer, Trainer
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params, unpack_stack
from recommender_system_tpu_torch.layers.core import BatchNorm
from recommender_system_tpu_torch.layers.embedding import EmbeddingCollection, UnifiedEmbedding
from recommender_system_tpu_torch.ops import seqpool
from recommender_system_tpu_torch.ops.fused_adagrad import fused_adagrad_apply
from recommender_system_tpu_torch.training import Adagrad
from recommender_system_tpu_torch.utils import datasets as tdatasets
from recommender_system_tpu_torch.utils import features as tfeatures

LR, EPS = 0.05, 1e-7
ATOL = 1e-5  # f32 forward on both sides; dots summed in another order
# training: f32 on both sides over chained steps; the JAX fused kernel
# rounds every cotangent to bf16 (2**-9 relative) before it sums a row
F32_RTOL, F32_ATOL = 1e-4, 1e-6
BF16_RTOL, BF16_ATOL = 1e-2, 2e-4
# the sparse update against the Pallas kernel: the same bf16-rounded
# cotangents summed in f32, in another order
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6


def _gen():
    return torch.Generator().manual_seed(0)


def _redraw(tree, rng, std=0.3):
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, std, np.shape(a)).astype(np.float32), tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat_stats(tree, prefix=()):
    """Flax ``batch_stats`` -> {port buffer name: array}."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat_stats(v, prefix + (k,)))
        else:
            name = {"mean": "running_mean", "var": "running_var"}[k]
            out[".".join(prefix + (name,))] = np.asarray(v)
    return out


def _stats(module):
    return {n: b.detach().numpy().copy() for n, b in module.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


# ------------------------------------------------------------ seqpool

def _seq(seed=0, B=16, T=6, k=4):
    rng = np.random.default_rng(seed)
    seq = rng.normal(size=(B, T, k)).astype(np.float32)
    lengths = rng.integers(0, T + 1, B).astype(np.int32)
    lengths[0] = 0
    weights = rng.normal(size=(B, T)).astype(np.float32)
    return seq, lengths, weights


SEQ_OPS = {
    "sum": lambda m, s, lengths, w, T: m.sequence_pooling(s, m.length_mask(lengths, T), "sum"),
    "mean": lambda m, s, lengths, w, T: m.sequence_pooling(s, m.length_mask(lengths, T), "mean"),
    "max": lambda m, s, lengths, w, T: m.sequence_pooling(s, m.length_mask(lengths, T), "max"),
    "weighted_norm": lambda m, s, lengths, w, T: m.weighted_sequence(
        s, w, m.length_mask(lengths, T), normalize=True),
    "weighted_raw": lambda m, s, lengths, w, T: m.weighted_sequence(
        s, w, m.length_mask(lengths, T), normalize=False),
    "masked_softmax": lambda m, s, lengths, w, T: m.masked_softmax(w, m.length_mask(lengths, T)),
    "id_mask": lambda m, s, lengths, w, T: m.id_mask(lengths),
}


@pytest.mark.parametrize("op", sorted(SEQ_OPS))
def test_seqpool_matches_jax(op):
    seq, lengths, weights = _seq()
    T = seq.shape[1]
    want = np.asarray(SEQ_OPS[op](jseqpool, jnp.asarray(seq), jnp.asarray(lengths),
                                  jnp.asarray(weights), T))
    got = SEQ_OPS[op](seqpool, torch.from_numpy(seq), torch.from_numpy(lengths),
                      torch.from_numpy(weights), T).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert seqpool.NEG_INF == jseqpool.NEG_INF


def test_synthetic_behavior_bit_exact():
    kw = dict(n_rows=97, n_items=60, n_users=30, seq_len=7, embedding_dim=4, seed=3)
    jcols, jX, jy = jdatasets.synthetic_behavior(**kw)
    tcols, tX, ty = tdatasets.synthetic_behavior(**kw)
    assert [dataclasses.asdict(c) for c in jcols] == [dataclasses.asdict(c) for c in tcols]
    assert list(jX) == list(tX)
    for k in jX:
        assert jX[k].dtype == tX[k].dtype
        np.testing.assert_array_equal(jX[k], tX[k])
    np.testing.assert_array_equal(jy, ty)


# ------------------------------------------------------------ varlen lookup

VARLEN_CASES = {
    "id_mask_mean": dict(),
    "length_sum": dict(length_name="hist_len", combiner="sum"),
    "weighted_norm_max": dict(length_name="hist_len", weight_name="hist_w",
                              combiner="max"),
    "weighted_raw_mean": dict(weight_name="hist_w", weight_norm=False),
    "hashed_frozen_own_table": dict(own=dict(use_hash=True, trainable=False)),
    "mixed_dims": dict(own=dict(embedding_dim=4)),
}


def _varlen_schema(mod, case):
    kw = dict(VARLEN_CASES[case])
    own = kw.pop("own", None)
    if own is None:
        hist = mod.SparseFeat("hist_item", 50, 8, embedding_name="item")
    else:
        hist = mod.SparseFeat("hist_item", 40, own.get("embedding_dim", 8),
                              use_hash=own.get("use_hash", False),
                              trainable=own.get("trainable", True))
    return [mod.SparseFeat("user", 30, 8), mod.SparseFeat("item", 50, 8),
            mod.VarLenSparseFeat(hist, maxlen=5, **kw), mod.DenseFeat("d", 2)]


def _varlen_batch(n=24, T=5, seed=5):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, T + 1, n).astype(np.int32)
    hist = rng.integers(-2, 55, (n, T)).astype(np.int32)
    hist[np.arange(T)[None, :] >= lengths[:, None]] = 0
    return {"user": rng.integers(0, 30, n).astype(np.int32),
            "item": rng.integers(0, 50, n).astype(np.int32),
            "hist_item": hist, "hist_len": lengths,
            "hist_w": rng.normal(size=(n, T)).astype(np.float32),
            "d": rng.uniform(size=(n, 2)).astype(np.float32)}


@pytest.mark.parametrize("unified", [False, True], ids=["collection", "unified"])
@pytest.mark.parametrize("case", sorted(VARLEN_CASES))
def test_varlen_lookup_matches_jax(case, unified):
    X = _varlen_batch()
    rng = np.random.default_rng(6)
    jcls, tcls = ((JUnifiedEmbedding, UnifiedEmbedding) if unified
                  else (JEmbeddingCollection, EmbeddingCollection))
    jmodule = jcls(tuple(_varlen_schema(jfeatures, case)))
    params = _redraw(jmodule.init(jax.random.PRNGKey(0), X)["params"], rng)
    want = jmodule.apply({"params": params}, X)
    module = load_jax_params(tcls(_varlen_schema(tfeatures, case), device=torch.device("cpu"),
                                  generator=_gen()), params)
    got = module({k: torch.from_numpy(v) for k, v in X.items()})
    if unified:
        (want, want_linear), (got, got_linear) = want, got
        np.testing.assert_allclose(got_linear.detach().numpy(), np.asarray(want_linear),
                                   rtol=1e-6, atol=1e-6)
    for field in ("sparse", "varlen_raw", "varlen_mask", "pooled"):
        w, g = getattr(want, field), getattr(got, field)
        assert list(g) == list(w), field
        for name in w:
            np.testing.assert_allclose(g[name].detach().numpy(), np.asarray(w[name]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{field}/{name}")
    np.testing.assert_allclose(got.concat_flat().detach().numpy(),
                               np.asarray(want.concat_flat()), rtol=1e-6, atol=1e-6)
    if not unified:
        assert module.output_dim == want.concat_flat().shape[1]


def test_varlen_capture_records_one_site_per_lookup():
    cols = _varlen_schema(tfeatures, "id_mask_mean")
    module = EmbeddingCollection(cols, device=torch.device("cpu"), generator=_gen())
    X = {k: torch.from_numpy(v) for k, v in _varlen_batch().items()}
    module.capture = []
    out = module(X)
    (group, hist) = module.capture
    assert group.table == hist.table == "table_d8"
    assert tuple(group.embeds.shape) == (24, 2, 8) and group.presorted() is not None
    assert tuple(hist.embeds.shape) == (24, 5, 8) and hist.presorted() is None
    assert out.varlen_raw["hist_item"] is hist.embeds
    # the history reads the item table's rows
    assert bool((hist.rows >= 30).all()) and bool((hist.rows < 80).all())


# ------------------------------------------------- BatchNorm and Dice

BN_CASES = {
    "2d": dict(shape=(32, 6)),
    "3d": dict(shape=(8, 5, 6)),
    "zero_variance_column": dict(shape=(32, 6), constant=2),
    "no_scale_no_bias": dict(shape=(32, 6), use_scale=False, use_bias=False, epsilon=1e-9),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_matches_flax(case, train):
    kw = dict(BN_CASES[case])
    shape = kw.pop("shape")
    constant = kw.pop("constant", None)
    rng = np.random.default_rng(8)
    x = (rng.normal(size=shape) * 2 + 1).astype(np.float32)
    if constant is not None:
        x[..., constant] = 3.0
    jbn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, **kw)
    variables = jbn.init(jax.random.PRNGKey(0), x)
    params = _redraw(variables.get("params", {}), rng)
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    want, mutated = jbn.apply({"params": params, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
    bn = BatchNorm(6, use_scale=kw.get("use_scale", True), use_bias=kw.get("use_bias", True),
                   epsilon=kw.get("epsilon", 1e-5), device=torch.device("cpu"))
    load_jax_params(bn, params, stats).train(train)
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got_stats = _stats(bn)
    for name, value in _flat_stats(mutated["batch_stats"]).items():
        np.testing.assert_allclose(got_stats[name], value, rtol=1e-6, atol=1e-6, err_msg=name)
    if not train:
        np.testing.assert_array_equal(got_stats["running_var"], stats["var"])


# ------------------------------------------------------------ DIN vs JAX

T, USERS, ITEMS, DIM = 6, 40, 60, 8
B = 32
HIDDEN, ATT = (16, 8), (10, 5)


def _din_schema(mod):
    """``benchmarks/model_step.py``'s DIN schema at a small size."""
    return [mod.SparseFeat("user_id", USERS, DIM),
            mod.SparseFeat("item_id", ITEMS, DIM, embedding_name="item_id"),
            mod.VarLenSparseFeat(mod.SparseFeat("hist_item_id", ITEMS, DIM,
                                                embedding_name="item_id"), maxlen=T),
            mod.DenseFeat("price", 1)]


def _din_batch(seed, n=B):
    """As ``model_step.py`` builds a DIN batch, with lengths from 0 (rows
    with no valid position) and padding id 0."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, T + 1, size=n)
    hist = rng.integers(1, ITEMS, size=(n, T)).astype(np.int32)
    hist[np.arange(T)[None, :] >= lengths[:, None]] = 0
    X = {"user_id": rng.integers(1, USERS, size=n).astype(np.int32),
         "item_id": rng.integers(1, ITEMS, size=n).astype(np.int32),
         "hist_item_id": hist,
         "price": rng.normal(size=(n, 1)).astype(np.float32)}
    return X, rng.integers(0, 2, size=n).astype(np.float32)


def _jdin():
    return JDIN(tuple(_din_schema(jfeatures)), behavior_feature_list=("item_id",),
                att_hidden_units=ATT, hidden_units=HIDDEN)


def _port_din(params, batch_stats):
    model = DIN(_din_schema(tfeatures), behavior_feature_list=("item_id",),
                att_hidden_units=ATT, hidden_units=HIDDEN, device="cpu", generator=_gen())
    return load_jax_params(model, params, batch_stats)


@functools.lru_cache(maxsize=None)
def _eval_variables():
    """Every parameter redrawn and random running statistics, so that every
    term and the BatchNorms' eval path have their say."""
    rng = np.random.default_rng(9)
    variables = _jdin().init(jax.random.PRNGKey(0), _din_batch(0)[0])
    params = _redraw(variables["params"], rng)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
        variables["batch_stats"])
    return params, stats


@pytest.mark.parametrize("path", ["xla", "pallas_interpret"])
def test_din_eval_matches_jax(path, monkeypatch):
    if path == "pallas_interpret":
        # read while the JAX model traces: DinAttention takes the Pallas kernel
        monkeypatch.setenv("RST_FORCE_PALLAS", "1")
    params, stats = _eval_variables()
    X, _ = _din_batch(1)
    want = np.asarray(_jdin().apply({"params": params, "batch_stats": stats}, X))
    model = _port_din(params, stats).eval()
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in X.items()}).numpy()
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.std(want) > 0.1


def test_din_train_forward_matches_jax():
    """One train-mode forward: batch statistics in the BatchNorm and every
    Dice, and the running statistics they leave."""
    params, stats = _eval_variables()
    X, _ = _din_batch(2)
    want, mutated = _jdin().apply({"params": params, "batch_stats": stats}, X, train=True,
                                  mutable=["batch_stats"])
    model = _port_din(params, stats).train()
    got = model({k: torch.from_numpy(v) for k, v in X.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    got_stats = _stats(model)
    want_stats = _flat_stats(mutated["batch_stats"])
    assert got_stats.keys() == want_stats.keys()
    for name, value in want_stats.items():
        np.testing.assert_allclose(got_stats[name], value, rtol=1e-5, atol=1e-6, err_msg=name)


def test_scorer_serves_din_like_jax():
    """Requests of lengths that are not a multiple of the batch: the last
    row, ``[T]`` history included, is repeated to pad."""
    params, stats = _eval_variables()
    jscorer = JScorer(_jdin(), types.SimpleNamespace(params=params, batch_stats=stats),
                      batch_size=16)
    scorer = Scorer(_port_din(params, stats), batch_size=16, device="cpu")
    X, _ = _din_batch(3, n=45)
    for n in (1, 20, 45):
        Xn = {k: v[:n] for k, v in X.items()}
        got, want = scorer(Xn), jscorer(Xn)
        assert got.shape == want.shape == (n, 1) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# -------------------------------------------------------------- training

STEPS = 2
JAX_KINDS = {"adagrad": False, "fused": True}


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    """STEPS steps of the JAX Trainer from a table redrawn at std 0.1: the
    start (params, batch_stats), the state after STEPS steps, the losses."""
    fused = JAX_KINDS[kind]
    batches = [_din_batch(10 + i) for i in range(STEPS)]
    jmodel = _jdin()
    trainer = JTrainer(jmodel, optimizer=optax.adagrad(LR), seed=0,
                       fused_embedding=JFusedAdagrad(LR) if fused else None)
    state = trainer.init(batches[0][0])
    params = _np(state.params)
    params = dict(params, embeddings={"table_d8": np.random.default_rng(11).normal(
        0.0, 0.1, params["embeddings"]["table_d8"].shape).astype(np.float32)})
    start = (params, _np(state.batch_stats))
    state = state.replace(params=params)
    step = trainer._make_train_step()
    losses = []
    for X, y in batches:
        state, loss = step(state, X, y)
        losses.append(float(loss))
    return start, _np(state), np.asarray(losses)


def _view(trainer):
    """Parameters, BatchNorm statistics and optimizer state by name, the
    fused slots under the name the dense Adagrad gives a table's
    accumulator."""
    out = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}
    out.update(_stats(trainer.model))
    for n, slots in trainer.opt_state.items():
        out.update({f"{k}:{n}": v.numpy().copy() for k, v in slots.items()})
    for n, (acc,) in trainer.fused_slots.items():
        out[f"sum_of_squares:{n}"] = acc.numpy().copy()
    return out


def _jax_view(state, fused):
    model = _port_din(state.params, state.batch_stats)
    trainer = Trainer(model, Adagrad(LR), fused_embedding=FusedAdagrad(LR) if fused else None,
                      device="cpu")
    return _view(load_jax_opt_state(trainer, state.opt_state, step=int(state.step)))


# (port fused, JAX run, tolerance)
PARITY = {
    # the port's fused step against the JAX package's dense optax Adagrad
    "fused_vs_jax_dense": (True, "adagrad", (F32_RTOL, F32_ATOL)),
    "fused_vs_jax_fused": (True, "fused", (BF16_RTOL, BF16_ATOL)),
    "plain_vs_jax_plain": (False, "adagrad", (F32_RTOL, F32_ATOL)),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_din_training_matches_jax(case):
    fused, jax_kind, (rtol, atol) = PARITY[case]
    (params, stats), state, losses = _jax_run(jax_kind)
    trainer = Trainer(_port_din(params, stats), Adagrad(LR),
                      fused_embedding=FusedAdagrad(LR) if fused else None, device="cpu")
    batches = [_din_batch(10 + i) for i in range(STEPS)]
    stacked = {k: torch.from_numpy(np.stack([X[k] for X, _ in batches])) for k in batches[0][0]}
    got = trainer.multi_step(stacked, torch.from_numpy(np.stack([y for _, y in batches])))
    assert trainer.step == STEPS
    np.testing.assert_allclose(got.numpy(), losses, rtol=rtol, atol=atol)
    got_view, want_view = _view(trainer), _jax_view(state, JAX_KINDS[jax_kind])
    assert got_view.keys() == want_view.keys()
    for name in want_view:
        np.testing.assert_allclose(got_view[name], want_view[name], rtol=rtol, atol=atol,
                                   err_msg=name)
    # the statistics moved away from their start
    assert not np.allclose(got_view["bn.running_mean"], 0.0)


class _RecordingAdagrad(FusedAdagrad):
    def apply(self, table, slots, lids, ct, *, presorted=None, **kw):
        self.calls.append((lids.shape[0], presorted is None))
        super().apply(table, slots, lids, ct, presorted=presorted, **kw)


def test_din_fused_step_feeds_one_stream():
    """DIN looks up table_d8 at two sites, the [B, 2] user and item group
    and the [B, T] history; the fused step sends both as one concatenated
    stream, sorted in the update."""
    (params, stats), _, _ = _jax_run("adagrad")
    opt = _RecordingAdagrad(LR)
    object.__setattr__(opt, "calls", [])
    trainer = Trainer(_port_din(params, stats), Adagrad(LR), fused_embedding=opt,
                      device="cpu")
    X, y = _din_batch(10)
    trainer.train_step({k: torch.from_numpy(v) for k, v in X.items()}, torch.from_numpy(y))
    assert opt.calls == [(B * 2 + B * T, True)]


@pytest.mark.parametrize("pack,dim", [(16, 8), (4, 32), (1, 128)])
def test_two_site_update_matches_jax_split_stream(pack, dim):
    """Row 5's multi-site case: DIN's [B, 2] group and [B, T] history (half
    of it on one padding row), concatenated into one stream for the port's
    kernel, against the JAX package's per-site streams (``sites=``, Pallas
    in interpret mode)."""
    rng = np.random.default_rng(12)
    rows_phys, lanes, n, t = 96, 128, 48, 10
    rows = rows_phys * pack
    stack = rng.normal(size=(rows_phys, lanes)).astype(np.float32)
    acc = np.full((rows_phys, lanes), 0.1, np.float32)
    group = rng.integers(0, rows, (n, 2)).astype(np.int32)
    hist = rng.integers(0, rows, (n, t)).astype(np.int32)
    hist[:, t // 2:] = rows // 2  # the padding row, shared with the group's ids
    group[::7, 1] = rows // 2
    site_ids = [group.reshape(-1), hist.reshape(-1)]
    # the Pallas kernel rounds the cotangents to bf16; round both sides
    site_ct = [np.asarray(jnp.asarray(rng.normal(size=(len(i), dim)), jnp.bfloat16)
                          .astype(jnp.float32)) for i in site_ids]
    want_s, want_a = jax.jit(lambda s, a, i, c, sites: j_fused_adagrad_apply(
        s, a, i, c, sites=sites, pack=pack, dim=dim, lr=LR, eps=EPS, tile_rows=64,
        chunk=128))(stack, acc, np.concatenate(site_ids), np.concatenate(site_ct),
                    [(i, c, None) for i, c in zip(site_ids, site_ct)])

    table = torch.from_numpy(unpack_stack(stack, rows, dim).copy())
    table_acc = torch.from_numpy(unpack_stack(acc, rows, dim).copy())
    fused_adagrad_apply(table, table_acc, torch.from_numpy(np.concatenate(site_ids)).long(),
                        torch.from_numpy(np.concatenate(site_ct)), lr=LR, eps=EPS)
    np.testing.assert_allclose(table.numpy(), j_unpack_stack(want_s, rows, dim),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    np.testing.assert_allclose(table_acc.numpy(), j_unpack_stack(want_a, rows, dim),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_din_learns_attention_signal(fused):
    """As the JAX package's ``test_din_learns_attention_signal``: the label
    hangs on the target's category appearing in the history."""
    cols, X, y = tdatasets.synthetic_behavior(n_rows=1024, n_items=120, seq_len=8, seed=1)
    model = DIN(tuple(cols), hidden_units=(64, 32), device="cpu", generator=_gen())
    trainer = Trainer(model, fused_embedding=FusedAdagrad(LR) if fused else None,
                      device="cpu")
    history = trainer.fit(X, y, batch_size=128, epochs=5)
    assert history["loss"][-1] < history["loss"][0]
    assert trainer.evaluate(X, y)["auc"] > 0.75


def test_din_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        DIN(_din_schema(tfeatures), generator=_gen())
