"""The rest of the port's Criteo CTR family (DeepCrossing, PNN with FGCNN,
AFM and FFM) against the JAX package's: the pairwise interaction ops, the
layers (``LinearEmbedding``, ``InnerProductLayer``, ``OuterProductLayer``,
``AFMAttention``, ``ResBlock``, ``FGCNN``), each model's forward on
transplanted weights, K=4 fused and plain ``Trainer`` steps against the JAX
``Trainer``, and ``convert.py``'s handling of the two Flax ``kernel``
leaves that are not Dense kernels."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from recommender_system_tpu import models as jmodels
from recommender_system_tpu.layers import embedding as jembedding
from recommender_system_tpu.layers import interaction as jinteraction
from recommender_system_tpu.ops import interactions as jops
from recommender_system_tpu.training import FusedAdagrad as JFusedAdagrad
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.utils.datasets import synthetic_criteo as j_synthetic_criteo
import recommender_system_tpu_torch as port
from recommender_system_tpu_torch import (AFM, CTR_MODELS, FFM, PNN, DeepCrossing,
                                          FusedAdagrad, Trainer)
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params
from recommender_system_tpu_torch.layers import (FGCNN, AFMAttention, InnerProductLayer,
                                                 LinearEmbedding, OuterProductLayer, ResBlock)
from recommender_system_tpu_torch.ops import interactions as tops
from recommender_system_tpu_torch.training import Adagrad
from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

B, K, HIDDEN = 128, 4, (16,)
DATA = dict(n_dense=4, n_sparse=6, vocab=50, embedding_dim=8)
LR = 0.05
# f32 on both sides; products and reductions summed in another order
FWD_ATOL = 1e-5
F32_RTOL, F32_ATOL = 1e-4, 1e-6
# the JAX package's fused Adagrad kernel rounds every cotangent to bf16
# (2**-9 relative) before it sums a row's gradient; the port keeps them f32
BF16_RTOL, BF16_ATOL = 1e-2, 2e-4


def _gen():
    return torch.Generator().manual_seed(0)


def _batches(seed=1, k=K, n=B, **data):
    """K batches from numpy seeds: JAX columns, port columns, X [K] and y."""
    data = {**DATA, **data}
    jcols, X, y = j_synthetic_criteo(n_rows=k * n, seed=seed, **data)
    tcols = synthetic_criteo(n_rows=8, seed=seed, **data)[0]
    Xs = [{c: v[i * n:(i + 1) * n] for c, v in X.items()} for i in range(k)]
    return jcols, tcols, Xs, [y[i * n:(i + 1) * n] for i in range(k)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _torch_batch(X):
    return {k: torch.from_numpy(v) for k, v in X.items()}


# ------------------------------------------------------------- ops

def _embeds(seed, b=B, f=6, k=8):
    return np.random.default_rng(seed).normal(size=(b, f, k)).astype(np.float32)


@pytest.mark.parametrize("fields", [2, 6, 26])
def test_pair_indices_are_numpys(fields):
    jrow, jcol = jops._pair_indices(fields)
    row, col = tops._pair_indices(fields, torch.device("cpu"))
    np.testing.assert_array_equal(row.numpy(), jrow)
    np.testing.assert_array_equal(col.numpy(), jcol)


@pytest.mark.parametrize("op", ["pairwise_inner", "pairwise_product"])
def test_pairwise_op_matches_jax(op):
    e = _embeds(1)
    want = np.asarray(getattr(jops, op)(jnp.asarray(e)))
    got = getattr(tops, op)(torch.from_numpy(e)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


def _asymmetric_kernel(k, pairs, seed):
    """A ``[k, P, k]`` kernel far from symmetric in its first and last
    axes, so that a kernel copied with ``.T`` gives other products."""
    w = np.random.default_rng(seed).normal(size=(k, pairs, k)).astype(np.float32)
    w += 2.0 * np.arange(k, dtype=np.float32)[:, None, None]
    assert np.abs(w - w.transpose(2, 1, 0)).max() > 1.0
    return w


def test_pairwise_outer_matches_jax():
    e = _embeds(2, f=5, k=3)
    w = _asymmetric_kernel(3, 10, 3)
    want = np.asarray(jops.pairwise_outer(jnp.asarray(e), jnp.asarray(w)))
    got = tops.pairwise_outer(torch.from_numpy(e), torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (B, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=FWD_ATOL)
    # the kernel's first and last axes are not interchangeable
    swapped = tops.pairwise_outer(torch.from_numpy(e),
                                  torch.from_numpy(np.ascontiguousarray(w.T))).numpy()
    assert np.abs(swapped - want).max() > 0.1


def test_pair_indices_made_in_inference_mode_serve_training():
    """The cached pair indices first made under ``torch.inference_mode`` (a
    Scorer's call) still take part in a training step's autograd."""
    e = torch.from_numpy(_embeds(11, f=11))
    with torch.inference_mode():
        tops.pairwise_product(e)
    leaf = e.clone().requires_grad_(True)
    tops.pairwise_product(leaf).sum().backward()
    assert leaf.grad.shape == e.shape


@pytest.mark.parametrize("fields", [3, 7])
def test_ffm_interaction_matches_jax(fields):
    fe = np.random.default_rng(fields).normal(size=(B, fields, fields, 4)).astype(np.float32)
    want = np.asarray(jops.ffm_interaction(jnp.asarray(fe)))
    got = tops.ffm_interaction(torch.from_numpy(fe)).numpy()
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=FWD_ATOL)


# ------------------------------------------------------------- layers

def _flax_layer(module, x, seed=0):
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return _np_tree(variables["params"])


def _forward_close(jmodule, params, tmodule, x, atol=FWD_ATOL):
    want = np.asarray(jmodule.apply({"params": params}, jnp.asarray(x)))
    load_jax_params(tmodule, params)
    with torch.inference_mode():
        got = tmodule(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    return got


def test_inner_product_layer_matches_flax():
    e = _embeds(4)
    want = np.asarray(jinteraction.InnerProductLayer().apply({}, jnp.asarray(e)))
    got = InnerProductLayer()(torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


def test_outer_product_layer_keeps_the_jax_kernel_layout():
    """``OuterProductLayer/kernel`` is ``[k, P, k]``, not a Dense kernel:
    ``load_jax_params`` must copy it as it is. A ``.T`` would keep its
    shape, pass the shape check and give other products."""
    e = _embeds(5, f=5, k=3)
    params = {"kernel": _asymmetric_kernel(3, 10, 6)}
    layer = OuterProductLayer(5, 3, device="cpu", generator=_gen())
    got = _forward_close(jinteraction.OuterProductLayer(), params, layer, e)
    np.testing.assert_array_equal(layer.kernel.detach().numpy(), params["kernel"])
    assert np.std(got) > 0.1


def test_afm_attention_matches_flax():
    pairs = _embeds(7, f=15, k=8)
    jlayer = jinteraction.AFMAttention(8)
    params = _flax_layer(jlayer, pairs)
    _forward_close(jlayer, params, AFMAttention(8, 8, device="cpu", generator=_gen()), pairs)


def test_res_block_matches_flax():
    x = np.random.default_rng(8).normal(size=(B, 52)).astype(np.float32)
    jlayer = jinteraction.ResBlock((16, 8))
    params = _flax_layer(jlayer, x)
    _forward_close(jlayer, params, ResBlock(52, (16, 8), device="cpu", generator=_gen()), x)


@pytest.mark.parametrize("fields,new_fields", [(6, 12), (26, 57)])
def test_fgcnn_matches_flax(fields, new_fields):
    """FGCNN at 6 fields and at model_step.py's 26 (13 then 6 rows after
    the pools: 3 * 13 + 3 * 6 = 57 new fields). Its convolution kernels
    ``[kh, kw, in, out]`` are permuted into ``Conv2d``'s
    ``[out, in, kh, kw]``; its recombinations read Flax's NHWC flatten."""
    e = _embeds(9, b=16, f=fields, k=8)
    jlayer = jinteraction.FGCNN()
    params = _flax_layer(jlayer, e)
    layer = FGCNN(fields, 8, device="cpu", generator=_gen())
    assert layer.out_fields == new_fields
    got = _forward_close(jlayer, params, layer, e)
    assert got.shape == (16, new_fields, 8)
    for i in range(2):
        np.testing.assert_array_equal(
            getattr(layer, f"conv_{i}").weight.detach().numpy(),
            params[f"conv_{i}"]["kernel"].transpose(3, 2, 0, 1))
    assert np.std(got) > 1e-3


def test_linear_embedding_matches_flax():
    """Dim-1 tables ``linear_{name}`` (lane-packed 128 rows a stack row in
    the JAX package, unpacked by ``convert.py``), ``dense_w`` and ``bias``."""
    jcols, tcols, Xs, _ = _batches(seed=0, k=1)
    jlayer = jembedding.LinearEmbedding(tuple(jcols))
    params = _np_tree(jlayer.init(jax.random.PRNGKey(0), Xs[0])["params"])
    rng = np.random.default_rng(10)
    stack = params["linear_tables"]["table_d1"]
    assert stack.shape[1] == 128
    params["linear_tables"]["table_d1"] = rng.normal(0, 0.1, stack.shape).astype(np.float32)
    params["bias"] = np.asarray([0.3], np.float32)
    want = np.asarray(jlayer.apply({"params": params}, Xs[0]))
    layer = load_jax_params(LinearEmbedding(tcols, device="cpu", generator=_gen()), params)
    table = layer.linear_tables.table_d1
    assert table.shape == (6 * 50, 1)
    np.testing.assert_array_equal(
        table.detach().numpy(),
        np.asarray(jembedding.unpack_stack(params["linear_tables"]["table_d1"], 300, 1)))
    with torch.inference_mode():
        got = layer(_torch_batch(Xs[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    assert np.std(want) > 0.05


def test_linear_embedding_takes_varlen_columns():
    """A varlen column's dim-1 weights are pooled (mean over its valid
    positions) into the logit, beside a sparse and a dense column."""
    from recommender_system_tpu.utils import features as jf
    from recommender_system_tpu_torch.utils import features as tf

    def columns(f):
        return (f.SparseFeat("a", 20, 4), f.DenseFeat("d", 2),
                f.VarLenSparseFeat(f.SparseFeat("h", 30, 4), maxlen=5))

    rng = np.random.default_rng(12)
    hist = rng.integers(1, 30, size=(B, 5)).astype(np.int32)
    hist[rng.random((B, 5)) < 0.4] = 0
    X = {"a": rng.integers(0, 20, size=B).astype(np.int32), "h": hist,
         "d": rng.normal(size=(B, 2)).astype(np.float32)}
    jlayer = jembedding.LinearEmbedding(columns(jf))
    params = _redraw(_np_tree(jlayer.init(jax.random.PRNGKey(0), X)["params"]),
                     np.random.default_rng(13))
    params["dense_w"] = rng.normal(0, 0.1, params["dense_w"].shape).astype(np.float32)
    want = np.asarray(jlayer.apply({"params": params}, X))
    layer = load_jax_params(LinearEmbedding(columns(tf), device="cpu", generator=_gen()),
                            params)
    with torch.inference_mode():
        got = layer(_torch_batch(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    assert np.std(want) > 0.01


# ------------------------------------------------------------- models

# variant -> (JAX model, port model), each from its package's columns
VARIANTS = {
    "deep_crossing": (
        lambda c: jmodels.DeepCrossing(tuple(c), hidden_units=(16, 8), num_res_blocks=2),
        lambda c: DeepCrossing(c, hidden_units=(16, 8), num_res_blocks=2, device="cpu",
                               generator=_gen())),
    **{f"pnn_{mode}{'_fgcnn' if fg else ''}": (
        lambda c, mode=mode, fg=fg: jmodels.PNN(tuple(c), mode=mode, use_fgcnn=fg,
                                                hidden_units=HIDDEN),
        lambda c, mode=mode, fg=fg: PNN(c, mode=mode, use_fgcnn=fg, hidden_units=HIDDEN,
                                        device="cpu", generator=_gen()))
       for mode in ("inner", "outer", "both") for fg in (False, True)},
    "pnn_inner_bf16": (
        lambda c: jmodels.PNN(tuple(c), hidden_units=HIDDEN, dnn_dtype=jnp.bfloat16),
        lambda c: PNN(c, hidden_units=HIDDEN, dnn_dtype=torch.bfloat16, device="cpu",
                      generator=_gen())),
    **{f"afm_{mode}{'' if lin else '_no_linear'}": (
        lambda c, mode=mode, lin=lin: jmodels.AFM(tuple(c), mode=mode, use_linear=lin),
        lambda c, mode=mode, lin=lin: AFM(c, mode=mode, use_linear=lin, device="cpu",
                                          generator=_gen()))
       for mode in ("att", "avg", "max") for lin in (True, False)},
    "ffm": (lambda c: jmodels.FFM(tuple(c)),
            lambda c: FFM(c, device="cpu", generator=_gen())),
    "ffm_no_dense": (lambda c: jmodels.FFM(tuple(c)),
                     lambda c: FFM(c, device="cpu", generator=_gen())),
}


def _data(variant):
    return dict(n_dense=0) if variant == "ffm_no_dense" else {}


def _redraw(tree, rng):
    """Every ``table_d*`` and ``dense_factors`` leaf redrawn at std 0.1, so
    that the embeddings have their say."""
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
def _jax_init(variant):
    jcols, _, Xs, _ = _batches(**_data(variant))
    variables = VARIANTS[variant][0](jcols).init(jax.random.PRNGKey(0), Xs[0])
    return _redraw(_np_tree(variables["params"]), np.random.default_rng(3))


def _port_model(variant, params):
    _, tcols, _, _ = _batches(k=1, **_data(variant))
    return load_jax_params(VARIANTS[variant][1](tcols), params)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant):
    jcols, _, Xs, _ = _batches(seed=0, k=1, **_data(variant))
    params = _jax_init(variant)
    want = np.asarray(VARIANTS[variant][0](jcols).apply({"params": params}, Xs[0]))
    model = _port_model(variant, params).eval()
    with torch.inference_mode():
        got = model(_torch_batch(Xs[0])).numpy()
    assert got.shape == want.shape == (B, 1)
    # bf16 rounds the tower's inputs, weights and activations; the two
    # packages' GEMMs accumulate them in another order
    atol = 2e-2 if variant.endswith("bf16") else FWD_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the logits vary across the batch by far more than the tolerance
    assert np.std(want) > 1e-3


def test_pnn_both_with_fgcnn_has_the_jax_widths():
    """PNN ``mode="both"`` with FGCNN: 6 fields and 12 generated, 153 pairs
    for the inner and for the outer products, 18 * 8 flat and 4 dense
    columns into the tower."""
    model = _port_model("pnn_both_fgcnn", _jax_init("pnn_both_fgcnn"))
    assert model.outer.kernel.shape == (8, 153, 8)
    assert model.deep.dense_0.weight.shape == (16, 18 * 8 + 153 + 153 + 4)


def test_ffm_tables_and_dense_factors():
    """FFM's two collections: ``linear.linear_tables.table_d1`` and
    ``field_embeddings.table_d{n_fields * k}`` (10 fields x k=4), and
    ``dense_factors [n_dense, n_fields, k]``."""
    model = _port_model("ffm", _jax_init("ffm"))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {"linear.linear_tables.table_d1": (300, 1), "linear.dense_w": (4, 1),
                      "linear.bias": (1,), "field_embeddings.table_d40": (300, 40),
                      "dense_factors": (4, 10, 4)}


def test_ctr_family_names():
    for name, cls in (("deep_crossing", DeepCrossing), ("pnn", PNN), ("afm", AFM),
                      ("ffm", FFM)):
        assert CTR_MODELS[name] is cls is getattr(port, cls.__name__)
        assert cls.__name__ == jmodels.CTR_MODELS[name].__name__


@pytest.mark.parametrize("name", ["deep_crossing", "pnn", "afm", "ffm"])
def test_models_need_a_card_unless_told(monkeypatch, name):
    _, tcols, _, _ = _batches(k=1)
    cls = CTR_MODELS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        cls(tcols, generator=_gen())
    cls(tcols, device="cpu", generator=_gen())


@pytest.mark.parametrize("cls,kw", [(PNN, dict(mode="cross")), (AFM, dict(mode="sum"))])
def test_unknown_mode_raises(cls, kw):
    _, tcols, _, _ = _batches(k=1)
    with pytest.raises(ValueError, match="mode"):
        cls(tcols, **kw, device="cpu", generator=_gen())


def test_ffm_refuses_varlen_columns():
    from recommender_system_tpu_torch.utils.features import SparseFeat, VarLenSparseFeat

    cols = (SparseFeat("a", 10, 4), VarLenSparseFeat(SparseFeat("h", 10, 4), maxlen=3))
    with pytest.raises(ValueError, match="sparse \\+ dense"):
        FFM(cols, device="cpu", generator=_gen())


# ------------------------------------------------------------ training

TRAINED = ("deep_crossing", "pnn_inner", "pnn_both_fgcnn", "afm_att", "ffm")


@functools.lru_cache(maxsize=None)
def _jax_run(variant, fused):
    """K steps of the JAX Trainer (``optax.adagrad``, with ``FusedAdagrad``
    where ``fused``) from the redrawn start: the states after 2 and K steps
    (as numpy) and the losses."""
    jcols, _, Xs, ys = _batches(**_data(variant))
    trainer = JTrainer(VARIANTS[variant][0](jcols), optimizer=optax.adagrad(LR), seed=0,
                       fused_embedding=JFusedAdagrad(LR) if fused else None)
    state = trainer.init(Xs[0]).replace(params=_jax_init(variant))
    step = trainer._make_train_step()
    states, losses = {}, []
    for i in range(K):
        state, loss = step(state, Xs[i], ys[i])
        losses.append(float(loss))
        states[i + 1] = jax.tree_util.tree_map(np.asarray, state)
    return states, np.asarray(losses)


def _port_trainer(variant, params, fused, fused_embedding=None):
    return Trainer(_port_model(variant, params), Adagrad(LR),
                   fused_embedding=(fused_embedding or FusedAdagrad(LR)) if fused else None,
                   device="cpu")


def _view(trainer):
    """Parameters and optimizer state by name; a table's fused slot under
    the name the dense Adagrad gives it."""
    out = {n: t.detach().numpy().copy() for n, t in trainer.model.state_dict().items()}
    for n, slots in trainer.opt_state.items():
        out.update({f"{k}:{n}": v.numpy().copy() for k, v in slots.items()})
    for n, (acc,) in trainer.fused_slots.items():
        out[f"sum_of_squares:{n}"] = acc.numpy().copy()
    return out


def _jax_view(variant, state, fused):
    trainer = _port_trainer(variant, state.params, fused)
    return _view(load_jax_opt_state(trainer, state.opt_state, step=int(state.step)))


def _stacked(Xs, ys):
    batches = {k: torch.from_numpy(np.stack([X[k] for X in Xs])) for k in Xs[0]}
    return batches, torch.from_numpy(np.stack(ys))


# case -> (port's fused step, JAX Trainer fused, tolerance)
STEPS = {
    # Adagrad on the summed gradient: the fused step equals optax.adagrad on
    # the dense gradient, which the JAX package's plain step computes in f32
    "fused_vs_jax_dense": (True, False, (F32_RTOL, F32_ATOL)),
    "fused_vs_jax_fused": (True, True, (BF16_RTOL, BF16_ATOL)),
    "plain_vs_jax_dense": (False, False, (F32_RTOL, F32_ATOL)),
}


@pytest.mark.parametrize("case", sorted(STEPS))
@pytest.mark.parametrize("variant", TRAINED)
def test_training_matches_jax(variant, case):
    fused, jax_fused, (rtol, atol) = STEPS[case]
    states, losses = _jax_run(variant, jax_fused)
    trainer = _port_trainer(variant, _jax_init(variant), fused)
    _, _, Xs, ys = _batches(**_data(variant))
    got = trainer.multi_step(*_stacked(Xs, ys))
    assert trainer.step == K
    np.testing.assert_allclose(got.numpy(), losses, rtol=rtol, atol=atol)
    _assert_views_close(_view(trainer), _jax_view(variant, states[K], jax_fused), rtol, atol)
    assert losses[-1] != losses[0]


def _assert_views_close(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)


@dataclasses.dataclass(frozen=True)
class _RecordingAdagrad(FusedAdagrad):
    """``FusedAdagrad`` that records the size of each table it updates."""

    calls: list = dataclasses.field(default_factory=list)

    def apply(self, table, slots, lids, ct, **kw):
        self.calls.append((tuple(table.shape), lids.numel()))
        super().apply(table, slots, lids, ct, **kw)


def test_ffm_fused_step_updates_both_tables():
    """A fused FFM step sends one stream to each of its two tables: the
    dim-1 linear table and the dim-40 field-aware table, B * 6 lookups each."""
    fused = _RecordingAdagrad(LR)
    trainer = _port_trainer("ffm", _jax_init("ffm"), True, fused)
    assert sorted(trainer.tables) == ["field_embeddings.table_d40",
                                      "linear.linear_tables.table_d1"]
    before = {n: t.detach().clone() for n, t in trainer.tables.items()}
    _, _, Xs, ys = _batches()
    trainer.multi_step(*_stacked(Xs[:2], ys[:2]))
    assert fused.calls == [((300, 1), B * 6), ((300, 40), B * 6)] * 2
    for name, table in trainer.tables.items():
        assert not torch.equal(table.detach(), before[name]), name


def test_ffm_jax_opt_state_carries_across():
    """A JAX run of 2 steps with ``FusedAdagrad``, its two tables' slots
    carried into the port, then 2 more steps in each."""
    states, losses = _jax_run("ffm", True)
    dense, slots = states[2].opt_state
    assert sorted(slots) == [("field_embeddings", "table_d40"),
                             ("linear", "linear_tables", "table_d1")]
    trainer = _port_trainer("ffm", states[2].params, True)
    load_jax_opt_state(trainer, states[2].opt_state, step=int(states[2].step))
    _, _, Xs, ys = _batches()
    got = trainer.multi_step(*_stacked(Xs[2:], ys[2:]))
    np.testing.assert_allclose(got.numpy(), losses[2:], rtol=BF16_RTOL, atol=BF16_ATOL)
    _assert_views_close(_view(trainer), _jax_view("ffm", states[K], True),
                        BF16_RTOL, BF16_ATOL)
