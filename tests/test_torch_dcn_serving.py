"""The port's DNN, DCN and Scorer against the JAX package's on transplanted
weights (``convert.load_jax_params``), and the port's device rule."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recommender_system_tpu.layers.core import DNN as JDNN
from recommender_system_tpu.layers.core import PredictionLayer as JPredictionLayer
from recommender_system_tpu.layers.embedding import EmbeddingCollection as JEmbeddingCollection
from recommender_system_tpu.layers.embedding import unpack_stack as j_unpack_stack
from recommender_system_tpu.models import DCN as JDCN
from recommender_system_tpu.ops import pallas_kernels
from recommender_system_tpu.serving import Scorer as JScorer
from recommender_system_tpu.utils import features as jfeatures
from recommender_system_tpu_torch import DCN, Scorer
from recommender_system_tpu_torch.convert import load_jax_params, unpack_stack
from recommender_system_tpu_torch.layers.core import DNN, PredictionLayer
from recommender_system_tpu_torch.layers.embedding import EmbeddingCollection
from recommender_system_tpu_torch.utils import features as tfeatures

B = 37
ATOL = 1e-5  # f32 on both sides; dots summed in another order


def _redraw(tree, rng, std=0.3):
    """Replace every leaf with a normal draw, so that every term matters."""
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, std, np.shape(a)).astype(np.float32), tree)


def _gen():
    return torch.Generator().manual_seed(0)


# ---------------------------------------------------------------- DNN

DNN_CASES = {
    "relu": dict(),
    "relu_output_head": dict(output_dim=1, output_activation="sigmoid"),
    "batchnorm": dict(use_bn=True),
    "dice": dict(activation="dice"),
    "prelu": dict(activation="prelu"),
    **{a: dict(activation=a) for a in
       ("sigmoid", "tanh", "softmax", "elu", "gelu", "hard_sigmoid", "linear")},
    # bf16 rounds inputs, weights and every layer's output; the two
    # frameworks round the dots' f32 sums at slightly different places
    "bfloat16": dict(dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(DNN_CASES))
def test_dnn_matches_jax(case):
    kw = dict(DNN_CASES[case])
    bf16 = kw.pop("dtype", None) == "bfloat16"
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 12)).astype(np.float32)
    jmodel = JDNN((16, 8), dtype=jnp.bfloat16 if bf16 else None, **kw)
    variables = jmodel.init(jax.random.PRNGKey(0), x)
    params = _redraw(variables["params"], rng)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
        variables.get("batch_stats", {}))
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats}, x,
                                   train=False))

    model = DNN(12, (16, 8), dtype=torch.bfloat16 if bf16 else None,
                device="cpu", generator=_gen(), **kw)
    load_jax_params(model, params, stats).eval()
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 if bf16 else ATOL)


# ---------------------------------------------------------------- DCN

def _schema(mod, dims=(8,) * 5, use_hash=False):
    cols = [mod.DenseFeat(f"I{i}", 1) for i in range(3)]
    cols += [mod.SparseFeat(f"C{i}", 50 - 3 * i, d, use_hash=use_hash)
             for i, d in enumerate(dims)]
    return cols


def _batch(n, dims, use_hash, seed=2):
    rng = np.random.default_rng(seed)
    X = {f"I{i}": rng.uniform(0, 1, (n, 1)).astype(np.float32) for i in range(3)}
    for i in range(len(dims)):
        if use_hash:
            ids = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64).astype(np.int32)
            ids[:3] = [0, -1, 2 ** 31 - 1]
        else:
            # some ids out of range on both sides: the lookup clamps them
            ids = rng.integers(-3, 55, n).astype(np.int32)
        X[f"C{i}"] = ids
    return X


def _models(dims=(8,) * 5, use_hash=False, seed=3):
    """A JAX DCN with redrawn weights and the port's DCN holding the same."""
    rng = np.random.default_rng(seed)
    jmodel = JDCN(tuple(_schema(jfeatures, dims, use_hash)), cross_layers=2,
                  hidden_units=(16, 8))
    params = _redraw(jmodel.init(jax.random.PRNGKey(0),
                                 _batch(8, dims, use_hash))["params"], rng)
    model = DCN(_schema(tfeatures, dims, use_hash), cross_layers=2,
                hidden_units=(16, 8), device="cpu", generator=_gen())
    load_jax_params(model, params)
    return jmodel, params, model.eval()


DCN_CASES = {"dim8": dict(), "mixed_dims": dict(dims=(8, 4, 8, 4, 4, 8)),
             "hashed": dict(use_hash=True)}


@pytest.mark.parametrize("path", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", sorted(DCN_CASES))
def test_dcn_matches_jax(case, path, monkeypatch):
    kw = DCN_CASES[case]
    if path == "pallas_interpret":
        # read while the JAX model traces: CrossNet takes cross_fused
        monkeypatch.setenv("RST_FORCE_PALLAS", "1")
    pallas_calls = []
    cross_pallas = pallas_kernels._cross_pallas
    monkeypatch.setattr(pallas_kernels, "_cross_pallas",
                        lambda *a: pallas_calls.append(1) or cross_pallas(*a))
    jmodel, params, model = _models(**kw)
    X = _batch(B, kw.get("dims", (8,) * 5), kw.get("use_hash", False))
    want = np.asarray(jmodel.apply({"params": params}, X))
    assert bool(pallas_calls) == (path == "pallas_interpret")
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in X.items()}).numpy()
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.std(want) > 0.1  # the redrawn weights move the logits


def _embedding_schema(mod, dims):
    cols = [mod.DenseFeat("I0", 1), mod.DenseFeat("I1", 2)]
    for i, d in enumerate(dims):
        cols.append(mod.SparseFeat(f"C{i}", 40 + i, d))
    # a table shared by two columns, a hashed column, a frozen column
    cols.append(mod.SparseFeat("S0", 30, dims[0], embedding_name="shared"))
    cols.append(mod.SparseFeat("S1", 35, dims[0], embedding_name="shared"))
    cols.append(mod.SparseFeat("H", 25, dims[-1], use_hash=True))
    cols.append(mod.SparseFeat("F", 20, dims[-1], trainable=False))
    return cols


@pytest.mark.parametrize("dims", [(8, 8), (8, 4, 4)], ids=["dim8", "mixed_dims"])
def test_embedding_collection_matches_jax(dims):
    rng = np.random.default_rng(7)
    X = {"I0": rng.uniform(size=(B,)).astype(np.float32),
         "I1": rng.uniform(size=(B, 2)).astype(np.float32),
         "H": rng.integers(-2 ** 31, 2 ** 31 - 1, B, dtype=np.int64).astype(np.int32)}
    for name in [f"C{i}" for i in range(len(dims))] + ["S0", "S1", "F"]:
        X[name] = rng.integers(-2, 45, B).astype(np.int32)
    jmodule = JEmbeddingCollection(tuple(_embedding_schema(jfeatures, dims)))
    params = _redraw(jmodule.init(jax.random.PRNGKey(0), X)["params"], rng)
    want = jmodule.apply({"params": params}, X)
    module = EmbeddingCollection(_embedding_schema(tfeatures, dims),
                                 device=torch.device("cpu"), generator=_gen())
    load_jax_params(module, params)
    got = module({k: torch.from_numpy(v) for k, v in X.items()})

    assert list(got.sparse) == list(want.sparse)
    for name in want.sparse:
        np.testing.assert_array_equal(got.sparse[name].detach().numpy(),
                                      np.asarray(want.sparse[name]))
    np.testing.assert_array_equal(got.dense.numpy(), np.asarray(want.dense))
    assert got.fused.keys() == want.fused.keys()
    names = ["C0", "S1", "H"]
    for kw in (dict(), dict(include_dense=False), dict(sparse_names=names)):
        np.testing.assert_array_equal(got.concat_flat(**kw).detach().numpy(),
                                      np.asarray(want.concat_flat(**kw)))
    for stack_names in [["C0", "S0", "S1"]] + ([None] if len(set(dims)) == 1 else []):
        np.testing.assert_array_equal(got.sparse_stack(stack_names).detach().numpy(),
                                      np.asarray(want.sparse_stack(stack_names)))


@pytest.mark.parametrize("task,logits", [("binary", False), ("binary", True),
                                         ("regression", False)])
@pytest.mark.parametrize("shape", [(B,), (B, 1)])
def test_prediction_layer_matches_jax(task, logits, shape):
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    jlayer = JPredictionLayer(task=task)
    params = {"global_bias": np.array([0.7], np.float32)}
    want = np.asarray(jlayer.apply({"params": params}, x, logits=logits))
    layer = load_jax_params(PredictionLayer(task=task, device=torch.device("cpu")),
                            params)
    got = layer(torch.from_numpy(x), logits=logits).detach().numpy()
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_scorer_matches_jax_scorer():
    jmodel, params, model = _models()
    jscorer = JScorer(jmodel, types.SimpleNamespace(params=params, batch_stats={}),
                      batch_size=128)
    scorer = Scorer(model, batch_size=128, device="cpu")
    X = _batch(300, (8,) * 5, False, seed=5)
    for n in [1, 100, 300]:
        Xn = {k: v[:n] for k, v in X.items()}
        got, want = scorer(Xn), jscorer(Xn)
        assert got.shape == want.shape == (n, 1) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols = _schema(tfeatures)
    with pytest.raises(RuntimeError, match="no CUDA"):
        DCN(cols, cross_layers=2, hidden_units=(16, 8), generator=_gen())
    model = DCN(cols, cross_layers=2, hidden_units=(16, 8), device="cpu",
                generator=_gen())
    with pytest.raises(RuntimeError, match="no CUDA"):
        Scorer(model)
    with pytest.raises(ValueError, match="lies on"):
        Scorer(model, device="meta")


def test_embedding_init_std_per_table():
    cols = [tfeatures.SparseFeat("a", 20000, 4, init_std=1e-4),
            tfeatures.SparseFeat("b", 20000, 4, init_std=0.5)]
    model = DCN(cols, cross_layers=1, hidden_units=(4,), device="cpu",
                generator=_gen())
    table = model.embeddings.table_d4.detach()
    assert table.shape == (40000, 4)
    np.testing.assert_allclose(table[:20000].std().item(), 1e-4, rtol=0.05)
    np.testing.assert_allclose(table[20000:].std().item(), 0.5, rtol=0.05)


def test_varlen_columns_wait_for_sequence_slice():
    """Varlen columns, which the sequence-model slice brought: their pooled
    vectors join the cross stack's input as in the JAX package's DCN."""
    def schema(mod):
        return _schema(mod) + [
            mod.VarLenSparseFeat(mod.SparseFeat("h", 50, 8, embedding_name="C0"), maxlen=3),
            mod.VarLenSparseFeat(mod.SparseFeat("g", 20, 4), maxlen=4, combiner="sum")]

    rng = np.random.default_rng(9)
    X = _batch(B, (8,) * 5, False)
    X["h"] = rng.integers(0, 50, (B, 3)).astype(np.int32)
    X["g"] = rng.integers(0, 20, (B, 4)).astype(np.int32)
    jmodel = JDCN(tuple(schema(jfeatures)), cross_layers=2, hidden_units=(16, 8))
    params = _redraw(jmodel.init(jax.random.PRNGKey(0), X)["params"], rng)
    model = load_jax_params(DCN(schema(tfeatures), cross_layers=2, hidden_units=(16, 8),
                                device="cpu", generator=_gen()), params).eval()
    assert model.cross.weights.shape[1] == 3 + 5 * 8 + 8 + 4
    want = np.asarray(jmodel.apply({"params": params}, X))
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in X.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dim", [1, 4, 8, 9, 40, 128, 200])
def test_unpack_stack_matches_jax(dim):
    rng = np.random.default_rng(dim)
    total = 1000
    P = max(128 // dim, 1) if dim <= 128 else 1
    rows = -(-total // P) + 3
    stack = rng.normal(size=(rows, 128 if P > 1 else dim)).astype(np.float32)
    np.testing.assert_array_equal(unpack_stack(stack, total, dim),
                                  np.asarray(j_unpack_stack(jnp.asarray(stack), total, dim)))


def test_load_jax_params_rejects_unknown_and_misshapen():
    _, params, model = _models()
    extra = dict(params, extra_layer={"kernel": np.zeros((3, 3), np.float32)})
    with pytest.raises(KeyError, match="extra_layer/kernel"):
        load_jax_params(model, extra)
    missing = {k: v for k, v in params.items() if k != "head"}
    with pytest.raises(KeyError, match="head"):
        load_jax_params(model, missing)
    bad = dict(params, cross={"weights": np.zeros((3, 43), np.float32),
                              "biases": params["cross"]["biases"]})
    with pytest.raises(ValueError, match="cross/weights"):
        load_jax_params(model, bad)
