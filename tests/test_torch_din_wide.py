"""DIN with 128-wide embeddings, where the attention's keys are 128 wide:
the tiled kernel's shared memory cannot hold them, so on the card every
attention launch of this model goes to the global kernel. At a small size
(B=16, T=8, a few hundred ids, attention 80-40), the eval forward and one
fused training step against the JAX package's DIN on transplanted
weights, at the tolerances of ``tests/test_torch_din.py``."""
import functools

import numpy as np
import pytest
import torch

import jax
import optax

from recommender_system_tpu.models import DIN as JDIN
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.utils import features as jfeatures
from recommender_system_tpu_torch import DIN, FusedAdagrad, Trainer
from recommender_system_tpu_torch.convert import load_jax_opt_state, load_jax_params
from recommender_system_tpu_torch.ops import kernels
from recommender_system_tpu_torch.training import Adagrad
from recommender_system_tpu_torch.utils import features as tfeatures

T, USERS, ITEMS, DIM, B = 8, 200, 300, 128, 16
HIDDEN, ATT = (32, 16), (80, 40)
LR = 0.05
ATOL = 1e-5  # f32 forward on both sides; dots summed in another order
F32_RTOL, F32_ATOL = 1e-4, 1e-6  # f32 steps on both sides


def _schema(mod):
    return [mod.SparseFeat("user_id", USERS, DIM),
            mod.SparseFeat("item_id", ITEMS, DIM, embedding_name="item_id"),
            mod.VarLenSparseFeat(mod.SparseFeat("hist_item_id", ITEMS, DIM,
                                                embedding_name="item_id"), maxlen=T),
            mod.DenseFeat("price", 1)]


def _batch(seed):
    """Lengths from 0 (a row with no valid position) to T, padding id 0."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, T + 1, size=B)
    hist = rng.integers(1, ITEMS, size=(B, T)).astype(np.int32)
    hist[np.arange(T)[None, :] >= lengths[:, None]] = 0
    X = {"user_id": rng.integers(1, USERS, size=B).astype(np.int32),
         "item_id": rng.integers(1, ITEMS, size=B).astype(np.int32),
         "hist_item_id": hist,
         "price": rng.normal(size=(B, 1)).astype(np.float32)}
    return X, rng.integers(0, 2, size=B).astype(np.float32)


def _jdin():
    return JDIN(tuple(_schema(jfeatures)), behavior_feature_list=("item_id",),
                att_hidden_units=ATT, hidden_units=HIDDEN)


def _port_din(params, stats):
    model = DIN(_schema(tfeatures), behavior_feature_list=("item_id",), att_hidden_units=ATT,
                hidden_units=HIDDEN, device="cpu", generator=torch.Generator().manual_seed(0))
    return load_jax_params(model, params, stats)


@functools.lru_cache(maxsize=None)
def _start():
    """The JAX Trainer's initial state, the table redrawn at std 0.1 so that
    the attention has its say."""
    trainer = JTrainer(_jdin(), optimizer=optax.adagrad(LR), seed=0)
    state = trainer.init(_batch(0)[0])
    params = jax.tree_util.tree_map(np.asarray, state.params)
    table = params["embeddings"]["table_d128"]
    params = dict(params, embeddings={"table_d128": np.random.default_rng(1).normal(
        0.0, 0.1, table.shape).astype(np.float32)})
    return trainer, state.replace(params=params)


def test_wide_din_attention_takes_the_global_kernel():
    """The attention's inputs at this width are refused by the tiled kernel
    and taken by the global one, at the small size and at model_step.py's
    batch and history."""
    for batch, hist in ((B, T), (8192, 50)):
        args = [torch.empty(s, device="meta") for s in (
            (batch, DIM), (batch, hist, DIM), (batch, hist), (4 * DIM, 80), (80,), (80, 40),
            (40,), (40, 1), (1,))]
        assert not kernels.din_kernel_takes(*args, "sigmoid")
        kernels.check_din_global_args(*args, "sigmoid")


def test_wide_din_forward_matches_jax():
    trainer, state = _start()
    X, _ = _batch(2)
    want = np.asarray(_jdin().apply({"params": state.params,
                                     "batch_stats": state.batch_stats}, X))
    model = _port_din(state.params, state.batch_stats).eval()
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in X.items()}).numpy()
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.std(want) > 1e-3


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_wide_din_step_matches_jax(fused):
    """One step of the port (fused or plain Adagrad on the table) against
    one step of the JAX Trainer's dense optax Adagrad: the loss, every
    parameter, the BatchNorm statistics and the accumulators."""
    trainer, state = _start()
    state = jax.tree_util.tree_map(lambda a: jax.numpy.array(np.asarray(a)), state)  # donated
    X, y = _batch(3)
    params, stats = (jax.tree_util.tree_map(np.asarray, t)
                     for t in (state.params, state.batch_stats))
    state, loss = trainer._make_train_step()(state, X, y)
    port = Trainer(_port_din(params, stats), Adagrad(LR),
                   fused_embedding=FusedAdagrad(LR) if fused else None, device="cpu")
    got = port.multi_step({k: torch.from_numpy(v[None]) for k, v in X.items()},
                          torch.from_numpy(y[None]))
    np.testing.assert_allclose(got.numpy(), [float(loss)], rtol=F32_RTOL, atol=F32_ATOL)
    # the dense Adagrad's state; _view names a fused slot as it names it
    want = Trainer(_port_din(state.params, state.batch_stats), Adagrad(LR), device="cpu")
    load_jax_opt_state(want, state.opt_state, step=int(state.step))
    got_view, want_view = _view(port), _view(want)
    assert got_view.keys() == want_view.keys()
    for name in want_view:
        np.testing.assert_allclose(got_view[name], want_view[name], rtol=F32_RTOL,
                                   atol=F32_ATOL, err_msg=name)
    table = port.model.embeddings.table_d128.detach().numpy()
    moved = table != params["embeddings"]["table_d128"][:len(table)]
    assert moved.any(axis=1).sum() > B  # the history's rows moved too


def _view(trainer):
    out = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}
    out.update({n: b.numpy().copy() for n, b in trainer.model.named_buffers()
                if n.endswith(("running_mean", "running_var"))})
    for n, slots in trainer.opt_state.items():
        out.update({f"{k}:{n}": v.numpy().copy() for k, v in slots.items()})
    for n, (acc,) in trainer.fused_slots.items():
        out[f"sum_of_squares:{n}"] = acc.numpy().copy()
    return out
