"""The port's recurrent ops and layers (``ops/rnn.py``, ``GRULayer``,
``AUGRULayer``) against the JAX package's: outputs, final states and the
gradients with respect to the inputs, the initial state and every
parameter, on numpy inputs from a seed."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recommender_system_tpu.layers.sequence import AUGRULayer as JAUGRULayer
from recommender_system_tpu.layers.sequence import GRULayer as JGRULayer
from recommender_system_tpu.ops import rnn as jrnn
from recommender_system_tpu_torch.convert import load_jax_params
from recommender_system_tpu_torch.layers import AUGRULayer, GRULayer
from recommender_system_tpu_torch.ops import rnn

# f32 on both sides; the port's input projection is one product over all
# steps, its state update a lerp, so sums round in another order
RTOL, ATOL = 1e-5, 1e-5
# dtype=bfloat16: the same bf16 operands on both sides, the f32 sums and
# the gradients' bf16 roundings in another order
BF16_RTOL, BF16_ATOL = 2e-2, 2e-2

B, T, D, H = 6, 7, 5, 4


def _inputs(seed, use_mask, use_h0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    att = rng.uniform(size=(B, T)).astype(np.float32)
    mask = None
    if use_mask:
        lengths = rng.integers(0, T + 1, B)
        lengths[0] = 0
        mask = np.arange(T)[None, :] < lengths[:, None]
    h0 = rng.normal(size=(B, H)).astype(np.float32) if use_h0 else None
    return rng, x, att, mask, h0


def _params(rng, kind):
    n = 4 if kind == "lstm" else 3
    return [(rng.normal(size=s) * 0.5).astype(np.float32)
            for s in ((D, n * H), (H, n * H), (n * H,))]


def _cotangents(rng, kind):
    return (rng.normal(size=(B, T, H)).astype(np.float32),
            rng.normal(size=(B, H)).astype(np.float32))


def _jax_run(kind, params, x, att, mask, h0, cot, dtype=None):
    """Outputs, final state and the gradients of ``<outputs, cot>``."""
    m = None if mask is None else jnp.asarray(mask)

    def run(x, params, h0, att):
        if kind == "gru":
            return jrnn.gru(jrnn.GRUParams(*params), x, mask=m, h0=h0, dtype=dtype)
        if kind == "augru":
            return jrnn.augru(jrnn.GRUParams(*params), x, att, mask=m, h0=h0, dtype=dtype)
        outs, (h, _) = jrnn.lstm(jrnn.LSTMParams(*params), x, mask=m)
        return outs, h

    def loss(x, params, h0, att):
        outs, h = run(x, params, h0, att)
        return jnp.sum(outs * cot[0]) + jnp.sum(h * cot[1])

    args = (x, tuple(params), h0, att)
    outs, h = run(*args)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return np.asarray(outs), np.asarray(h), grads


def _port_run(kind, params, x, att, mask, h0, cot, dtype=None):
    tx, tatt = (torch.from_numpy(a).requires_grad_(True) for a in (x, att))
    tparams = [torch.from_numpy(p).requires_grad_(True) for p in params]
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_(True)
    m = None if mask is None else torch.from_numpy(mask)
    if kind == "gru":
        outs, h = rnn.gru(rnn.GRUParams(*tparams), tx, mask=m, h0=th0, dtype=dtype)
    elif kind == "augru":
        outs, h = rnn.augru(rnn.GRUParams(*tparams), tx, tatt, mask=m, h0=th0, dtype=dtype)
    else:
        outs, (h, _) = rnn.lstm(rnn.LSTMParams(*tparams), tx, mask=m)
    loss = (outs * torch.from_numpy(cot[0])).sum() + (h * torch.from_numpy(cot[1])).sum()
    leaves = [tx, *tparams] + ([th0] if th0 is not None else []) + [tatt]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return outs.detach().numpy(), h.detach().numpy(), grads


CASES = [(kind, use_mask, use_h0) for kind in ("gru", "augru", "lstm")
         for use_mask in (False, True) for use_h0 in (False, True)
         if not (kind == "lstm" and use_h0)]


@pytest.mark.parametrize("kind,use_mask,use_h0", CASES,
                         ids=[f"{k}-{'mask' if m else 'nomask'}-{'h0' if h else 'zero'}"
                              for k, m, h in CASES])
def test_rnn_matches_jax(kind, use_mask, use_h0):
    rng, x, att, mask, h0 = _inputs(1, use_mask, use_h0)
    params, cot = _params(rng, kind), _cotangents(rng, kind)
    want_o, want_h, (gx, gp, gh0, gatt) = _jax_run(kind, params, x, att, mask, h0, cot)
    got_o, got_h, grads = _port_run(kind, params, x, att, mask, h0, cot)
    np.testing.assert_allclose(got_o, want_o, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_h, want_h, rtol=RTOL, atol=ATOL)
    want = [gx, *gp] + ([gh0] if h0 is not None else []) + [gatt]
    names = ["x", "wx", "wh", "bias"] + (["h0"] if h0 is not None else []) + ["att"]
    for name, g, w in zip(names, grads, want):
        if kind != "augru" and name == "att":
            assert g is None  # only the AUGRU reads the attention
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert np.abs(want_o).max() > 0.1
    if use_mask:
        # row 0 has no valid step: its state stays where it started
        start = np.zeros(H, np.float32) if h0 is None else h0[0]
        np.testing.assert_array_equal(got_h[0], start)


@pytest.mark.parametrize("kind", ["gru", "augru"])
def test_rnn_bf16_matches_jax(kind):
    rng, x, att, mask, h0 = _inputs(2, True, True)
    params, cot = _params(rng, kind), _cotangents(rng, kind)
    want_o, want_h, (gx, gp, gh0, gatt) = _jax_run(kind, params, x, att, mask, h0, cot,
                                                   dtype=jnp.bfloat16)
    got_o, got_h, grads = _port_run(kind, params, x, att, mask, h0, cot,
                                    dtype=torch.bfloat16)
    assert got_o.dtype == got_h.dtype == np.float32
    np.testing.assert_allclose(got_o, want_o, rtol=BF16_RTOL, atol=BF16_ATOL)
    np.testing.assert_allclose(got_h, want_h, rtol=BF16_RTOL, atol=BF16_ATOL)
    want = [gx, *gp, gh0] + ([gatt] if kind == "augru" else [])
    for g, w in zip(grads, want):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BF16_RTOL,
                                   atol=BF16_ATOL * scale)
    # the bf16 gate products differ from the f32 ones
    f32_o, _, _ = _port_run(kind, params, x, att, mask, h0, cot)
    assert not np.allclose(got_o, f32_o, rtol=1e-5, atol=1e-5)


def test_augru_with_zero_attention_keeps_its_state():
    rng, x, _, mask, h0 = _inputs(3, True, True)
    params = rnn.GRUParams(*map(torch.from_numpy, _params(rng, "augru")))
    outs, h = rnn.augru(params, torch.from_numpy(x), torch.zeros(B, T),
                        mask=torch.from_numpy(mask), h0=torch.from_numpy(h0))
    np.testing.assert_array_equal(h.numpy(), h0)
    np.testing.assert_array_equal(outs.numpy(), np.broadcast_to(h0[:, None], (B, T, H)))


def test_remat_and_unroll_are_ignored():
    rng, x, att, mask, h0 = _inputs(4, True, False)
    params = rnn.GRUParams(*map(torch.from_numpy, _params(rng, "gru")))
    args = (torch.from_numpy(x), torch.from_numpy(att))
    m = torch.from_numpy(mask)
    for fn, extra in ((rnn.gru, ()), (rnn.augru, (args[1],))):
        base = fn(params, args[0], *extra, mask=m)
        other = fn(params, args[0], *extra, mask=m, remat=False, unroll=5)
        for a, b in zip(base, other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_init_params_like_jax(kind):
    """Shapes, the uniform bound of wx, orthogonal wh blocks, the bias (with
    LSTM's forget bias); the draws themselves differ between the two
    generators."""
    gen = torch.Generator().manual_seed(0)
    if kind == "gru":
        got = rnn.init_gru_params(gen, 9, 6)
        want = jrnn.init_gru_params(jax.random.PRNGKey(0), 9, 6)
        blocks = 3
    else:
        got = rnn.init_lstm_params(gen, 9, 6)
        want = jrnn.init_lstm_params(jax.random.PRNGKey(0), 9, 6)
        blocks = 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    scale = 1 / np.sqrt(9)
    assert float(got.wx.abs().max()) <= scale and float(got.wx.min()) < 0 < float(got.wx.max())
    for b in range(blocks):
        block = got.wh[:, 6 * b: 6 * (b + 1)]
        torch.testing.assert_close(block.T @ block, torch.eye(6), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want.bias))


LAYERS = {"gru": (JGRULayer, GRULayer), "augru": (JAUGRULayer, AUGRULayer)}


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_matches_flax(kind, use_bias):
    """Flax's own initial parameters (``wx`` as drawn, on [0, 2/sqrt(D))),
    transplanted: the port must take ``wx - 1/sqrt(D)`` as Flax does."""
    jcls, tcls = LAYERS[kind]
    rng, x, att, mask, _ = _inputs(5, True, False)
    jlayer = jcls(H, use_bias=use_bias)
    args = (x, att) if kind == "augru" else (x,)
    params = jax.tree_util.tree_map(
        np.asarray, jlayer.init(jax.random.PRNGKey(1), *args, mask=mask)["params"])
    if use_bias:
        params["bias"] = rng.normal(size=params["bias"].shape).astype(np.float32)
    want_o, want_h = jlayer.apply({"params": params}, *args, mask=mask)
    layer = tcls(D, H, use_bias=use_bias, device=torch.device("cpu"),
                 generator=torch.Generator().manual_seed(0))
    load_jax_params(layer, params)
    got_o, got_h = layer(*map(torch.from_numpy, args), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got_o.detach().numpy(), np.asarray(want_o), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h), rtol=RTOL, atol=ATOL)
    assert float(params["wx"].min()) >= 0.0  # stored as drawn, not centred


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_initialises_like_flax(kind):
    """The port's own draw: ``wx`` on [0, 2/sqrt(D)), ``wh`` three
    orthogonal blocks, ``bias`` zeros."""
    layer = LAYERS[kind][1](D, H, device=torch.device("cpu"),
                            generator=torch.Generator().manual_seed(0))
    wx = layer.wx.detach()
    assert 0.0 <= float(wx.min()) and float(wx.max()) < 2 / np.sqrt(D)
    for b in range(3):
        block = layer.wh[:, H * b: H * (b + 1)].detach()
        torch.testing.assert_close(block.T @ block, torch.eye(H), rtol=0, atol=1e-5)
    assert not layer.bias.detach().any()
    assert [n for n, _ in layer.named_parameters()] == ["wx", "wh", "bias"]
