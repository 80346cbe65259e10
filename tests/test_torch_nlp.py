"""The port's NLP layers and models against Flax's on transplanted weights
(``convert.load_jax_params``), forward and gradient, at dropout rate 0:
``ScaledEmbedding`` (and its tied ``attend``), ``sinusoidal_pe``,
``causal_mask``, ``MultiHeadAttention`` (padding and causal masks, a row
whose keys are all padding), ``PositionWiseFFN``, ``EncoderBlock``,
``DecoderBlock``, ``LSTMClassifier``, ``Transformer`` and
``TransformerClassifier``. Transposing every square Dense kernel (q, k, v
and out are square at model_dim) changes the answers past the tolerance,
and dropout draws from the generator the Trainer passes."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recommender_system_tpu.layers import nlp as jnlp
from recommender_system_tpu.models.lstm import LSTMClassifier as JLSTMClassifier
from recommender_system_tpu.models.transformer import Transformer as JTransformer
from recommender_system_tpu.models.transformer import \
    TransformerClassifier as JTransformerClassifier
from recommender_system_tpu_torch import LSTMClassifier, Trainer, Transformer, TransformerClassifier
from recommender_system_tpu_torch.convert import load_jax_params
from recommender_system_tpu_torch.layers import nlp
from recommender_system_tpu_torch.training import SGD, losses

CPU = torch.device("cpu")
# f32 on both sides; products and reductions summed in another order
RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
B, T, S, D, H, FFN, VOCAB = 3, 7, 5, 16, 4, 24, 50


def _gen():
    return torch.Generator().manual_seed(0)


def _ids(seed, shape, pad_row=True):
    """Token ids with trailing padding (id 0), the last row all padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, shape).astype(np.int32)
    lengths = rng.integers(1, shape[1] + 1, shape[0])
    ids = np.where(np.arange(shape[1])[None, :] < lengths[:, None], ids, 0)
    if pad_row:
        ids[-1] = 0
    return ids


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _to_torch(a):
    t = torch.as_tensor(np.asarray(a))
    return t.float().requires_grad_(True) if t.is_floating_point() else t


def _grads_view(port_module, jax_grads):
    """The JAX gradient tree laid out as the port's parameters (transposed
    and renamed by ``load_jax_params`` on a copy)."""
    view = copy.deepcopy(port_module)
    load_jax_params(view, jax.tree_util.tree_map(np.asarray, jax_grads))
    return dict(view.named_parameters())


def _check(flax_module, port_module, inputs, call=None, port_call=None, init_inputs=None,
           seed=9):
    """Forward and gradient (of the sum of the output times a fixed random
    cotangent, for every parameter and every float input) of
    ``flax_module`` and ``port_module`` on the same inputs and weights.
    Returns the Flax parameters."""
    call = call or (lambda m, v, *xs: m.apply(v, *xs))
    port_call = port_call or (lambda m, *xs: m(*xs))
    variables = flax_module.init(jax.random.PRNGKey(1),
                                 *[jnp.asarray(a) for a in (init_inputs or inputs)])
    params = variables["params"]
    load_jax_params(port_module, jax.tree_util.tree_map(np.asarray, params))
    port_module.eval()

    want = np.asarray(call(flax_module, {"params": params}, *inputs))
    ct = _x(seed, *want.shape)
    t_inputs = [_to_torch(a) for a in inputs]
    got = port_call(port_module, *t_inputs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)

    float_idx = [i for i, a in enumerate(inputs) if np.asarray(a).dtype.kind == "f"]

    def loss(p, *xs):
        full = list(inputs)
        for i, x in zip(float_idx, xs):
            full[i] = x
        return jnp.sum(call(flax_module, {"params": p}, *full) * ct)

    g_params, *g_inputs = jax.grad(loss, argnums=tuple(range(1 + len(float_idx))))(
        params, *[jnp.asarray(inputs[i]) for i in float_idx])
    (got * torch.as_tensor(ct)).sum().backward()
    for name, g in _grads_view(port_module, g_params).items():
        p = dict(port_module.named_parameters())[name]
        np.testing.assert_allclose(p.grad.numpy(), g.detach().numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    for i, g in zip(float_idx, g_inputs):
        np.testing.assert_allclose(t_inputs[i].grad.numpy(), np.asarray(g), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    return params


def test_sinusoidal_pe_and_causal_mask_match_jax():
    for max_len, dim in ((8, 16), (50, 32), (3, 7)):
        np.testing.assert_array_equal(nlp.sinusoidal_pe(max_len, dim, "cpu").numpy(),
                                      np.asarray(jnlp.sinusoidal_pe(max_len, dim)))
    assert nlp.sinusoidal_pe(4, 8, "cpu").dtype == torch.float32
    np.testing.assert_array_equal(nlp.causal_mask(6, "cpu").numpy(),
                                  np.asarray(jnlp.causal_mask(6)))



# public functions that make a tensor: each on the card unless told, as the
# JAX package's land on its default device
CARD_DEFAULTS = {
    "sinusoidal_pe": lambda **kw: nlp.sinusoidal_pe(8, 16, **kw),
    "causal_mask": lambda **kw: nlp.causal_mask(6, **kw),
    "init_adaptive_counts": lambda **kw: losses.init_adaptive_counts(10, **kw),
}


@pytest.mark.parametrize("name", sorted(CARD_DEFAULTS))
def test_tensor_makers_need_a_card_unless_told(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        CARD_DEFAULTS[name]()
    assert CARD_DEFAULTS[name](device="cpu").device == CPU

def test_scaled_embedding_and_attend_match_flax():
    ids = _ids(0, (B, T))
    _check(jnlp.ScaledEmbedding(VOCAB, D), nlp.ScaledEmbedding(VOCAB, D, device=CPU,
                                                                generator=_gen()), [ids])
    x = _x(1, B, T, D)
    _check(jnlp.ScaledEmbedding(VOCAB, D),
           nlp.ScaledEmbedding(VOCAB, D, device=CPU, generator=_gen()), [ids, x],
           call=lambda m, v, i, x: m.apply(v, x, method=m.attend),
           port_call=lambda m, i, x: m.attend(x), init_inputs=[ids])


@pytest.mark.parametrize("causal,cross", [(False, False), (True, False), (False, True)])
def test_multi_head_attention_matches_flax(causal, cross):
    q = _x(2, B, T, D)
    kv = _x(3, B, S, D) if cross else q
    mask = _ids(4, (B, kv.shape[1])) != 0  # the last row's keys are all padding
    port = nlp.MultiHeadAttention(H, D, causal=causal, device=CPU, generator=_gen())
    _check(jnlp.MultiHeadAttention(H, D, causal=causal), port, [q, kv, mask],
           call=lambda m, v, q, kv, mask: m.apply(v, q, kv, key_padding_mask=mask),
           port_call=lambda m, q, kv, mask: m(q, kv, key_padding_mask=mask))
    # a row with no valid key attends uniformly over its keys: finite output
    with torch.no_grad():
        out = port(torch.as_tensor(q), torch.as_tensor(kv), torch.as_tensor(mask))
    assert torch.isfinite(out).all()


def test_position_wise_ffn_matches_flax():
    _check(jnlp.PositionWiseFFN(FFN, D), nlp.PositionWiseFFN(FFN, D, device=CPU,
                                                             generator=_gen()), [_x(5, B, T, D)])


def test_encoder_block_matches_flax():
    mask = _ids(6, (B, T)) != 0
    _check(jnlp.EncoderBlock(H, D, FFN, dropout_rate=0.0),
           nlp.EncoderBlock(H, D, FFN, dropout_rate=0.0, device=CPU, generator=_gen()),
           [_x(7, B, T, D), mask],
           call=lambda m, v, x, mask: m.apply(v, x, padding_mask=mask),
           port_call=lambda m, x, mask: m(x, padding_mask=mask))


def test_decoder_block_matches_flax():
    self_mask = _ids(8, (B, T)) != 0
    enc_mask = _ids(9, (B, S)) != 0
    _check(jnlp.DecoderBlock(H, D, FFN, dropout_rate=0.0),
           nlp.DecoderBlock(H, D, FFN, dropout_rate=0.0, device=CPU, generator=_gen()),
           [_x(10, B, T, D), _x(11, B, S, D), self_mask, enc_mask],
           call=lambda m, v, x, e, sm, em: m.apply(v, x, e, self_padding_mask=sm,
                                                   enc_padding_mask=em),
           port_call=lambda m, x, e, sm, em: m(x, e, self_padding_mask=sm,
                                               enc_padding_mask=em))


def test_lstm_classifier_matches_flax():
    port = LSTMClassifier(VOCAB, embed_dim=12, hidden=10, device=CPU, generator=_gen())
    assert torch.equal(port.bias[10:20], torch.ones(10))  # forget gate starts at 1
    assert torch.equal(port.bias[:10], torch.zeros(10)) and not port.bias[20:].any()
    _check(JLSTMClassifier(VOCAB, embed_dim=12, hidden=10), port, [_ids(12, (B, T))])


def _classifier():
    return (JTransformerClassifier(VOCAB, model_dim=D, num_heads=H, num_layers=2,
                                   ffn_dim=FFN, max_len=T + 1, dropout_rate=0.0),
            TransformerClassifier(VOCAB, model_dim=D, num_heads=H, num_layers=2, ffn_dim=FFN,
                                  max_len=T + 1, dropout_rate=0.0, device=CPU,
                                  generator=_gen()))


def test_transformer_classifier_matches_flax():
    flax_model, port = _classifier()
    _check(flax_model, port, [_ids(13, (B, T))])


def test_transformer_matches_flax():
    src, tgt = _ids(14, (B, S)), _ids(15, (B, T))
    _check(JTransformer(VOCAB, model_dim=D, num_heads=H, num_layers=2, ffn_dim=FFN,
                        max_len=T + 1, dropout_rate=0.0),
           Transformer(VOCAB, model_dim=D, num_heads=H, num_layers=2, ffn_dim=FFN,
                       max_len=T + 1, dropout_rate=0.0, device=CPU, generator=_gen()),
           [src, tgt])


def test_transposed_square_kernels_change_the_answer():
    """The transplant the parity tests rely on: with every square Dense
    kernel transposed (the shapes still fit), the classifier's logits leave
    the tolerance."""
    flax_model, port = _classifier()
    ids = _ids(16, (B, T))
    params = flax_model.init(jax.random.PRNGKey(1), jnp.asarray(ids))["params"]
    want = np.asarray(flax_model.apply({"params": params}, jnp.asarray(ids)))

    def transpose_square(path, leaf):
        leaf = np.asarray(leaf)
        square = path[-1].key == "kernel" and leaf.ndim == 2 and leaf.shape[0] == leaf.shape[1]
        return leaf.T if square else leaf

    load_jax_params(port, jax.tree_util.tree_map_with_path(transpose_square, params))
    port.eval()
    with torch.no_grad():
        got = port(torch.as_tensor(ids)).numpy()
    assert np.abs(got - want).max() > 100 * ATOL


def test_dropout_draws_from_the_trainers_generator():
    model = TransformerClassifier(VOCAB, model_dim=D, num_heads=H, num_layers=1, ffn_dim=FFN,
                                  max_len=T, dropout_rate=0.5, device=CPU, generator=_gen())
    ids = torch.as_tensor(_ids(17, (B, T), pad_row=False))
    model.train()
    a = model(ids, generator=torch.Generator().manual_seed(5))
    b = model(ids, generator=torch.Generator().manual_seed(5))
    c = model(ids, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        model(ids)
    model.eval()
    torch.testing.assert_close(model(ids), model(ids), rtol=0, atol=0)

    trainer = Trainer(model, SGD(0.1), device="cpu", generator=torch.Generator().manual_seed(3))
    before = trainer.generator.get_state()
    trainer.train_step(ids, torch.ones(B))
    assert not torch.equal(before, trainer.generator.get_state())
