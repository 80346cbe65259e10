"""The port's FM logit (``ops/kernels.py fm_fused``, ``fm_ref``) and
``FMLayer`` against the JAX package's: the plain reference, the Pallas kernel
in interpret mode, the Flax layer with and without it, and the kernel
wrapper's argument checks. On the CPU the wrapper runs its plain version."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recommender_system_tpu.layers.interaction import FMLayer as JFMLayer
from recommender_system_tpu.ops.pallas_kernels import _fm_ref as j_fm_ref
from recommender_system_tpu.ops.pallas_kernels import fm_fused as j_fm_fused
from recommender_system_tpu_torch.convert import load_jax_params
from recommender_system_tpu_torch.layers import FMLayer
from recommender_system_tpu_torch.ops.kernels import (MAX_SHARED_BYTES, check_fm_args,
                                                      fm_fused, fm_ref, fm_shared_bytes)

# f32 on both sides; the three products are summed in another order (XLA's
# dots against PyTorch's), and the pair term subtracts two sums of similar
# size
RTOL, ATOL = 1e-5, 1e-5

# (B, D, k): the dispatch benchmark's shape at a small batch, D not a
# multiple of 32, the edge shapes the kernel takes, and a wide factor count
SHAPES = {
    "path_shape": (64, 221, 8),
    "d_not_multiple_of_32": (33, 50, 8),
    "one": (1, 1, 1),
    "dense_13_k64": (17, 13, 64),
    "k3": (40, 70, 3),
}


def _inputs(B, D, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    w1 = (rng.normal(size=(D, 1)) * 0.1).astype(np.float32)
    v = (rng.normal(size=(D, k)) * 0.1).astype(np.float32)
    return x, w1, v


_j_fm_ref = jax.jit(j_fm_ref)
_j_fm_fused = jax.jit(j_fm_fused)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_fm_ref_matches_jax(case):
    x, w1, v = _inputs(*SHAPES[case], seed=len(case))
    got = fm_ref(*map(torch.from_numpy, (x, w1, v))).numpy()
    want_ref = np.asarray(_j_fm_ref(x, w1, v))
    want_pallas = np.asarray(_j_fm_fused(x, w1, v))
    assert got.shape == want_ref.shape == (x.shape[0], 1)
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_fm_fused_on_cpu_is_the_plain_version(case):
    """On CPU tensors the Function runs ``fm_ref``, launches nothing, and its
    gradients are the plain VJP's."""
    x, w1, v = map(torch.from_numpy, _inputs(*SHAPES[case], seed=1))
    before = fm_fused.launches
    args = [t.clone().requires_grad_(True) for t in (x, w1, v)]
    out = fm_fused(*args)
    torch.testing.assert_close(out, fm_ref(x, w1, v), rtol=0, atol=0)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    grads = torch.autograd.grad(out, args, cot)
    plain = [t.clone().requires_grad_(True) for t in (x, w1, v)]
    want = torch.autograd.grad(fm_ref(*plain), plain, cot)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fm_fused.launches == before


def test_fm_fused_gradients_match_jax():
    x, w1, v = _inputs(16, 10, 4, seed=3)
    cot = np.random.default_rng(4).normal(size=(16, 1)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(j_fm_fused(*a) * cot), argnums=(0, 1, 2))(x, w1, v)
    args = [torch.from_numpy(t).requires_grad_(True) for t in (x, w1, v)]
    got = torch.autograd.grad(fm_fused(*args), args, torch.from_numpy(cot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ FMLayer

def _jax_layer(B, D, k, use_pallas, seed):
    x = np.random.default_rng(seed).normal(size=(B, D)).astype(np.float32)
    layer = JFMLayer(factor_dim=k, init_std=0.1, use_pallas=use_pallas)
    params = jax.tree_util.tree_map(np.asarray,
                                    layer.init(jax.random.PRNGKey(seed), x)["params"])
    # w0 starts at zero: give it a value so that its transplant is checked
    params = {**params, "w0": np.full((1,), 0.25, np.float32)}
    return layer, params, x


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("B,D,k", [(32, 221, 8), (7, 45, 5)])
def test_fm_layer_matches_flax(use_pallas, B, D, k):
    layer, params, x = _jax_layer(B, D, k, use_pallas, seed=D)
    cot = np.random.default_rng(5).normal(size=(B, 1)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(layer.apply({"params": p}, xx) * cot)

    want = np.asarray(layer.apply({"params": params}, x))
    want_gp, want_gx = jax.grad(loss, argnums=(0, 1))(params, x)

    port = load_jax_params(FMLayer(D, k, use_pallas=use_pallas, device="cpu",
                                   generator=torch.Generator().manual_seed(0)), params)
    assert {n for n, _ in port.named_parameters()} == {"w0", "w1", "v"}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), rtol=1e-4, atol=1e-5)
    for name in ("w0", "w1", "v"):
        np.testing.assert_allclose(getattr(port, name).grad.numpy(),
                                   np.asarray(want_gp[name]), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_fm_layer_initialises_like_flax():
    """Shapes and scales as Flax draws them: w0 zero, w1 and v normal with
    std ``init_std``."""
    layer = FMLayer(300, 16, init_std=0.05, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    assert layer.w0.shape == (1,) and layer.w1.shape == (300, 1) and layer.v.shape == (300, 16)
    assert torch.equal(layer.w0, torch.zeros(1))
    assert abs(layer.v.std().item() - 0.05) < 0.005
    assert abs(layer.w1.std().item() - 0.05) < 0.015


def test_fm_layer_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        FMLayer(10, 4, generator=torch.Generator())
    FMLayer(10, 4, device="cpu", generator=torch.Generator())


# ------------------------------------------------------- the kernel's checks

def _bad_fm_args():
    x, w1, v = torch.zeros(8, 12), torch.zeros(12, 1), torch.zeros(12, 4)
    return {
        "f64_x": ((x.double(), w1, v), TypeError),
        "bf16_v": ((x, w1, v.bfloat16()), TypeError),
        "non_contiguous_x": ((torch.zeros(12, 8).t(), w1, v), ValueError),
        "non_contiguous_v": ((x, w1, torch.zeros(4, 12).t()), ValueError),
        "x_1d": ((torch.zeros(12), w1, v), ValueError),
        "w1_width": ((x, torch.zeros(12, 2), v), ValueError),
        "v_rows": ((x, w1, torch.zeros(11, 4)), ValueError),
        "d_zero": ((torch.zeros(8, 0), torch.zeros(0, 1), torch.zeros(0, 4)), ValueError),
        "k_zero": ((x, w1, torch.zeros(12, 0)), ValueError),
        "shared_memory": ((torch.zeros(1, 4000), torch.zeros(4000, 1), torch.zeros(4000, 8)),
                          ValueError),
        "batch_2_31": ((torch.empty(2 ** 31, 12, device="meta"),
                        torch.empty(12, 1, device="meta"), torch.empty(12, 4, device="meta")),
                       ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_fm_args()))
def test_fm_kernel_rejects(case):
    args, error = _bad_fm_args()[case]
    with pytest.raises(error):
        check_fm_args(*args)


@pytest.mark.parametrize("B,D,k", [(16384, 221, 8), (1, 1, 1), (4096, 13, 64), (3, 250, 100)])
def test_fm_kernel_accepts(B, D, k):
    meta = dict(device="meta")
    check_fm_args(torch.empty(B, D, **meta), torch.empty(D, 1, **meta), torch.empty(D, k, **meta))
    assert fm_shared_bytes(D, k) <= MAX_SHARED_BYTES


def test_fm_fused_neither_launches_nor_falls_back_off_the_cpu():
    meta = [torch.empty(4, 12, device="meta"), torch.empty(12, 1, device="meta"),
            torch.empty(12, 4, device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        fm_fused(*meta)
    with pytest.raises(ValueError, match="different devices"):
        fm_fused(meta[0], torch.zeros(12, 1), torch.zeros(12, 4))
