"""The port's DCN cross stack (plain ``cross_network`` and the CPU path of the
``cross_fused`` wrapper) against the JAX package's ``cross_network`` and its
Pallas ``cross_fused`` in interpret mode, forward and gradient; and the
limits of the kernels' checks."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recommender_system_tpu.ops.interactions import cross_network as j_cross_network
from recommender_system_tpu.ops.pallas_kernels import cross_fused as j_cross_fused
from recommender_system_tpu_torch.ops.interactions import cross_network
from recommender_system_tpu_torch.ops.kernels import (check_cross_args,
                                                      check_cross_global_args, cross_fused,
                                                      cross_kernel_takes)

# f32; the dots and the gradient's sums over the batch are taken in another
# order than JAX takes them, over chained layers
RTOL, ATOL = 1e-4, 1e-5


def _inputs(B, D, L, seed=0):
    # weights scaled by 1/sqrt(D) keep x_l . w_l of order one over L layers
    rng = np.random.default_rng(seed)
    scale = 0.2 / np.sqrt(D)
    return (rng.normal(size=(B, D)).astype(np.float32),
            (rng.normal(size=(L, D)) * scale).astype(np.float32),
            (rng.normal(size=(L, D)) * 0.1).astype(np.float32))


def _jax_value_and_grad(fn, args):
    loss = lambda *a: jnp.sum(fn(*a) ** 2)  # noqa: E731
    out = np.asarray(fn(*args))
    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, args))
    return out, [np.asarray(g) for g in grads]


def _torch_value_and_grad(fn, args):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("port_fn", [cross_network, cross_fused],
                         ids=["cross_network", "cross_fused_cpu"])
@pytest.mark.parametrize("jax_fn", [j_cross_network, j_cross_fused],
                         ids=["xla", "pallas_interpret"])
@pytest.mark.parametrize("B,D,L", [(37, 43, 2), (8, 12, 3), (5, 221, 6)])
def test_cross_matches_jax(port_fn, jax_fn, B, D, L):
    args = _inputs(B, D, L)
    want, want_grads = _jax_value_and_grad(jax_fn, args)
    got, got_grads = _torch_value_and_grad(port_fn, args)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)



def test_cross_fused_with_no_layers_matches_jax():
    """L=0 (which the global kernel takes on the card; the JAX Pallas kernel
    takes no L=0): the stack returns x0, and the weights' and biases'
    gradients are empty, as JAX's ``cross_network`` gives them (the plain
    VJP leaves them out of the graph; the wrapper's backward fills in
    zeros)."""
    args = _inputs(6, 1053, 0)
    want, want_grads = _jax_value_and_grad(j_cross_network, args)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = cross_fused(*ts)
    (out ** 2).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), want)
    for t, w in zip(ts, want_grads):
        assert t.grad is not None and t.grad.shape == w.shape
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=RTOL, atol=ATOL)

def test_cross_fused_cpu_launches_no_kernel():
    before = cross_fused.launches
    x0, w, b = map(torch.from_numpy, _inputs(37, 43, 2))
    with torch.inference_mode():
        out = cross_fused(x0, w, b)
    torch.testing.assert_close(out, cross_network(x0, w, b), rtol=0, atol=0)
    assert cross_fused.launches == before


def _bad_args():
    x0, w, b = (torch.from_numpy(a) for a in _inputs(4, 16, 2))
    return {
        "f64": ((x0.double(), w, b), TypeError),
        "bf16_weights": ((x0, w.bfloat16(), b), TypeError),
        "non_contiguous": ((torch.zeros(16, 4).t(), w, b), ValueError),
        "x0_1d": ((x0[0], w, b), ValueError),
        "weights_biases_differ": ((x0, w, b[:1]), ValueError),
        "width_mismatch": ((torch.zeros(4, 17), w, b), ValueError),
        "too_wide": ((torch.zeros(2, 1025), torch.zeros(1, 1025), torch.zeros(1, 1025)),
                     ValueError),
        "too_much_shared_memory": ((torch.zeros(2, 1024), torch.zeros(29, 1024),
                                    torch.zeros(29, 1024)), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_args()))
def test_cross_kernel_rejects(case):
    args, error = _bad_args()[case]
    with pytest.raises(error):
        check_cross_args(*args)


def test_cross_kernel_accepts_bench_shape():
    check_cross_args(torch.zeros(4096, 221), torch.zeros(6, 221), torch.zeros(6, 221))


def _meta(*shapes):
    return [torch.empty(s, device="meta") for s in shapes]


# (x0, weights, biases) shapes at the tile and stack kernels' limits -> taken
# by them; every shape here but the last is taken by the global kernel
CROSS_EDGES = {
    "bench": (((4096, 221), (6, 221), (6, 221)), True),
    "d_1024": (((8, 1024), (6, 1024), (6, 1024)), True),
    "d_1025": (((8, 1025), (6, 1025), (6, 1025)), False),
    # 2 * L * D * 4 bytes of shared memory against 232,448
    "shared_1024x28": (((8, 1024), (28, 1024), (28, 1024)), True),
    "shared_1024x29": (((8, 1024), (29, 1024), (29, 1024)), False),
    "shared_128x227": (((8, 128), (227, 128), (227, 128)), True),
    "shared_128x228": (((8, 128), (228, 128), (228, 128)), False),
    "dcn_26x40_13": (((8, 1053), (6, 1053), (6, 1053)), False),
    "batch_2_31": (((2 ** 31, 16), (2, 16), (2, 16)), False),
}


@pytest.mark.parametrize("case", sorted(CROSS_EDGES))
def test_cross_kernel_takes_at_its_limits(case):
    shapes, taken = CROSS_EDGES[case]
    args = _meta(*shapes)
    assert cross_kernel_takes(*args) is taken
    if taken:
        check_cross_args(*args)
    else:
        with pytest.raises(ValueError):
            check_cross_args(*args)
    if case == "batch_2_31":
        with pytest.raises(ValueError, match="2\\*\\*31"):
            check_cross_global_args(*args)
    else:
        check_cross_global_args(*args)


@pytest.mark.parametrize("case", sorted(_bad_args()))
def test_cross_kernel_takes_nothing_check_rejects(case):
    args, _ = _bad_args()[case]
    assert cross_kernel_takes(*args) is False


def test_cross_kernel_takes_only_contiguous_float32():
    """The predicate sees the tensors as given; ``cross_fused`` hands it
    contiguous float32 copies, so a bf16 or transposed x0 still reaches a
    kernel (on the CPU: the plain version on the float32 copy)."""
    x0, w, b = _meta((8, 16), (2, 16), (2, 16))
    assert cross_kernel_takes(x0, w, b)
    assert not cross_kernel_takes(torch.empty(16, 8, device="meta").t(), w, b)
    assert not cross_kernel_takes(x0.bfloat16(), w, b)
    x0, w, b = (torch.from_numpy(a) for a in _inputs(16, 8, 2))
    x0_t = x0.t().contiguous().t()
    with torch.inference_mode():
        got = cross_fused(x0_t.bfloat16(), w, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, cross_network(x0.bfloat16().float(), w, b),
                               rtol=0, atol=0)
