"""The port's ``ops/din_vjp.py``: ``din_attention_remat`` against the JAX
package's (forward and ``jax.vjp`` gradients), ``din_attention_backward_ref``
(the backward kernel's plain version) against autograd through
``din_attention_ref`` in float64, the ``din_attention_backward`` wrapper on
the CPU, the shapes its global kernel's check takes, and where its tile
and wide kernels take over (``din_backward_kernel_takes``,
``din_backward_wide_takes``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recommender_system_tpu.ops.din_vjp import din_attention_remat as j_din_attention_remat
from recommender_system_tpu_torch.ops.din_vjp import (din_attention_backward_ref,
                                                      din_attention_remat)
from recommender_system_tpu_torch.ops import kernels
from recommender_system_tpu_torch.ops.kernels import (DIN_BACKWARD_TILE, MAX_SHARED_BYTES,
                                                      check_din_backward_args,
                                                      check_din_global_args,
                                                      din_attention_backward,
                                                      din_attention_fused, din_attention_ref,
                                                      din_backward_kernel_takes,
                                                      din_global_shared_bytes)

# the same f32 operations on both sides, summed in another order
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
# gradients: chained sums over T and the batch in f32
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# the per-part formula against autograd, both in float64
F64_RTOL, F64_ATOL = 1e-10, 1e-12

FLAGS = [(a, wn, rs) for a in ("sigmoid", "relu") for wn in (True, False)
         for rs in (False, True)]
FLAG_IDS = [f"{a}-{'softmax' if wn else 'raw'}-{'scores' if rs else 'pooled'}"
            for a, wn, rs in FLAGS]
NAMES = ("dq", "dkeys", "dw1", "db1", "dw2", "db2", "dw3", "db3")


def _inputs(B=16, T=5, K=8, H1=10, H2=5, seed=0, all_masked=(0,)):
    """numpy inputs: lengths uniform on 1..T, the rows in ``all_masked`` with
    no valid position."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, K)).astype(np.float32)
    keys = rng.normal(size=(B, T, K)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    lengths[list(all_masked)] = 0
    mask = np.arange(T)[None, :] < lengths[:, None]
    weights = [(rng.normal(size=s) * sd).astype(np.float32) for s, sd in
               (((4 * K, H1), 0.3), ((H1,), 0.1), ((H1, H2), 0.3), ((H2,), 0.1),
                ((H2, 1), 0.3), ((1,), 0.1))]
    return q, keys, mask, weights


def _cotangent(B, T, K, return_scores, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, T if return_scores else K)).astype(np.float32)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_din_attention_remat_matches_jax(flags):
    """Forward and gradients against JAX's ``din_attention_remat`` (its
    hand-written backward), one cotangent, a row with no valid position."""
    q, keys, mask, weights = _inputs()
    B, T, K = keys.shape
    cot = _cotangent(B, T, K, flags[2])
    out, vjp = jax.vjp(lambda *a: j_din_attention_remat(a[0], a[1], jnp.asarray(mask), *a[2:],
                                                        *flags, None), q, keys, *weights)
    want = vjp(jnp.asarray(cot))

    args = [torch.tensor(a, requires_grad=True) for a in (q, keys, *weights)]
    got = din_attention_remat(args[0], args[1], torch.from_numpy(mask), *args[2:], *flags)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    grads = torch.autograd.grad(got, args, torch.from_numpy(cot))
    for name, g, w in zip(NAMES, grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def _f64_pair(flags, **shape):
    """(din_attention_backward_ref's gradients, autograd's through
    din_attention_ref), both in float64 on the same inputs."""
    q, keys, mask, weights = _inputs(**shape)
    B, T, K = keys.shape
    cot = torch.from_numpy(_cotangent(B, T, K, flags[2])).double()
    tensors = [torch.from_numpy(a).double() for a in (q, keys, *weights)]
    tmask = torch.from_numpy(mask)
    score = din_attention_ref(tensors[0], tensors[1], tmask, *tensors[2:], flags[0], flags[1],
                              True)
    got = din_attention_backward_ref(tensors[0], tensors[1], tmask, *tensors[2:], score, cot,
                                     *flags)
    args = [t.clone().requires_grad_(True) for t in tensors]
    out = din_attention_ref(args[0], args[1], tmask, *args[2:], *flags)
    want = torch.autograd.grad(out, args, cot)
    return got, want


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_backward_ref_is_autograd_in_float64(flags):
    """The per-part formula (``wkp = [wk - wm; wp]``, ``dw1 = [dA, dBw, dA -
    dBw, dP]``) is the exact VJP of ``din_attention_ref``: float64 on both
    sides."""
    got, want = _f64_pair(flags, seed=2)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, rtol=F64_RTOL, atol=F64_ATOL, msg=name)


# the plain versions' edge cases: one position, K not a multiple of 4 (the
# kernel's 4-byte copies), every row without a valid position (weights 1/T,
# nothing reaches the scorer), relu's kink at exactly 0 (JAX's a > 0)
EDGES = {
    "t1": dict(T=1),
    "k6": dict(K=6),
    "all_masked": dict(B=4, all_masked=(0, 1, 2, 3)),
}
EDGE_FLAGS = [("sigmoid", True, False), ("relu", True, True), ("relu", False, False)]


@pytest.mark.parametrize("flags", EDGE_FLAGS, ids=lambda f: "-".join(map(str, f)))
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_backward_ref_edges(edge, flags):
    got, want = _f64_pair(flags, seed=3, **EDGES[edge])
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, rtol=F64_RTOL, atol=F64_ATOL, msg=name)
    if edge == "all_masked":
        # nothing reaches the scorer: its weights get no gradient
        for name, g in zip(NAMES[2:], got[2:]):
            assert torch.count_nonzero(g) == 0, name


def test_relu_derivative_is_zero_at_the_kink():
    """A first-layer pre-activation of exactly 0 passes no gradient, as
    JAX's ``(a > 0)``: b1 set so that one unit's pre-activation is 0 at
    every position, its column of dw1 and its db1 are 0."""
    q, keys, mask, weights = _inputs(K=4, H1=3, seed=4, all_masked=())
    w1 = weights[0]
    w1[:, 1] = 0.0  # unit 1 sees nothing but its bias
    weights[1][1] = 0.0
    B, T, K = keys.shape
    tensors = [torch.from_numpy(a).double() for a in (q, keys, *weights)]
    tmask = torch.from_numpy(mask)
    flags = ("relu", True, False)
    score = din_attention_ref(tensors[0], tensors[1], tmask, *tensors[2:], "relu", True, True)
    cot = torch.from_numpy(_cotangent(B, T, K, False)).double()
    _, _, dw1, db1, dw2, *_ = din_attention_backward_ref(tensors[0], tensors[1], tmask,
                                                        *tensors[2:], score, cot, *flags)
    assert torch.count_nonzero(dw1[:, 1]) == 0
    assert db1[1] == 0
    # h1's unit 1 is 0 too, so it reaches no second-layer weight
    assert torch.count_nonzero(dw2[1]) == 0


@pytest.mark.parametrize("flags", FLAGS[:2], ids=FLAG_IDS[:2])
def test_cpu_backward_launches_nothing(flags):
    """On the CPU the wrapper and the autograd Function's backward run the
    plain version: the backward's launch count does not move, and the
    wrapper's result is the plain version's exactly."""
    q, keys, mask, weights = _inputs(seed=5)
    B, T, K = keys.shape
    tensors = [torch.from_numpy(a) for a in (q, keys, *weights)]
    maskf = torch.from_numpy(mask.astype(np.float32))
    cot = torch.from_numpy(_cotangent(B, T, K, flags[2]))
    before = din_attention_backward.launches
    score = din_attention_ref(tensors[0], tensors[1], maskf, *tensors[2:], flags[0], flags[1],
                              True)
    got = din_attention_backward(tensors[0], tensors[1], maskf, *tensors[2:], score, cot, *flags)
    want = din_attention_backward_ref(tensors[0], tensors[1], maskf, *tensors[2:], score, cot,
                                      *flags)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    args = [t.clone().requires_grad_(True) for t in tensors]
    auto = torch.autograd.grad(din_attention_fused(args[0], args[1], maskf, *args[2:], *flags),
                               args, cot)
    assert din_attention_backward.launches == before
    # the Function saved the weights it pooled with: its backward is the
    # wrapper's on them
    for name, g, w in zip(NAMES, auto, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_din_attention_remat_ignores_dtype_name_with_a_warning():
    q, keys, mask, weights = _inputs(seed=6)
    args = [torch.from_numpy(a) for a in (q, keys, *weights)]
    tmask = torch.from_numpy(mask)
    want = din_attention_remat(args[0], args[1], tmask, *args[2:])
    with pytest.warns(UserWarning, match="ignored"):
        got = din_attention_remat(args[0], args[1], tmask, *args[2:], dtype_name="bfloat16")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _meta(B, T, K, H1=80, H2=40, return_scores=False):
    """The forward's inputs, its weights and a cotangent, as meta tensors."""
    return ([torch.empty(s, device="meta") for s in
             ((B, K), (B, T, K), (B, T), (4 * K, H1), (H1,), (H1, H2), (H2,), (H2, 1), (1,))]
            + [torch.empty(B, T, device="meta"),
               torch.empty((B, T) if return_scores else (B, K), device="meta")])


# shapes of the forward kernels at their edges: the tiled kernel's (DIN's,
# T=514 at K=32), the global kernel's three timed shapes, a long history,
# hidden widths past 256, and the global kernel's widest keys (its least
# shared memory grows with K + H1 alone)
TAKEN = {
    "din": (8192, 50, 32, 80, 40),
    "tiled_edge": (4, 514, 32, 80, 40),
    "k128_t50": (8192, 50, 128, 80, 40),
    "k64_t200": (8192, 200, 64, 80, 40),
    "k32_t1000": (8192, 1000, 32, 80, 40),
    "t60000": (4, 60_000, 8, 80, 40),
    "wide_hidden": (4, 50, 32, 1024, 512),
    "widest_keys": (4, 50, 44_976, 80, 40),
}


@pytest.mark.parametrize("return_scores", [False, True], ids=["pooled", "scores"])
@pytest.mark.parametrize("case", sorted(TAKEN))
def test_backward_takes_every_shape_the_forward_takes(case, return_scores):
    """The backward kernel has no limit of its own: its check takes every
    shape the forward's global kernel takes, up to that kernel's
    shared-memory edge."""
    B, T, K, H1, H2 = TAKEN[case]
    args = _meta(B, T, K, H1, H2, return_scores)
    check_din_global_args(*args[:9], "sigmoid")
    check_din_backward_args(*args, "sigmoid", return_scores)
    if case == "widest_keys":
        assert din_global_shared_bytes(K, H1, H2) <= MAX_SHARED_BYTES
        assert din_global_shared_bytes(K + 1, H1, H2) > MAX_SHARED_BYTES


def test_backward_check_rejects():
    args = _meta(4, 6, 8)
    with pytest.raises(ValueError, match="grad has shape"):
        check_din_backward_args(*args[:10], torch.empty(4, 6, device="meta"), "sigmoid", False)
    with pytest.raises(ValueError, match="weights has shape"):
        check_din_backward_args(*args[:9], torch.empty(4, 7, device="meta"), args[10],
                                "sigmoid", False)
    with pytest.raises(TypeError, match="float32"):
        check_din_backward_args(*args[:10], args[10].double(), "sigmoid", False)
    with pytest.raises(ValueError, match="activation"):
        check_din_backward_args(*args, "dice", False)


# the tile kernel's edges: (B, T, K, H1, H2) it takes, and one past each
TILE_TAKES = {
    "din": (8192, 50, 32, 80, 40),
    "small": (16, 13, 8, 10, 5),
    "widest": (4, 64, 32, 80, 40),
    "narrowest": (1, 1, 1, 1, 1),
    "one_row_a_tile": (3, 33, 32, 80, 40),
    "batch_past_int16": (70_000, 50, 32, 80, 40),
}
TILE_REFUSES = {
    "t65": (4, 65, 32, 80, 40),
    "k33": (4, 50, 33, 80, 40),
    "h1_81": (4, 50, 32, 81, 40),
    "h2_41": (4, 50, 32, 80, 41),
    "k128_t50": (8192, 50, 128, 80, 40),
    "k64_t200": (8192, 200, 64, 80, 40),
    "k32_t1000": (8192, 1000, 32, 80, 40),
}


@pytest.mark.parametrize("return_scores", [False, True], ids=["pooled", "scores"])
@pytest.mark.parametrize("case", sorted(TILE_TAKES) + sorted(TILE_REFUSES))
def test_backward_tile_kernel_takes_within_its_limits(case, return_scores):
    """``din_backward_kernel_takes`` on meta tensors: the tile kernel takes
    K <= 32, H1 <= 80, H2 <= 40 and T <= 64 and nothing past any of them;
    where it refuses, the global kernel's check takes the shape."""
    takes = case in TILE_TAKES
    B, T, K, H1, H2 = (TILE_TAKES if takes else TILE_REFUSES)[case]
    args = _meta(B, T, K, H1, H2, return_scores)
    assert din_backward_kernel_takes(*args, "sigmoid", return_scores) == takes
    assert din_backward_kernel_takes(*args, "relu", return_scores) == takes
    check_din_backward_args(*args, "sigmoid", return_scores)
    lim = DIN_BACKWARD_TILE
    assert takes == (K <= lim["K"] and H1 <= lim["H1"] and H2 <= lim["H2"] and T <= lim["T"])


# the wide kernel's edges: (B, T, K, H1, H2) it takes (past the tile
# kernel's T or K, up to K=128 and 80-40, any T), and one past each of its
# limits, or within the tile kernel's
WIDE_TAKES = {
    "k128_t50": (8192, 50, 128, 80, 40),
    "k64_t200": (8192, 200, 64, 80, 40),
    "k32_t1000": (8192, 1000, 32, 80, 40),
    "t65": (4, 65, 32, 80, 40),
    "k33": (4, 50, 33, 80, 40),
    "k100_t1": (4, 1, 100, 80, 40),
    "k128_t65_narrow": (4, 65, 128, 1, 1),
    "t128": (4, 128, 8, 10, 5),
    "t100000": (2, 100_000, 32, 80, 40),
}
WIDE_REFUSES = {
    "k129": (4, 50, 129, 80, 40),
    "h1_81": (4, 65, 32, 81, 40),
    "h2_41": (4, 65, 32, 80, 41),
    "k128_h1_81": (4, 50, 128, 81, 40),
    "tile_din": (8192, 50, 32, 80, 40),
    "tile_t64": (4, 64, 32, 80, 40),
    "tile_k32": (4, 1, 32, 80, 40),
}


@pytest.mark.parametrize("return_scores", [False, True], ids=["pooled", "scores"])
@pytest.mark.parametrize("case", sorted(WIDE_TAKES) + sorted(WIDE_REFUSES))
def test_backward_wide_kernel_takes_within_its_limits(case, return_scores):
    """``din_backward_wide_takes`` on meta tensors: the wide kernel takes
    K <= 128, H1 <= 80 and H2 <= 40 at any T, where the tile kernel does not
    take the shape, and nothing past any of its limits; the router names
    exactly one kernel at every shape, and the global kernel's check takes
    them all."""
    takes = case in WIDE_TAKES
    B, T, K, H1, H2 = (WIDE_TAKES if takes else WIDE_REFUSES)[case]
    args = _meta(B, T, K, H1, H2, return_scores)
    for activation in ("sigmoid", "relu"):
        assert kernels.din_backward_wide_takes(*args, activation, return_scores) == takes
        tile = din_backward_kernel_takes(*args, activation, return_scores)
        assert not (tile and takes)
        want = "tile" if tile else "wide" if takes else "global"
        assert kernels.din_backward_route(*args, activation, return_scores) == want
    check_din_backward_args(*args, "sigmoid", return_scores)
    lim = kernels.DIN_BACKWARD_WIDE
    within = K <= lim["K"] and H1 <= lim["H1"] and H2 <= lim["H2"]
    assert takes == (within and not din_backward_kernel_takes(*args, "sigmoid", return_scores))


def test_backward_tile_kernel_refuses_what_no_kernel_takes():
    """Where the global kernel's check raises, the tile kernel does not take
    the inputs either: the predicate never raises."""
    args = _meta(4, 6, 8)
    bad = [
        (*args[:10], torch.empty(4, 6, device="meta"), "sigmoid", False),   # grad's shape
        (*args[:9], torch.empty(4, 7, device="meta"), args[10], "sigmoid", False),
        (*args[:10], args[10].double(), "sigmoid", False),
        (*args, "dice", False),
        (*args[:3], args[3].double(), *args[4:], "sigmoid", False),
    ]
    for call in bad:
        with pytest.raises((TypeError, ValueError)):
            check_din_backward_args(*call)
        assert not din_backward_kernel_takes(*call)
        assert not kernels.din_backward_wide_takes(*call)


@pytest.mark.parametrize("flags", FLAGS[:4], ids=FLAG_IDS[:4])
def test_cpu_router_launches_nothing(flags, monkeypatch):
    """On the CPU neither backward kernel runs at a shape the tile kernel
    takes or one it refuses: no count moves and no library is loaded, and
    the result is the plain version's exactly."""
    def no_library(name):
        raise AssertionError(f"the CPU path loaded {name}")

    monkeypatch.setattr(kernels, "_library", no_library)
    for shape in (dict(T=5, K=8), dict(T=70, K=8)):
        q, keys, mask, weights = _inputs(B=4, seed=9, **shape)
        B, T, K = keys.shape
        tensors = [torch.from_numpy(a) for a in (q, keys, *weights)]
        maskf = torch.from_numpy(mask.astype(np.float32))
        cot = torch.from_numpy(_cotangent(B, T, K, flags[2]))
        score = din_attention_ref(tensors[0], tensors[1], maskf, *tensors[2:], flags[0],
                                  flags[1], True)
        counts = (din_attention_backward.launches, din_attention_backward.wide_launches,
                  din_attention_backward.global_launches)
        got = din_attention_backward(tensors[0], tensors[1], maskf, *tensors[2:], score, cot,
                                     *flags)
        want = din_attention_backward_ref(tensors[0], tensors[1], maskf, *tensors[2:], score,
                                          cot, *flags)
        assert (din_attention_backward.launches, din_attention_backward.wide_launches,
                din_attention_backward.global_launches) == counts
        for name, g, w in zip(NAMES, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
