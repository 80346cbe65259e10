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
from recommender_system_tpu_torch.ops.kernels import (FM_ROWS_FACTORS, FM_ROWS_MAX_DIM,
                                                      MAX_SHARED_BYTES, check_fm_args,
                                                      check_fm_global_args, fm_fused,
                                                      fm_kernel_takes, fm_ref,
                                                      fm_shared_bytes)

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


# ------------------------------------------ the kernel's arithmetic, emulated

def _fma(a, b, c):
    """fmaf in f32: the product of two f32 values is exact in f64, then one
    f64 add and a rounding to f32 (twice rounded, which differs from the
    card's single rounding only at rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _lane_sum(t):
    """Sum over the last axis of 2**n lanes, as a xor butterfly pairs them:
    the lanes that differ in the top bit first, the lowest bit last."""
    while t.shape[-1] > 1:
        n = t.shape[-1] // 2
        t = t[..., :n] + t[..., n:]
    return t[..., 0]


def _fm_rows_emulated(x, w1, v):
    """csrc/fm.cu's register kernel (D <= 256, k <= 8) in f32 torch: the
    folded coefficients a = w1 and c = -vv/2 (vv = sum_j v_j^2 by fma), lane
    l's partial sums over the columns l, l+32, ... in that order
    (t = fma(x, fma(c, x, a), t) and s_j = fma(x, v_j, s_j)), each summed
    over the 32 lanes in the order 16, 8, 4, 2, 1, then s_j^2 summed over
    the factors in the order 4, 2, 1 and out = fma(0.5, sum, t)."""
    B, D = x.shape
    k = v.shape[1]
    cols = 32 * -(-D // 32)
    vp = torch.zeros(cols, 8)
    vp[:D, :k] = v
    a = torch.zeros(cols)
    a[:D] = w1[:, 0]
    vv = torch.zeros(cols)
    for j in range(8):
        vv = _fma(vp[:, j], vp[:, j], vv)
    c = -0.5 * vv
    xp = torch.zeros(B, cols)
    xp[:, :D] = x
    t = torch.zeros(B, 32)
    s = torch.zeros(B, 8, 32)
    for p in range(cols // 32):
        lanes = slice(32 * p, 32 * p + 32)
        xd = xp[:, lanes]
        t = _fma(xd, _fma(c[lanes], xd, a[lanes]), t)
        s = _fma(xd[:, None, :], vp[lanes].t()[None], s)
    t, s = _lane_sum(t), _lane_sum(s)
    sq = _lane_sum(s * s)
    return _fma(torch.full_like(sq, 0.5), sq, t)[:, None]


def _fm_wide_emulated(x, w1, v):
    """csrc/fm.cu's wide kernel (one warp a row) in f32 torch: lane l's fma
    partial sums of x.w1, x.v_j and x^2.v_j^2 over l, l+32, ..., each summed
    over the lanes in the order 16, 8, 4, 2, 1; per factor
    pair += fma(s, s, -q) in factor order, out = fma(0.5, pair, linear)."""
    B, D = x.shape
    k = v.shape[1]
    cols = 32 * -(-D // 32)
    xp = torch.zeros(B, cols)
    xp[:, :D] = x
    wp = torch.zeros(cols)
    wp[:D] = w1[:, 0]
    vp = torch.zeros(cols, k)
    vp[:D] = v
    x2, v2 = xp * xp, vp * vp
    linear = torch.zeros(B, 32)
    s = torch.zeros(B, k, 32)
    q = torch.zeros(B, k, 32)
    for p in range(cols // 32):
        lanes = slice(32 * p, 32 * p + 32)
        linear = _fma(xp[:, lanes], wp[lanes], linear)
        s = _fma(xp[:, None, lanes], vp[lanes].t()[None], s)
        q = _fma(x2[:, None, lanes], v2[lanes].t()[None], q)
    linear, s, q = _lane_sum(linear), _lane_sum(s), _lane_sum(q)
    pair = torch.zeros(B)
    for j in range(k):
        pair = pair + _fma(s[:, j], s[:, j], -q[:, j])
    return _fma(torch.full_like(pair, 0.5), pair, linear)[:, None]



def _fm_global_emulated(x, w1, v):
    """csrc/fm.cu's global kernel in f32 torch: the folded coefficients of
    the coefficient kernel (a = w1, c = -vv/2, vv by fma over all k factors
    in order), D zero-padded to chunks of 128 and k to groups of 8 (a and c
    zero past the first group); lane l's partial sums over columns
    128 c + 4 l + q, chunk by chunk and q = 0..3 within each, summed over the
    32 lanes in the order 16, 8, 4, 2, 1 once a group; s_j^2 over the
    factors in the order 4, 2, 1; t and sq summed over the groups in order;
    out = fma(0.5, sq, t)."""
    B, D = x.shape
    k = v.shape[1]
    cols, groups = 128 * -(-D // 128), -(-k // 8)
    vv = torch.zeros(D)
    for j in range(k):
        vv = _fma(v[:, j], v[:, j], vv)
    a, c = torch.zeros(cols), torch.zeros(cols)
    a[:D], c[:D] = w1[:, 0], -0.5 * vv
    vp = torch.zeros(cols, 8 * groups)
    vp[:D, :k] = v
    xp = torch.zeros(B, cols)
    xp[:, :D] = x
    # [B, chunk, lane, q] and [chunk, lane, q]: column 128 c + 4 l + q
    xq = xp.view(B, cols // 128, 32, 4)
    t_row, sq_row = torch.zeros(B), torch.zeros(B)
    for g in range(groups):
        ag = (a if g == 0 else torch.zeros(cols)).view(-1, 32, 4)
        cg = (c if g == 0 else torch.zeros(cols)).view(-1, 32, 4)
        vg = vp[:, 8 * g:8 * g + 8].t().reshape(8, -1, 32, 4)
        t = torch.zeros(B, 32)
        s = torch.zeros(B, 8, 32)
        for ch in range(cols // 128):
            for q in range(4):
                xd = xq[:, ch, :, q]
                t = _fma(xd, _fma(cg[ch, :, q], xd, ag[ch, :, q]), t)
                s = _fma(xd[:, None, :], vg[None, :, ch, :, q], s)
        t, s = _lane_sum(t), _lane_sum(s)
        t_row = t_row + t
        sq_row = sq_row + _lane_sum(s * s)
    return _fma(torch.full_like(sq_row, 0.5), sq_row, t_row)[:, None]


# (B, D, k) that only the global kernel takes: D % 4 != 0 (its 4-byte
# copies), x [16,384, 4,000]'s width, and k=19 (three factor groups)
GLOBAL_SHAPES = [(16, 3419, 8), (16, 4000, 8), (16, 1500, 19)]


@pytest.mark.parametrize("B,D,k", GLOBAL_SHAPES, ids=[f"D{d}_k{k}" for _, d, k in GLOBAL_SHAPES])
def test_global_kernel_arithmetic_holds_the_tolerance(B, D, k):
    """The global kernel's order of sums, emulated in f32, against the
    port's ``fm_ref`` and the JAX package's ``_fm_ref`` and ``fm_fused``
    at the tolerance ``chip_smoke.py`` holds the kernel to, on inputs at
    ``chip_smoke.fm_inputs``' scales; and not bitwise the plain order."""
    rng = np.random.default_rng(D + k)
    x = rng.normal(size=(B, D)).astype(np.float32)
    w1 = (rng.normal(size=(D, 1)) / np.sqrt(D)).astype(np.float32)
    v = (rng.normal(size=(D, k)) / np.sqrt(D)).astype(np.float32)
    tx, tw1, tv = map(torch.from_numpy, (x, w1, v))
    assert not fm_kernel_takes(tx, tw1, tv)
    got = _fm_global_emulated(tx, tw1, tv)
    plain = fm_ref(tx, tw1, tv)
    torch.testing.assert_close(got, plain, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    assert not torch.equal(got, plain)
    for want in (_j_fm_ref(x, w1, v), _j_fm_fused(x, w1, v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)

# chip_smoke.py's check_fm_kernel shapes, at a small batch: (B, D, k) and the
# batch the card checks
KERNEL_SHAPES = [(64, 221, 8, 16_384), (5, 221, 8, 16_385), (31, 221, 8, 31),
                 (1, 1, 1, 1), (64, 13, 64, 4096), (64, 100, 8, 1000), (64, 45, 3, 333),
                 (64, 221, 20, 257), (16, 1500, 8, 64)]
# chip_smoke.py's tolerance for the kernel against the plain version
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("B,D,k,card_B", KERNEL_SHAPES,
                         ids=[f"B{c}_D{d}_k{k}" for _, d, k, c in KERNEL_SHAPES])
def test_kernel_arithmetic_holds_the_tolerance(B, D, k, card_B):
    """The order of sums of the kernel that takes (D, k), emulated in f32,
    against the JAX package's ``_fm_ref`` at the tolerance ``chip_smoke.py``
    holds the kernel to, on inputs at ``chip_smoke.fm_inputs``' scales."""
    rng = np.random.default_rng(card_B + D + k)
    x = rng.normal(size=(B, D)).astype(np.float32)
    w1 = (rng.normal(size=(D, 1)) / np.sqrt(D)).astype(np.float32)
    v = (rng.normal(size=(D, k)) / np.sqrt(D)).astype(np.float32)
    rows_kernel = D <= FM_ROWS_MAX_DIM and k <= FM_ROWS_FACTORS
    emulate = _fm_rows_emulated if rows_kernel else _fm_wide_emulated
    got = emulate(*map(torch.from_numpy, (x, w1, v))).numpy()
    want = np.asarray(_j_fm_ref(x, w1, v))
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_folded_emulation_differs_from_the_plain_order():
    """The emulation computes the folded form, not fm_ref's: on the same
    inputs the two are close but not bitwise equal."""
    rng = np.random.default_rng(0)
    x, w1, v = (torch.from_numpy(a.astype(np.float32)) for a in
                (rng.normal(size=(64, 221)), rng.normal(size=(221, 1)) / 15,
                 rng.normal(size=(221, 8)) / 15))
    got, plain = _fm_rows_emulated(x, w1, v), fm_ref(x, w1, v)
    torch.testing.assert_close(got, plain, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    assert not torch.equal(got, plain)


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


# (B, D, k) at the rows and wide kernels' limits -> taken by them: the
# register kernel up to D=256, k=8, the wide kernel past them while
# 4*D*(2k+1) bytes fit in 232,448; every shape here but the last is taken by
# the global kernel
FM_EDGES = {
    "rows_256": ((64, 256, 8), True),
    "wide_257": ((64, 257, 8), True),
    "wide_3418_k8": ((64, 3418, 8), True),
    "wide_3419_k8": ((64, 3419, 8), False),
    "wide_1500_k18": ((64, 1500, 18), True),
    "wide_1500_k19": ((64, 1500, 19), False),
    "batch_2_31": ((2 ** 31, 12, 4), False),
}


@pytest.mark.parametrize("case", sorted(FM_EDGES))
def test_fm_kernel_takes_at_its_limits(case):
    (B, D, k), taken = FM_EDGES[case]
    args = [torch.empty(s, device="meta") for s in ((B, D), (D, 1), (D, k))]
    assert fm_kernel_takes(*args) is taken
    assert (fm_shared_bytes(D, k) <= MAX_SHARED_BYTES) is (taken or B >= 2 ** 31)
    if taken:
        check_fm_args(*args)
    else:
        with pytest.raises(ValueError):
            check_fm_args(*args)
    if case == "batch_2_31":
        with pytest.raises(ValueError, match="2\\*\\*31"):
            check_fm_global_args(*args)
    else:
        check_fm_global_args(*args)


@pytest.mark.parametrize("case", sorted(_bad_fm_args()))
def test_fm_kernel_takes_nothing_check_rejects(case):
    args, _ = _bad_fm_args()[case]
    assert fm_kernel_takes(*args) is False
