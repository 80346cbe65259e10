"""The port's DIN target attention (``din_attention_ref``, the CPU path of
the ``din_attention_fused`` wrapper, ``din_attention`` and ``DinAttention``)
against the JAX package's: its ``din_attention_ref``, its Pallas
``din_attention_fused`` in interpret mode, their VJP, and Flax's
``DinAttention`` on transplanted weights; and the limits of the kernels'
checks."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recommender_system_tpu.layers.sequence import DinAttention as JDinAttention
from recommender_system_tpu.ops.pallas_kernels import din_attention_fused as j_din_fused
from recommender_system_tpu.ops.pallas_kernels import din_attention_ref as j_din_ref
from recommender_system_tpu_torch.convert import load_jax_params
from recommender_system_tpu_torch.layers.sequence import DinAttention
from recommender_system_tpu_torch.ops.attention import din_attention
from recommender_system_tpu_torch.ops.kernels import (MAX_SHARED_BYTES, _din_global_fault,
                                                      check_din_args,
                                                      check_din_global_args,
                                                      din_attention_fused,
                                                      din_attention_ref,
                                                      din_global_shared_bytes,
                                                      din_global_tiles,
                                                      din_kernel_takes, din_shared_bytes)
from recommender_system_tpu_torch.ops.seqpool import NEG_INF

# the same f32 operations on both sides, summed in another order
REF_RTOL, REF_ATOL = 1e-5, 1e-6
# against the Pallas kernel, as the JAX package's own tests hold it
PALLAS_RTOL, PALLAS_ATOL = 1e-4, 1e-4
# gradients: chained sums over T and the batch
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# the CUDA kernel against its plain version (chip_smoke.py)
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5

FLAGS = [(a, wn, rs) for a in ("sigmoid", "relu") for wn in (True, False)
         for rs in (False, True)]
FLAG_IDS = [f"{a}-{'softmax' if wn else 'raw'}-{'scores' if rs else 'pooled'}"
            for a, wn, rs in FLAGS]


def _inputs(B=32, T=6, K=8, H1=10, H2=5, seed=0, all_masked=(0,)):
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


def _port(fn, q, keys, mask, weights, flags):
    args = [torch.from_numpy(a) for a in (q, keys, *weights)]
    with torch.inference_mode():
        return fn(args[0], args[1], torch.from_numpy(mask), *args[2:], *flags).numpy()


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_din_attention_ref_matches_jax(flags):
    q, keys, mask, weights = _inputs()
    want = np.asarray(j_din_ref(q, keys, jnp.asarray(mask), *weights, *flags))
    got = _port(din_attention_ref, q, keys, mask, weights, flags)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=REF_RTOL, atol=REF_ATOL)


@functools.lru_cache(maxsize=None)
def _pallas(flags):
    q, keys, mask, weights = _inputs(seed=1)
    return np.asarray(j_din_fused(q, keys, jnp.asarray(mask, jnp.float32), *weights, *flags))


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_din_attention_fused_cpu_matches_pallas(flags):
    q, keys, mask, weights = _inputs(seed=1)
    before = din_attention_fused.launches
    got = _port(din_attention_fused, q, keys, mask.astype(np.float32), weights, flags)
    assert din_attention_fused.launches == before  # the CPU launches nothing
    np.testing.assert_allclose(got, _pallas(flags), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_din_attention_fused_gradients_match_jax(flags):
    """The autograd Function's backward against the VJP of the JAX package's
    ``din_attention_fused`` (the VJP of its reference), one cotangent."""
    q, keys, mask, weights = _inputs(B=16, T=5, seed=2)
    rng = np.random.default_rng(3)
    maskf = mask.astype(np.float32)
    out, vjp = jax.vjp(lambda *a: j_din_fused(a[0], a[1], maskf, *a[2:], *flags),
                       q, keys, *weights)
    cot = rng.normal(size=out.shape).astype(np.float32)
    want = vjp(jnp.asarray(cot))

    args = [torch.tensor(a, requires_grad=True) for a in (q, keys, *weights)]
    t_mask = torch.tensor(maskf, requires_grad=True)
    got = din_attention_fused(args[0], args[1], t_mask, *args[2:], *flags)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    for a, w in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    # the mask has no cotangent: None, not a tensor of zeros
    assert t_mask.grad is None


@pytest.mark.parametrize("return_scores", [False, True], ids=["pooled", "scores"])
@pytest.mark.parametrize("fn", [din_attention_ref, din_attention_fused],
                         ids=["ref", "fused_cpu"])
def test_all_masked_row_is_the_mean_key(fn, return_scores):
    """NEG_INF is finite: a row with no valid position gets weights of
    exactly 1/T, so it pools the mean of its (padding) keys, as in JAX."""
    T = 6
    q, keys, mask, weights = _inputs(T=T, seed=4, all_masked=(0, 5))
    flags = ("sigmoid", True, return_scores)
    got = _port(fn, q, keys, mask, weights, flags)
    want = np.asarray(j_din_ref(q, keys, jnp.asarray(mask), *weights, *flags))
    for row in (0, 5):
        expect = np.full(T, 1.0 / T, np.float32) if return_scores else keys[row].mean(0)
        np.testing.assert_allclose(got[row], expect, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(want[row], expect, rtol=1e-6, atol=1e-7)


def test_din_attention_dispatch():
    q, keys, mask, weights = _inputs(seed=5)
    flags = ("relu", True, False)
    want = _port(din_attention_ref, q, keys, mask, weights, flags)
    args = [torch.from_numpy(a) for a in (q, keys, *weights)]
    for use_pallas in (None, True, False):
        got = din_attention(args[0], args[1], torch.from_numpy(mask), *args[2:], "relu",
                            use_pallas=use_pallas)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.warns(UserWarning, match="ignored"):
        din_attention(args[0], args[1], torch.from_numpy(mask), *args[2:],
                      dtype=torch.bfloat16)
    # remat=True takes the same path: the backward kernel's design, the
    # scorer recomputed from the inputs and the saved weights
    got = din_attention(args[0], args[1], torch.from_numpy(mask), *args[2:], "relu",
                        remat=True)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ DinAttention

LAYER_CASES = {
    "fusable_sigmoid": dict(),
    "fusable_relu_scores": dict(activation="relu", return_score=True),
    "fusable_raw_weights": dict(weight_normalization=False),
    "dice": dict(activation="dice"),
    "prelu": dict(activation="prelu"),
    "three_layers": dict(hidden_units=(10, 6, 5)),
    "dice_raw_scores": dict(activation="dice", weight_normalization=False,
                            return_score=True),
}


def _redraw(tree, rng, std=0.3):
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, std, np.shape(a)).astype(np.float32), tree)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_din_attention_layer_matches_flax(case, train):
    kw = dict(LAYER_CASES[case])
    kw.setdefault("hidden_units", (10, 5))
    q, keys, mask, _ = _inputs(seed=6)
    rng = np.random.default_rng(7)
    jlayer = JDinAttention(**kw)
    variables = jlayer.init(jax.random.PRNGKey(0), q, keys, mask)
    params = _redraw(variables["params"], rng)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
        variables.get("batch_stats", {}))
    jvars = {"params": params, "batch_stats": stats}
    if train:
        want, mutated = jlayer.apply(jvars, q, keys, mask, train=True,
                                     mutable=["batch_stats"])
    else:
        want = jlayer.apply(jvars, q, keys, mask)

    layer = DinAttention(keys.shape[-1], device=torch.device("cpu"),
                         generator=torch.Generator().manual_seed(0), **kw)
    assert layer.fusable == case.startswith("fusable")
    load_jax_params(layer, params, stats).train(train)
    got = layer(torch.from_numpy(q), torch.from_numpy(keys), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if train and stats:
        moved = _port_stats(layer)
        for path, value in _flat(mutated["batch_stats"]).items():
            np.testing.assert_allclose(moved[path], value, rtol=1e-5, atol=1e-6,
                                       err_msg=path)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[".".join(prefix + ({"mean": "running_mean", "var": "running_var"}[k],))] = \
                np.asarray(v)
    return out


def _port_stats(module):
    return {n: b.numpy() for n, b in module.named_buffers()}


# ------------------------------------------------------------ the wrapper

def _bad_args():
    q, keys, mask, weights = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                              else [torch.from_numpy(w) for w in a]
                              for a in _inputs(B=4, T=3, K=8, H1=10, H2=5))
    maskf = mask.float()
    w1, b1, w2, b2, w3, b3 = weights
    ok = [q, keys, maskf, w1, b1, w2, b2, w3, b3]

    def replace(i, t):
        args = list(ok)
        args[i] = t
        return args

    return {
        "f64_keys": (replace(1, keys.double()), TypeError),
        "bool_mask": (replace(2, mask), TypeError),
        "non_contiguous_query": (replace(0, torch.zeros(8, 4).t()), ValueError),
        "keys_2d": (replace(1, keys[:, 0]), ValueError),
        "w1_not_4k": (replace(3, torch.zeros(30, 10)), ValueError),
        "mask_shape": (replace(2, maskf[:, :2].contiguous()), ValueError),
        "w3_shape": (replace(7, torch.zeros(5)), ValueError),
        "b3_shape": (replace(8, torch.zeros(2)), ValueError),
        "query_batch": (replace(0, q[:3].contiguous()), ValueError),
        "too_wide": ([q, keys, maskf, torch.zeros(32, 257), torch.zeros(257),
                      torch.zeros(257, 5), b2, w3, b3], ValueError),
        "too_much_shared_memory": ([q, torch.zeros(4, 8000, 8), torch.zeros(4, 8000), w1,
                                    b1, w2, b2, w3, b3], ValueError),
        "empty_history": ([q, torch.zeros(4, 0, 8), torch.zeros(4, 0), w1, b1, w2, b2,
                           w3, b3], ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_args()))
def test_din_kernel_rejects(case):
    args, error = _bad_args()[case]
    with pytest.raises(error):
        check_din_args(*args, "sigmoid")


def test_din_kernel_accepts_bench_shape_and_rejects_other_activations():
    B, T, K, H1, H2 = 8192, 50, 32, 80, 40
    args = [torch.empty(s) for s in ((B, K), (B, T, K), (B, T), (4 * K, H1), (H1,),
                                     (H1, H2), (H2,), (H2, 1), (1,))]
    check_din_args(*args, "sigmoid")
    check_din_args(*args, "relu")
    with pytest.raises(ValueError, match="activation"):
        check_din_args(*args, "dice")
    # the bench shape needs the opt-in past 48 KB, even at one row a group;
    # groups of 5 rows (250 positions, 16 m-tiles of 16) fit, 10 do not
    assert 48 * 1024 < din_shared_bytes(T, K, H1, H2) <= MAX_SHARED_BYTES
    assert din_shared_bytes(T, K, H1, H2, rows=5) <= MAX_SHARED_BYTES
    assert din_shared_bytes(T, K, H1, H2, rows=10) > MAX_SHARED_BYTES
    assert din_shared_bytes(8000, 8, 10, 5) > MAX_SHARED_BYTES


# ------------------------------------------------------------ 3xTF32

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    does: to nearest, ties away from zero. IEEE floats are sign and
    magnitude, so adding half a unit of the 13 dropped bits to the int32
    pattern rounds the magnitude, and a carry moves into the exponent."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    big = _tf32(x)
    return big, _tf32(x - big)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's products: a_small b_big + a_big b_small + a_big b_big,
    TF32 operands (each product exact in f32), f32 sums."""
    (a_big, a_small), (b_big, b_small) = _split(a), _split(b)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass."""
    return _tf32(a) @ _tf32(b)


def _din_emulated(mm, q, keys, mask, w1, b1, w2, b2, w3, b3, activation,
                  weight_normalization, return_scores):
    """``csrc/din_attention.cu``'s arithmetic with its two scorer products
    through ``mm``: layer 1 ``[k | q*k] @ [Wk-Wm ; Wp]`` plus ``q (Wq+Wm)``
    and ``b1`` per row, layer 2 ``h1 @ W2``; the rest f32, as the kernel."""
    act = torch.sigmoid if activation == "sigmoid" else torch.relu
    K = keys.shape[-1]
    wq, wk, wm, wp = w1[:K], w1[K:2 * K], w1[2 * K:3 * K], w1[3 * K:]
    ck = torch.cat([keys, q[:, None, :] * keys], dim=-1)
    h1 = act((q @ (wq + wm))[:, None, :] + mm(ck, torch.cat([wk - wm, wp], dim=0)) + b1)
    h2 = act(mm(h1, w2) + b2)
    score = (h2 @ w3 + b3)[..., 0]
    if weight_normalization:
        score = torch.softmax(torch.where(mask, score, NEG_INF), dim=-1)
    else:
        score = torch.where(mask, score, 0.0)
    return score if return_scores else torch.einsum("bt,btk->bk", score, keys)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_3xtf32_products_hold_the_kernel_tolerance(flags):
    """At DIN's widths (K=32, 80-40, T=50) the kernel's 3xTF32 products
    stay within the tolerance ``chip_smoke.py`` holds the kernel to against
    JAX's f32 ``din_attention_ref``; a single TF32 pass does not, as the
    raw scores, where the products' error shows undamped, make plain."""
    activation = flags[0]
    q, keys, mask, weights = _inputs(B=6, T=50, K=32, H1=80, H2=40, seed=8)
    args = [torch.from_numpy(a) for a in (q, keys, mask, *weights)]
    want = np.asarray(j_din_ref(q, keys, jnp.asarray(mask), *weights, *flags))
    three = _din_emulated(_mm_3xtf32, *args, *flags).numpy()
    np.testing.assert_allclose(three, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    raw = (activation, False, True)
    want_raw = np.asarray(j_din_ref(q, keys, jnp.asarray(mask), *weights, *raw))
    one = _din_emulated(_mm_tf32, *args, *raw).numpy()
    assert not np.allclose(one, want_raw, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_tf32_rounding_is_rna():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12,
                      1.0 + 2.0 ** -12, 3.0, -0.0], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -10, 1.0, 3.0, -0.0]
    assert _tf32(x).tolist() == want
    big, small = _split(x)
    assert torch.equal(big + small, x)


def _din_meta(B, T, K, H1=80, H2=40):
    return [torch.empty(s, device="meta") for s in
            ((B, K), (B, T, K), (B, T), (4 * K, H1), (H1,), (H1, H2), (H2,), (H2, 1), (1,))]


# (T, K) with the (80, 40) scorer at the tiled kernel's shared-memory edges
# -> taken by it; the global kernel takes them all
DIN_EDGES = {
    "k32_t50": ((50, 32), True),
    "k32_t514": ((514, 32), True),
    "k32_t515": ((515, 32), False),
    "k64_t185": ((185, 64), True),
    "k64_t186": ((186, 64), False),
    "k128_t1": ((1, 128), False),
    "k128_t50": ((50, 128), False),
    "k64_t200": ((200, 64), False),
    "k32_t1000": ((1000, 32), False),
}


@pytest.mark.parametrize("case", sorted(DIN_EDGES))
def test_din_kernel_takes_at_its_limits(case):
    (T, K), taken = DIN_EDGES[case]
    args = _din_meta(64, T, K)
    assert din_kernel_takes(*args, "sigmoid") is taken
    assert (din_shared_bytes(T, K, 80, 40) <= MAX_SHARED_BYTES) is taken
    if taken:
        check_din_args(*args, "sigmoid")
    else:
        with pytest.raises(ValueError, match="shared memory"):
            check_din_args(*args, "sigmoid")
    check_din_global_args(*args, "sigmoid")


@pytest.mark.parametrize("case", sorted(_bad_args()))
def test_din_kernel_takes_nothing_check_rejects(case):
    args, _ = _bad_args()[case]
    assert din_kernel_takes(*args, "sigmoid") is False


def test_din_kernel_takes_no_other_activation_width_or_layout():
    args = _din_meta(64, 50, 32)
    assert din_kernel_takes(*args, "relu")
    assert not din_kernel_takes(*args, "dice")
    assert not din_kernel_takes(*_din_meta(64, 50, 32, H1=257), "sigmoid")
    keys_t = torch.empty(64, 32, 50, device="meta").transpose(1, 2)
    assert not din_kernel_takes(args[0], keys_t, *args[2:], "sigmoid")


def test_din_global_kernel_limits():
    """The global kernel takes any T and hidden width: its least shared
    memory (one row a group, one chunk of each layer's weights) grows only
    with K and H1, and it refuses where that does not fit."""
    check_din_global_args(*_din_meta(4, 50, 32, H1=1024, H2=512), "relu")
    check_din_global_args(*_din_meta(4, 60_000, 8), "sigmoid")
    # K=128, 80-40, chunks of 10 n-tiles, every chunk staged: W1 [8 blocks
    # x 4 k-tiles x 10 n-tiles] and W2 [10 x 5 n-tiles] of 32 lanes' uint4,
    # 16 rows' queries and per-row terms, 4 floats a thread (12 warps) for
    # the sums
    assert din_global_tiles(80) == 10
    assert din_global_shared_bytes(128, 80, 40, rows=16, resident=True) == 4 * (
        8 * 4 * 10 * 128 + 10 * 5 * 128 + 16 * 128 + 16 * 80 + 4 * 384)
    assert din_global_shared_bytes(128, 80, 40, rows=16, resident=True) <= MAX_SHARED_BYTES
    assert din_global_shared_bytes(128, 80, 40) == 4 * (
        4 * 10 * 128 + 10 * 5 * 128 + 128 + 80 + 4 * 384)
    assert din_global_shared_bytes(128, 80, 40, jb=3) == 4 * (
        3 * 4 * 10 * 128 + 10 * 5 * 128 + 128 + 80 + 4 * 384)
    # the widest h-chunk takes 8 warps; H2 past 40 takes z-chunks of 5 n-tiles
    assert din_global_tiles(128) == 16
    assert din_global_shared_bytes(32, 128, 64) == 4 * (
        4 * 16 * 128 + 16 * 5 * 128 + 32 + 128 + 4 * 256)
    far = _din_meta(4, 50, 60_000)
    assert din_global_shared_bytes(60_000, 80, 40) > MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        check_din_global_args(*far, "sigmoid")
    with pytest.raises(ValueError, match="activation"):
        check_din_global_args(*_din_meta(4, 50, 32), "dice")


def _old_global_bytes(T, K, H1):
    """Shared memory of the global kernel before its tensor-core design,
    at one warp: the row's query, per-row term and scores, and a warp's [k
    | q*k] and first-layer output for 8 positions."""
    def up(x):
        return -(-x // 4) * 4

    return 4 * (up(K) + up(H1) + up(T) + 8 * (2 * K + H1))


def _old_edge(**fixed):
    """The largest value of the one size not in ``fixed`` (T, K or H1) that
    the old global kernel took."""
    free = ({"T", "K", "H1"} - fixed.keys()).pop()
    n = 1
    while _old_global_bytes(**{**fixed, free: 2 * n}) <= MAX_SHARED_BYTES:
        n *= 2
    lo, hi = n, 2 * n
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _old_global_bytes(**{**fixed, free: mid}) <= MAX_SHARED_BYTES \
            else (lo, mid)
    return {**fixed, free: lo}


# shapes the old global kernel took, at the edges of its shared memory
OLD_GLOBAL_SHAPES = {
    "longest_history": lambda: _old_edge(K=1, H1=1),
    "widest_keys": lambda: _old_edge(T=1, H1=1),
    "widest_layer1": lambda: _old_edge(T=1, K=1),
    "k128_t50": lambda: _old_edge(T=50, K=128),
    "mixed": lambda: _old_edge(T=20_000, H1=2_000),
}


@pytest.mark.parametrize("H2", [1, 40, 4096])
@pytest.mark.parametrize("case", sorted(OLD_GLOBAL_SHAPES))
def test_din_global_kernel_takes_what_the_old_one_took(case, H2):
    shape = OLD_GLOBAL_SHAPES[case]()
    assert _old_global_bytes(**shape) <= MAX_SHARED_BYTES
    args = _din_meta(3, shape["T"], shape["K"], H1=shape["H1"], H2=H2)
    assert _din_global_fault(*args, "sigmoid") is None
    assert _din_global_fault(*args, "relu") is None
