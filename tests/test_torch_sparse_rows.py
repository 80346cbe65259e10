"""The port's sorted id streams and sparse row updates (``ops/stream_sort.py``,
``ops/fused_adagrad.py``, ``ops/embedding_grad.py``) against the JAX
package's: ``blocked_sort``, the plain references, and the Pallas kernels in
interpret mode. On the CPU the wrappers run their plain versions."""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recommender_system_tpu.layers.embedding import unpack_stack as j_unpack_stack
from recommender_system_tpu.ops.embedding_grad import scatter_add_dense as j_scatter_add_dense
from recommender_system_tpu.ops.embedding_grad import scatter_add_dense_ref as j_scatter_ref
from recommender_system_tpu.ops.fused_adagrad import fused_adagrad_apply as j_fused_adagrad_apply
from recommender_system_tpu.ops.fused_adagrad import fused_adagrad_ref as j_fused_adagrad_ref
from recommender_system_tpu.ops.fused_adagrad import fused_adam_apply as j_fused_adam_apply
from recommender_system_tpu.ops.fused_adagrad import fused_sgd_apply as j_fused_sgd_apply
from recommender_system_tpu.ops.stream_sort import blocked_sort as j_blocked_sort
from recommender_system_tpu_torch.convert import unpack_stack
from recommender_system_tpu_torch.ops import kernels
from recommender_system_tpu_torch.ops.embedding_grad import (
    scatter_add_chunked_ref, scatter_add_dense_ref, scatter_add_sorted, take_fast)
from recommender_system_tpu_torch.ops.fused_adagrad import (
    fused_adagrad_apply, fused_adagrad_ref, fused_adam_apply, fused_adam_ref, fused_sgd_apply)
from recommender_system_tpu_torch.ops.kernels import SPARSE_CHUNK, check_sparse_rows_args
from recommender_system_tpu_torch.ops.stream_sort import blocked_sort, sort_ids

LR, EPS = 0.05, 1e-7
ADAM_LR = 1e-2
# the same f32 operations in the same order on both sides: only XLA's and
# PyTorch's rsqrt may differ, by an ulp
REF_RTOL, REF_ATOL = 1e-6, 1e-7
# against the Pallas kernels: both sides sum the same bf16-rounded
# cotangents in f32, in another order (one-hot matrix products)
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6


# every JAX function is jitted, as the JAX package's own tests call them:
# run op by op, each call would compile its operations one at a time
_j_blocked_sort = jax.jit(j_blocked_sort, static_argnums=(1,))


def _j_sort(rows, ranges):
    return _j_blocked_sort(jnp.asarray(rows), tuple(map(tuple, ranges)))


# ------------------------------------------------------------ blocked_sort

def _rows(ranges, B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([o + rng.integers(0, v, B) for o, v in ranges], axis=1)


SORT_CASES = {
    "disjoint": ([(0, 100), (100, 37), (137, 250)], 64),
    "unsorted_offsets": ([(137, 250), (0, 100), (100, 37)], 64),
    "packed_row_neighbours": ([(0, 13), (13, 29), (42, 5)], 32),
    "shared_tables": ([(0, 50), (50, 20), (0, 50), (50, 20)], 48),
    "one_column": ([(7, 900)], 257),
    "bench_layout": ([(f * 1000, 1000) for f in range(26)], 256),
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_blocked_sort_matches_jax(case):
    ranges, B = SORT_CASES[case]
    rows = _rows(ranges, B, seed=len(case))
    want = _j_sort(rows, ranges)
    got = blocked_sort(torch.from_numpy(rows), ranges)
    assert want is not None and got is not None
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    slid, order = got
    np.testing.assert_array_equal(slid.numpy(), rows.reshape(-1)[order.numpy()])


def test_blocked_sort_one_dimensional_ids():
    ids = 7 + np.random.default_rng(3).integers(0, 900, 257)
    want = _j_sort(ids, [(7, 900)])
    got = blocked_sort(torch.from_numpy(ids), [(7, 900)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ranges", [[(0, 10), (5, 10)], [(0, 10), (0, 10), (10, 10)]],
                         ids=["partial_overlap", "ragged_groups"])
def test_blocked_sort_refuses_like_jax(ranges):
    rows = _rows(ranges, 8, seed=4)
    assert _j_sort(rows, ranges) is None
    assert blocked_sort(torch.from_numpy(rows), ranges) is None


def test_blocked_sort_past_int31_equals_stable_sort():
    # 22 id bits + 11 index bits: over JAX's int31 budget, inside int64's
    ranges = [(0, 2 ** 22), (2 ** 22, 2 ** 22)]
    rows = _rows(ranges, 1024, seed=5)
    rows[:40, 0] = rows[0, 0]  # duplicates: the order among them must be stable
    assert _j_sort(rows, ranges) is None
    slid, order = blocked_sort(torch.from_numpy(rows), ranges)
    want_slid, want_order = sort_ids(torch.from_numpy(rows))
    torch.testing.assert_close(slid, want_slid, rtol=0, atol=0)
    torch.testing.assert_close(order, want_order, rtol=0, atol=0)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(rows.reshape(-1), kind="stable"))


def test_embedding_collection_keeps_its_sort_layout():
    """The lookup's layout is built once, with the collection: its tensors
    are buffers that ``.to()`` moves and ``state_dict`` leaves out, and its
    sort equals ``blocked_sort`` of the same rows."""
    from recommender_system_tpu_torch.layers.embedding import EmbeddingCollection
    from recommender_system_tpu_torch.utils.features import SparseFeat

    cols = [SparseFeat(f"C{i}", vocabulary_size=v, embedding_dim=4)
            for i, v in enumerate([40, 25, 35])]
    coll = EmbeddingCollection(cols, device=torch.device("cpu"),
                               generator=torch.Generator().manual_seed(0))
    assert set(coll.state_dict()) == {"table_d4"}
    assert {n for n, _ in coll.named_buffers()} == {
        "sort_layouts.4.offsets", "sort_layouts.4.cols"}
    ranges = [(0, 40), (40, 25), (65, 35)]
    rows = torch.from_numpy(_rows(ranges, 64, seed=8))
    for got, want in zip(coll._layout(4)(rows), blocked_sort(rows, ranges)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    coll.to("meta")
    assert {b.device.type for b in coll.buffers()} == {"meta"}


# ------------------------------------------------- plain references vs JAX

def _stream(rows, n, dim, seed, hot=None):
    rng = np.random.default_rng(seed)
    lids = rng.integers(0, rows, n).astype(np.int32)
    if hot is not None:
        lids[::2] = hot  # half the stream on one row
    ct = rng.normal(size=(n, dim)).astype(np.float32)
    return lids, ct


REF_CASES = {
    # (pack, dim, physical rows, N, hot row)
    "unpacked_d128": (1, 128, 64, 300, None),
    "unpacked_d8": (1, 8, 100, 513, None),
    "packed_d9": (14, 9, 128, 513, None),
    "packed_d8": (16, 8, 64, 700, None),
    "hot_row": (14, 9, 64, 1000, 5),
}


def _jax_table(pack, dim, rows_phys, seed):
    rng = np.random.default_rng(seed)
    lanes = 128 if pack > 1 else dim
    stack = rng.normal(size=(rows_phys, lanes)).astype(np.float32)
    acc = (0.1 + rng.uniform(size=(rows_phys, lanes))).astype(np.float32)
    return stack, acc


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_fused_adagrad_ref_matches_jax(case):
    pack, dim, rows_phys, n, hot = REF_CASES[case]
    stack, acc = _jax_table(pack, dim, rows_phys, seed=1)
    rows = rows_phys * pack
    lids, ct = _stream(rows, n, dim, seed=2, hot=hot)
    want_s, want_a = jax.jit(functools.partial(
        j_fused_adagrad_ref, pack=pack, dim=dim, lr=LR, eps=EPS))(
            jnp.asarray(stack), jnp.asarray(acc), jnp.asarray(lids), jnp.asarray(ct))
    table = torch.from_numpy(unpack_stack(stack, rows, dim).copy())
    table_acc = torch.from_numpy(unpack_stack(acc, rows, dim).copy())
    got_t, got_a = fused_adagrad_ref(table, table_acc, torch.from_numpy(lids).long(),
                                     torch.from_numpy(ct), LR, EPS)
    np.testing.assert_allclose(got_t.numpy(), unpack_stack(np.asarray(want_s), rows, dim),
                               rtol=REF_RTOL, atol=REF_ATOL)
    np.testing.assert_allclose(got_a.numpy(), unpack_stack(np.asarray(want_a), rows, dim),
                               rtol=REF_RTOL, atol=REF_ATOL)
    untouched = np.setdiff1d(np.arange(rows), lids)
    np.testing.assert_array_equal(got_t.numpy()[untouched], table.numpy()[untouched])
    np.testing.assert_array_equal(got_a.numpy()[untouched], table_acc.numpy()[untouched])


def test_fused_adagrad_sums_duplicates_before_squaring():
    table, acc = torch.zeros(8, 4), torch.zeros(8, 4)
    lids = torch.tensor([3, 3, 3])
    fused_adagrad_apply(table, acc, lids, torch.ones(3, 4), lr=1.0)
    # g = 3 -> acc = 9, p = -3 / sqrt(9 + eps)
    torch.testing.assert_close(acc[3], torch.full((4,), 9.0), rtol=0, atol=0)
    torch.testing.assert_close(table[3], torch.full((4,), -3 / np.sqrt(9 + 1e-7),
                                                    dtype=torch.float32))
    assert torch.equal(table[[0, 1, 2, 4, 5, 6, 7]], torch.zeros(7, 4))


@pytest.mark.parametrize("N,rows,dim", [(1000, 64, 8), (513, 1000, 128), (4096, 300, 9),
                                        (1, 50, 9)])
def test_scatter_add_ref_matches_jax(N, rows, dim):
    lids, ct = _stream(rows, N, dim, seed=N)
    want = jax.jit(j_scatter_ref, static_argnums=(2,))(jnp.asarray(lids), jnp.asarray(ct),
                                                       rows)
    got = scatter_add_dense_ref(torch.from_numpy(lids).long(), torch.from_numpy(ct), rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REF_RTOL, atol=REF_ATOL)


# ------------------------------------------ wrappers vs the Pallas kernels

_j_scatter_add_dense = jax.jit(
    lambda ids, g, rows: j_scatter_add_dense(ids, g, rows, tile_rows=128, chunk=256),
    static_argnums=(2,))


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _pallas_adagrad(case):
    """The case's inputs and the Pallas kernel's result (interpret mode)."""
    pack, dim, rows_phys, n, hot = REF_CASES[case]
    stack, acc = _jax_table(pack, dim, rows_phys, seed=3)
    lids, ct = _stream(rows_phys * pack, n, dim, seed=4, hot=hot)
    # the Pallas kernel rounds the cotangents to bf16; round both sides
    ct = _bf16(ct)
    want = jax.jit(lambda s, a, i, c: j_fused_adagrad_apply(
        s, a, i, c, pack=pack, dim=dim, lr=LR, eps=EPS, tile_rows=64, chunk=128))(
            jnp.asarray(stack), jnp.asarray(acc), jnp.asarray(lids), jnp.asarray(ct))
    return stack, acc, lids, ct, [np.asarray(w) for w in want]


@pytest.mark.parametrize("presort", [False, True], ids=["sorted_here", "presorted"])
@pytest.mark.parametrize("case", ["packed_d9", "packed_d8", "unpacked_d128", "hot_row"])
def test_fused_adagrad_apply_matches_pallas(case, presort):
    pack, dim, rows_phys, _, _ = REF_CASES[case]
    rows = rows_phys * pack
    stack, acc, lids, ct, (want_s, want_a) = _pallas_adagrad(case)
    table = torch.from_numpy(unpack_stack(stack, rows, dim).copy())
    table_acc = torch.from_numpy(unpack_stack(acc, rows, dim).copy())
    t_lids = torch.from_numpy(lids).long()
    presorted = sort_ids(t_lids) if presort else None
    before = fused_adagrad_apply.launches
    out = fused_adagrad_apply(table, table_acc, t_lids, torch.from_numpy(ct), lr=LR,
                              eps=EPS, presorted=presorted)
    assert out[0] is table and out[1] is table_acc  # in place
    assert fused_adagrad_apply.launches == before  # the CPU launches nothing
    np.testing.assert_allclose(table.numpy(), j_unpack_stack(want_s, rows, dim),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    np.testing.assert_allclose(table_acc.numpy(), j_unpack_stack(want_a, rows, dim),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.parametrize("N,rows,dim", [(1000, 64, 8), (513, 1000, 128), (4096, 300, 9),
                                        (7, 2048, 16)])
def test_scatter_add_sorted_matches_pallas(N, rows, dim):
    lids, ct = _stream(rows, N, dim, seed=N + 1)
    ct = _bf16(ct)
    want = _j_scatter_add_dense(jnp.asarray(lids), jnp.asarray(ct), rows)
    slid, order = sort_ids(torch.from_numpy(lids))
    before = scatter_add_sorted.launches
    got = scatter_add_sorted(slid, order, torch.from_numpy(ct), rows)
    assert scatter_add_sorted.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_scatter_add_sorted_hot_row_matches_pallas():
    rng = np.random.default_rng(1)
    lids = np.full(5000, 37, np.int32)
    ct = _bf16(rng.normal(size=(5000, 8)).astype(np.float32))
    want = _j_scatter_add_dense(jnp.asarray(lids), jnp.asarray(ct), 256)
    got = scatter_add_sorted(*sort_ids(torch.from_numpy(lids)), torch.from_numpy(ct), 256)
    # a 5000-term sum of unit normals: f32 rounding of the running sum
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------- take_fast

@pytest.mark.parametrize("presort", [False, True], ids=["sorted_here", "presorted"])
def test_take_fast_gradient_equals_autograd(presort):
    rng = np.random.default_rng(6)
    ranges = [(0, 40), (40, 25), (65, 35)]
    rows2d = torch.from_numpy(_rows(ranges, 64, seed=7))
    table = torch.from_numpy(rng.normal(size=(100, 9)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(64 * 3, 9)).astype(np.float32))
    rows = rows2d.reshape(-1)

    a = table.clone().requires_grad_(True)
    presorted = blocked_sort(rows2d, ranges) if presort else None
    out = take_fast(a, rows, presorted)
    (out * ct).sum().backward()
    b = table.clone().requires_grad_(True)
    (b[rows] * ct).sum().backward()
    torch.testing.assert_close(out.detach(), table[rows], rtol=0, atol=0)
    # both sum each row's cotangents in stream order
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- the wrappers

def _bad_sparse_args():
    slid = torch.arange(4)
    order = torch.arange(4)
    ct = torch.zeros(4, 9)
    table = torch.zeros(10, 9)
    return {
        "int32_ids": ((slid.int(), order, ct, table), TypeError),
        "2d_order": ((slid, order[:, None], ct, table), TypeError),
        "f64_ct": ((slid, order, ct.double(), table), TypeError),
        "lengths_differ": ((slid[:3], order, ct, table), ValueError),
        "table_width": ((slid, order, ct, torch.zeros(10, 8)), ValueError),
        "tables_differ": ((slid, order, ct, table, torch.zeros(11, 9)), ValueError),
        "non_contiguous": ((slid, order, torch.zeros(9, 4).t(), table), ValueError),
        "zero_dim": ((slid, order, torch.zeros(4, 0), torch.zeros(10, 0)), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_sparse_args()))
def test_sparse_row_kernels_reject(case):
    args, error = _bad_sparse_args()[case]
    with pytest.raises(error):
        check_sparse_rows_args(*args)


def test_sparse_row_kernels_accept_bench_shape():
    n, rows = 425_984, 2_600_000
    ids = torch.empty(n, dtype=torch.int64)
    check_sparse_rows_args(ids, ids, torch.empty(n, 9), torch.empty(rows, 9),
                           torch.empty(rows, 9))


def test_wrappers_neither_launch_nor_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device raises: no
    wrapper runs its plain version for it."""
    meta = {"slid": torch.empty(4, dtype=torch.int64, device="meta"),
            "ct": torch.empty(4, 9, device="meta"),
            "table": torch.empty(10, 9, device="meta")}
    with pytest.raises(ValueError, match="no kernel"):
        scatter_add_sorted(meta["slid"], meta["slid"], meta["ct"], 10)
    with pytest.raises(ValueError, match="no kernel"):
        fused_adagrad_apply(meta["table"], meta["table"], meta["slid"], meta["ct"], lr=LR)
    with pytest.raises(ValueError, match="different devices"):
        scatter_add_sorted(meta["slid"], torch.arange(4), torch.zeros(4, 9), 10)


# ------------------------------------ the long path's order (chunks, shares)

def _long_lids(rows, seed, chunk=SPARSE_CHUNK):
    """Ids whose sorted stream holds long segments (at least ``chunk``
    positions) at the stream's start and end, back to back and of lengths
    chunk - 1, chunk, chunk + 1 and 2 * chunk +- 1, among short ones, in
    random order."""
    lengths = [3 * chunk + 1, 5, chunk - 1, chunk, 2, chunk + 1, 2 * chunk - 1, 7,
               2 * chunk + 1, chunk, 3 * chunk + 7, 1, 40, 2 * chunk + 5]
    segment_rows = np.random.default_rng(seed).choice(rows, len(lengths), replace=False)
    lids = np.repeat(np.sort(segment_rows), lengths)
    np.random.default_rng(seed + 1).shuffle(lids)
    return lids


def _chunk_order_numpy(slid, order, ct, rows, chunk, shares):
    """The order the card's scatter-add sums in, written out with numpy
    float32 adds: a segment shorter than ``chunk`` in stream order from 0; a
    longer one cut at the multiples of ``chunk``, each piece so, share q the
    pieces q, q + shares, ... from 0, then ((s0+s1)+(s2+s3))+((s4+s5)+(s6+s7))."""
    out = np.zeros((rows, ct.shape[1]), np.float32)
    bounds = np.flatnonzero(np.diff(slid)) + 1
    for a, b in zip(np.r_[0, bounds], np.r_[bounds, slid.size]):
        cuts = [a] + ([m for m in range(a + 1, b) if m % chunk == 0] if b - a >= chunk
                      else []) + [b]
        pieces = []
        for p, q in zip(cuts[:-1], cuts[1:]):
            g = np.zeros(ct.shape[1], np.float32)
            for j in range(p, q):
                g = g + ct[order[j]]
            pieces.append(g)
        if b - a < chunk:
            out[slid[a]] = pieces[0]
            continue
        acc = [np.zeros(ct.shape[1], np.float32) for _ in range(shares)]
        for i, piece in enumerate(pieces):
            acc[i % shares] = acc[i % shares] + piece
        out[slid[a]] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5])
                                                                  + (acc[6] + acc[7]))
    return out


def test_sparse_chunk_constants_are_the_kernels():
    source = (Path(kernels.__file__).parent.parent / "csrc" / "sparse_rows.cu").read_text()
    assert f"constexpr int64_t kChunk = {SPARSE_CHUNK};" in source
    assert "constexpr int64_t kLong = kChunk;" in source
    assert f"constexpr int kShares = {kernels.SPARSE_SHARES};" in source
    assert kernels.SPARSE_SHARES == 8  # the fixed tree joins eight shares


@pytest.mark.parametrize("dim", [1, 3, 9, 33])
@pytest.mark.parametrize("chunk", [SPARSE_CHUNK, 8])
def test_scatter_add_chunked_ref_sums_in_the_kernels_order(dim, chunk, monkeypatch):
    """Bitwise the numpy float32 sums in the documented order; at chunk 8 a
    segment spans many pieces, so every share and the tree take part."""
    monkeypatch.setattr(kernels, "SPARSE_CHUNK", chunk)
    rows = 60
    lids = _long_lids(rows, seed=dim, chunk=chunk)
    if chunk == 8:
        lids = np.concatenate([lids, np.full(150, lids[0])])  # 19 pieces on one row
    ct = np.random.default_rng(dim).normal(size=(lids.size, dim)).astype(np.float32)
    slid, order = sort_ids(torch.from_numpy(lids))
    got = scatter_add_chunked_ref(slid, order, torch.from_numpy(ct), rows)
    want = _chunk_order_numpy(slid.numpy(), order.numpy(), ct, rows, chunk,
                              kernels.SPARSE_SHARES)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_add_chunked_ref_is_exact_on_the_eighth_grid():
    """Cotangents on the 1/8 grid: every partial sum is exact in f32, so
    every order gives index_add_'s sums bitwise, untouched rows 0."""
    rows = 3000
    lids = _long_lids(rows, seed=4)
    rng = np.random.default_rng(5)
    ct = torch.from_numpy((rng.integers(-8, 9, (lids.size, 9)) / 8).astype(np.float32))
    t_lids = torch.from_numpy(lids)
    got = scatter_add_chunked_ref(*sort_ids(t_lids), ct, rows)
    assert torch.equal(got, scatter_add_dense_ref(t_lids, ct, rows))
    assert scatter_add_chunked_ref(*sort_ids(t_lids[:0]), ct[:0], rows).count_nonzero() == 0


def test_scatter_add_chunked_ref_long_row_within_the_float64_bound():
    """One row of 20,000 normal cotangents: each term passes through at most
    depth = chunk + ceil(pieces / 8) + 3 f32 additions, so the sum is within
    depth * u / (1 - depth * u) * sum|x| (u = 2**-24) of the exact one."""
    n, dim = 20_000, 9
    ct = np.random.default_rng(6).normal(size=(n, dim)).astype(np.float32)
    lids = torch.full((n,), 3, dtype=torch.int64)
    got = scatter_add_chunked_ref(*sort_ids(lids), torch.from_numpy(ct), 8).numpy()[3]
    exact = ct.astype(np.float64).sum(0)
    pieces = -(-n // SPARSE_CHUNK)
    depth = SPARSE_CHUNK + -(-pieces // kernels.SPARSE_SHARES) + 3
    u = 2.0 ** -24
    bound = depth * u / (1 - depth * u) * np.abs(ct.astype(np.float64)).sum(0)
    assert np.all(np.abs(got - exact) <= bound)


def test_scatter_add_chunked_ref_matches_pallas_on_long_segments():
    rows = 512
    lids = _long_lids(rows, seed=7).astype(np.int32)
    ct = _bf16(np.random.default_rng(8).normal(size=(lids.size, 8)).astype(np.float32))
    want = _j_scatter_add_dense(jnp.asarray(lids), jnp.asarray(ct), rows)
    got = scatter_add_chunked_ref(*sort_ids(torch.from_numpy(lids)), torch.from_numpy(ct), rows)
    # rows of up to 775 bf16-rounded unit normals summed in f32 in two
    # orders (one-hot matrix products against chunks and shares): the f32
    # rounding of sums of magnitude up to ~60
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["packed_d9", "unpacked_d128"])
def test_adagrad_on_chunked_sums_matches_pallas_on_long_segments(case):
    """Adagrad applied to ``scatter_add_chunked_ref``'s sums, as the card's
    long path applies it, against the JAX Pallas kernel (interpret mode)."""
    pack, dim, rows_phys, _, _ = REF_CASES[case]
    rows = rows_phys * pack
    stack, acc = _jax_table(pack, dim, rows_phys, seed=9)
    lids = _long_lids(rows, seed=10).astype(np.int32)
    ct = _bf16(np.random.default_rng(11).normal(size=(lids.size, dim)).astype(np.float32))
    want_s, want_a = jax.jit(lambda s, a, i, c: j_fused_adagrad_apply(
        s, a, i, c, pack=pack, dim=dim, lr=LR, eps=EPS, tile_rows=64, chunk=128))(
            jnp.asarray(stack), jnp.asarray(acc), jnp.asarray(lids), jnp.asarray(ct))
    table = torch.from_numpy(unpack_stack(stack, rows, dim).copy())
    table_acc = torch.from_numpy(unpack_stack(acc, rows, dim).copy())
    g = scatter_add_chunked_ref(*sort_ids(torch.from_numpy(lids)), torch.from_numpy(ct), rows)
    new_acc = table_acc + g * g
    new_table = table - LR * g * torch.where(new_acc > 0, torch.rsqrt(new_acc + EPS), 0.0)
    # as test_scatter_add_chunked_ref_matches_pallas_on_long_segments: sums
    # of up to 775 bf16-rounded normals in two orders
    np.testing.assert_allclose(new_table.numpy(), j_unpack_stack(np.asarray(want_s), rows, dim),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(new_acc.numpy(), j_unpack_stack(np.asarray(want_a), rows, dim),
                               rtol=1e-4, atol=1e-4)


def _adam_moments(pack, dim, rows_phys, step, seed):
    """Lazy Adam's moments, lane-packed as the JAX package keeps them: zero
    at step 0, else non-zero (v > 0)."""
    lanes = 128 if pack > 1 else dim
    if step == 0:
        return np.zeros((rows_phys, lanes), np.float32), np.zeros((rows_phys, lanes), np.float32)
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(rows_phys, lanes)) * 0.1).astype(np.float32),
            (rng.uniform(size=(rows_phys, lanes)) * 0.01).astype(np.float32))


def _long_stream_with_zero_row(rows, dim, seed):
    """``_long_lids``' ids with one more long row (300 positions, a row no
    other segment takes) whose cotangents are all zero, as DIN's padding
    row's are; the cotangents bf16-rounded normals elsewhere. Returns (lids
    int32, ct, the zero row)."""
    lids = _long_lids(rows, seed=seed)
    zero_row = int(np.setdiff1d(np.arange(rows), lids)[0])
    lids = np.concatenate([lids, np.full(300, zero_row)])
    np.random.default_rng(seed + 2).shuffle(lids)
    ct = _bf16(np.random.default_rng(seed + 3).normal(size=(lids.size, dim)).astype(np.float32))
    ct[lids == zero_row] = 0.0
    return lids.astype(np.int32), ct, zero_row


def _adam_on_sums(table, m, v, g, step):
    """Lazy Adam from the summed gradient ``g``, one row each, in the plain
    version's operations: ``fused_adam_ref`` on a stream that names every
    row once with its sum as the cotangent (what the card's long path
    computes from ``scatter_add_chunked_ref``'s sums)."""
    return fused_adam_ref(table, m, v, torch.arange(g.shape[0]), g, ADAM_LR, step)


@pytest.mark.parametrize("case", ["packed_d9", "unpacked_d128"])
def test_sgd_on_chunked_sums_matches_pallas_on_long_segments(case):
    """SGD applied to ``scatter_add_chunked_ref``'s sums, as the card's long
    path applies it, against the JAX Pallas kernel (interpret mode)."""
    pack, dim, rows_phys, _, _ = REF_CASES[case]
    rows = rows_phys * pack
    stack, _ = _jax_table(pack, dim, rows_phys, seed=13)
    lids, ct, zero_row = _long_stream_with_zero_row(rows, dim, seed=14)
    (want,) = jax.jit(lambda s, i, c: j_fused_sgd_apply(
        s, i, c, pack=pack, dim=dim, lr=LR, tile_rows=64, chunk=128))(
            jnp.asarray(stack), jnp.asarray(lids), jnp.asarray(ct))
    table = torch.from_numpy(unpack_stack(stack, rows, dim).copy())
    g = scatter_add_chunked_ref(*sort_ids(torch.from_numpy(lids)), torch.from_numpy(ct), rows)
    got = table - LR * g
    # as test_adagrad_on_chunked_sums_matches_pallas_on_long_segments: sums
    # of up to 775 bf16-rounded normals in two orders
    np.testing.assert_allclose(got.numpy(), j_unpack_stack(np.asarray(want), rows, dim),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got[zero_row], table[zero_row])


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("case", ["packed_d9", "unpacked_d128"])
def test_adam_on_chunked_sums_matches_pallas_on_long_segments(case, step):
    """Lazy Adam applied to ``scatter_add_chunked_ref``'s sums, as the card's
    long path applies it, against the JAX Pallas kernel (interpret mode);
    the long row whose cotangents are all zero keeps param, m and v bitwise
    on both sides."""
    pack, dim, rows_phys, _, _ = REF_CASES[case]
    rows = rows_phys * pack
    stack, _ = _jax_table(pack, dim, rows_phys, seed=15)
    m, v = _adam_moments(pack, dim, rows_phys, step, seed=16)
    lids, ct, zero_row = _long_stream_with_zero_row(rows, dim, seed=17)
    # the step goes in traced, as the Trainer passes it
    want = jax.jit(lambda s, mm, vv, i, c, st: j_fused_adam_apply(
        s, mm, vv, i, c, pack=pack, dim=dim, lr=ADAM_LR, step=st, tile_rows=64, chunk=128))(
            *map(jnp.asarray, (stack, m, v, lids, ct)), jnp.int32(step))
    state = [torch.from_numpy(unpack_stack(a, rows, dim).copy()) for a in (stack, m, v)]
    g = scatter_add_chunked_ref(*sort_ids(torch.from_numpy(lids)), torch.from_numpy(ct), rows)
    got = _adam_on_sums(*state, g, step)
    for name, a, w, before in zip(("param", "m", "v"), got, want, state):
        w = j_unpack_stack(np.asarray(w), rows, dim)
        # sums of up to 775 bf16-rounded normals in two orders, as for
        # Adagrad; the update divides m by sqrt(v), both from the same sums
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-4, atol=1e-4, err_msg=name)
        assert torch.equal(a[zero_row], before[zero_row]), name
        np.testing.assert_array_equal(w[zero_row], before[zero_row].numpy(), err_msg=name)


def test_adam_wrapper_keeps_a_long_zero_row_bitwise():
    """On the CPU the wrapper's plain version, like the card's long path,
    leaves a long row whose cotangents are all zero as it was."""
    rows, dim = 300, 9
    lids, ct, zero_row = _long_stream_with_zero_row(rows, dim, seed=18)
    gen = torch.Generator().manual_seed(19)
    state = [torch.randn(rows, dim, generator=gen), 0.1 * torch.randn(rows, dim, generator=gen),
             0.01 * torch.rand(rows, dim, generator=gen)]
    before = [t.clone() for t in state]
    fused_adam_apply(*state, torch.from_numpy(lids).long(), torch.from_numpy(ct), lr=ADAM_LR,
                     step=3)
    for name, t, b in zip(("param", "m", "v"), state, before):
        assert torch.equal(t[zero_row], b[zero_row]), name
        assert not torch.equal(t, b), name


def _scratch_faults(n, dim):
    partial, starts = kernels.sparse_rows_scratch(n, dim, "cpu")
    return {
        "partial_chunks": ((partial[:-1], starts), ValueError),
        "partial_width": ((torch.empty(partial.shape[0], 2, dim + 1), starts), ValueError),
        "partial_f64": ((partial.double(), starts), ValueError),
        "starts_int32": ((partial, starts.int()), ValueError),
        "starts_chunks": ((partial, torch.empty(starts.numel() + 1, dtype=torch.int64)),
                          ValueError),
        "partial_device": ((partial.to("meta"), starts), ValueError),
        "starts_device": ((partial, starts.to("meta")), ValueError),
        "non_contiguous": ((partial.transpose(0, 1).contiguous().transpose(0, 1), starts),
                           ValueError),
    }


# each launcher of csrc/sparse_rows.cu, called on a stream, its tables and
# the long path's scratch
LAUNCHERS = {
    "scatter_add": lambda t, slid, ct, sc: kernels.launch_scatter_add(t, slid, slid, ct, *sc),
    "adagrad": lambda t, slid, ct, sc: kernels.launch_fused_adagrad(
        t, t.clone(), slid, slid, ct, torch.full((1,), LR), EPS, *sc),
    "sgd": lambda t, slid, ct, sc: kernels.launch_fused_sgd(
        t, slid, slid, ct, torch.full((1,), LR), *sc),
    "adam": lambda t, slid, ct, sc: kernels.launch_fused_adam(
        t, t.clone(), t.clone(), slid, slid, ct, torch.ones(3), *sc, b1=0.9, b2=0.999,
        eps=1e-8),
}


@pytest.mark.parametrize("case", sorted(_scratch_faults(1000, 9)))
@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_long_path_launchers_check_the_scratch(launcher, case):
    n, dim = 1000, 9
    scratch, error = _scratch_faults(n, dim)[case]
    slid = torch.arange(n)
    with pytest.raises(error, match="long path"):
        LAUNCHERS[launcher](torch.zeros(n, dim), slid, torch.zeros(n, dim), scratch)


@pytest.mark.parametrize("n", [0, 1, SPARSE_CHUNK, SPARSE_CHUNK + 1, 425_984])
def test_sparse_rows_scratch_is_what_the_launchers_take(n):
    partial, starts = kernels.sparse_rows_scratch(n, 9, "cpu")
    assert partial.shape == (-(-n // SPARSE_CHUNK), 2, 9) and starts.dtype == torch.int64
    kernels.check_long_scratch(partial, starts, torch.empty(n, dtype=torch.int64),
                               torch.empty(n, 9))


def test_cpu_wrappers_count_no_long_launch():
    wrappers = (fused_adagrad_apply, fused_sgd_apply, fused_adam_apply, scatter_add_sorted)
    before = [fn.long_launches for fn in wrappers]
    lids = torch.from_numpy(_long_lids(100, seed=12))
    ct = torch.ones(lids.numel(), 4)
    fused_adagrad_apply(torch.zeros(100, 4), torch.zeros(100, 4), lids, ct, lr=LR)
    fused_sgd_apply(torch.zeros(100, 4), lids, ct, lr=LR)
    fused_adam_apply(torch.zeros(100, 4), torch.zeros(100, 4), torch.zeros(100, 4), lids, ct,
                     lr=ADAM_LR, step=0)
    scatter_add_sorted(*sort_ids(lids), ct, 100)
    assert [fn.long_launches for fn in wrappers] == before
