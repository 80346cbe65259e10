"""The benchmark's frozen arithmetic: the card's published peaks, each
layer's least work at a cell's own shapes and data, and the model FLOPs of
a training step. Copied from ``chip_smoke.py`` (``PEAK_*``,
``din_backward_work``, ``sparse_rows_bound``) and kept here, where a change
to the program cannot move it; each bound counts the least work a layer
needs, never what a kernel happens to do, so a later kernel that skips
work it need not do still reads at most 100 %.
"""
from __future__ import annotations

from typing import Sequence, Tuple

# One H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12

# the sparse rules' tables (param and its slots) and flops an element
RULE_TABLES = {"sgd": 1, "adagrad": 2, "adam": 3}
RULE_FLOPS = {"sgd": 2, "adagrad": 5, "adam": 12}

Bound = Tuple[float, str]


def _bound(nbytes: float, op_ms: float) -> Bound:
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations"


def din_forward_work(B: int, T: int, K: int, H1: int, H2: int, positions: int):
    """The DIN attention's least bytes and flops over its ``positions``
    unmasked positions: the query, the unmasked keys and the mask read and
    the pooled output written once, the scorer's weights read once; the
    scorer at its least, the first layer folded per row into a K x H1
    matrix (``q (Wq + Wm)`` and ``(Wk - Wm) + diag(q) Wp``, 2*B*2*K*H1),
    then 2*P*(K*H1 + H1*H2 + H2) and the pooling, 2*P*K. A masked
    position scores nothing and pools nothing."""
    params = 4 * K * H1 + H1 + H1 * H2 + 2 * H2 + 1
    nbytes = 4 * (B * K + positions * K + B * T + B * K + params)
    flops = (2 * positions * (K * H1 + H1 * H2 + H2) + 2 * B * 2 * K * H1
             + 2 * positions * K)
    return nbytes, flops


def din_forward_bound(B: int, T: int, K: int, H1: int, H2: int, positions: int) -> Bound:
    """Least ms of the forward: its products f32-accurate on the tensor
    cores, three TF32 passes (3xTF32), as the kernel computes them."""
    nbytes, flops = din_forward_work(B, T, K, H1, H2, positions)
    return _bound(nbytes, 3 * flops / PEAK_TF32_FLOPS * 1e3)


def din_backward_work(B: int, T: int, K: int, H1: int, H2: int, positions: int):
    """The DIN attention backward's least bytes and flops (``chip_smoke.py``'s
    ``din_backward_work`` over the unmasked positions): the query and the
    cotangent read, the unmasked keys and their saved weights read, the mask
    read, dq and every position's dkeys written, the parameters read and
    their gradients written once; the scorer recomputed at its least,
    2*P*(K*H1 + H1*H2 + H2), du.W2^T and h1^T.du, 2*P*H1*H2 each, dkeys
    through the row's folded K x H1 matrix and keys^T.dh_pre, 2*P*K*H1
    each, and the per-row q (Wq + Wm), dq and dA, 2*B*K*H1 each."""
    P = positions
    params = 4 * K * H1 + H1 + H1 * H2 + 2 * H2 + 1
    nbytes = 4 * (2 * B * K + P * K + B * T * K + P + B * T + 2 * params)
    flops = (2 * P * (K * H1 + H1 * H2 + H2) + 2 * 2 * P * H1 * H2
             + 2 * 2 * P * K * H1 + 3 * 2 * B * K * H1)
    return nbytes, flops


def din_backward_bound(B: int, T: int, K: int, H1: int, H2: int, positions: int) -> Bound:
    nbytes, flops = din_backward_work(B, T, K, H1, H2, positions)
    return _bound(nbytes, 3 * flops / PEAK_TF32_FLOPS * 1e3)


def sparse_rows_bound(n: int, touched: int, dim: int, rule: str) -> Bound:
    """Least ms of a fused sparse rule on a stream of ``n`` positions that
    touches ``touched`` rows of width ``dim``: the stream (its sorted rows
    and order, which fit int32, and the f32 cotangents) read once, the
    rule's tables read and written on the touched rows alone."""
    nbytes = 8 * n + 4 * n * dim + 8 * RULE_TABLES[rule] * touched * dim
    flops = n * dim + RULE_FLOPS[rule] * touched * dim
    return _bound(nbytes, flops / PEAK_F32_FLOPS * 1e3)


def mlp_flops(rows: int, widths: Sequence[int]) -> int:
    """Forward FLOPs of a dense tower over ``rows``: ``widths`` from its
    input to its output."""
    return sum(2 * rows * a * b for a, b in zip(widths[:-1], widths[1:]))


def din_scorer_flops(B: int, K: int, H1: int, H2: int, positions: int) -> int:
    """Forward FLOPs of the attention's products at their least (see
    ``din_forward_work``)."""
    return din_forward_work(B, 0, K, H1, H2, positions)[1]


def train_flops(forward: int) -> int:
    """A training step's model FLOPs: the forward and, for the backward,
    twice the forward (the input's and the weights' gradients), no
    recomputation."""
    return 3 * forward
