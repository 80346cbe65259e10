"""Which kernel the cross, FM and DIN attention wrappers (the attention's
backward too) launch on the card at each shape: the fast kernel of their
source where ``*_kernel_takes`` (the backward's wide kernel where
``din_backward_wide_takes``), else the source's global kernel, and never
the plain version. Runs on the CPU with every tensor counted as on the card
and a recording stand-in for the built library."""
import contextlib

import numpy as np
import pytest
import torch

from recommender_system_tpu_torch.ops import kernels
from recommender_system_tpu_torch.ops.kernels import (cross_fused, din_attention_backward,
                                                      din_attention_fused, fm_fused)


class _FakeLibrary:
    """Stands in for a built kernel library: records each entry point
    called and returns CUDA's success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append(entry) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA route on CPU tensors; returns the library."""
    lib = _FakeLibrary()
    monkeypatch.setattr(kernels, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(kernels, "_library", lambda name: lib)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for fn in (cross_fused, fm_fused, din_attention_fused):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "global_launches", 0)
    monkeypatch.setattr(din_attention_backward, "launches", 0)
    monkeypatch.setattr(din_attention_backward, "wide_launches", 0)
    monkeypatch.setattr(din_attention_backward, "global_launches", 0)
    return lib


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _cross(B, D, L, seed=0):
    rng = np.random.default_rng(seed)
    return _randn(rng, B, D), _randn(rng, L, D, scale=0.2 / np.sqrt(D)), _randn(rng, L, D)


def _fm(B, D, k, seed=0):
    rng = np.random.default_rng(seed)
    return _randn(rng, B, D), _randn(rng, D, 1, scale=0.1), _randn(rng, D, k, scale=0.1)


def _din(B=4, T=6, K=8, H1=10, H2=5, seed=0):
    """query, keys, a bool mask and the scorer's weights, requiring grad."""
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(np.arange(T)[None, :] < rng.integers(1, T + 1, B)[:, None])
    tensors = [_randn(rng, B, K), _randn(rng, B, T, K), _randn(rng, 4 * K, H1, scale=0.3),
               _randn(rng, H1), _randn(rng, H1, H2, scale=0.3), _randn(rng, H2),
               _randn(rng, H2, 1, scale=0.3), _randn(rng, 1)]
    tensors = [t.requires_grad_(True) for t in tensors]
    return tensors[:2] + [mask] + tensors[2:]


# wrapper -> [(inputs, the entry point they go to)]: the fast kernels where
# they take the shape, the global kernel at x0 widths 1,025 and 1,053 and
# past the shared memory, FM past the wide kernel's shared memory (D=3,419
# and 4,000 at k=8, k=19 at D=1,500), the attention at K=128, past T=514 at
# K=32 and at a hidden width past 256; a transposed bf16 x0 and a transposed
# x go as contiguous float32 copies; the global kernel's three timed shapes
# (K=128, T=50; K=64, T=200; K=32, T=1,000) are among them, and DIN's shape
# (K=32, T=50, 80-40) and T=100 on the tiled forward kernel
ROUTES = {
    "cross": (cross_fused, lambda: [
        (_cross(3, 16, 2), "cross_forward"),
        (_cross(3, 1025, 2), "cross_global_forward"),
        (_cross(3, 1053, 6), "cross_global_forward"),
        (_cross(3, 1024, 29), "cross_global_forward"),
        (((lambda x0, w, b: (x0.t().contiguous().t().bfloat16(), w, b))(*_cross(16, 8, 2))),
         "cross_forward")]),
    "fm": (fm_fused, lambda: [
        (_fm(3, 12, 4), "fm_forward"),
        (_fm(3, 3419, 8), "fm_global_forward"),
        (_fm(3, 4000, 8), "fm_global_forward"),
        (_fm(3, 1500, 19), "fm_global_forward"),
        (((lambda x, w1, v: (x.t().contiguous().t(), w1, v))(*_fm(3, 12, 4))), "fm_forward")]),
    "din_attention": (din_attention_fused, lambda: [
        (_din(), "din_attention_forward"),
        (_din(T=50, K=128, H1=80, H2=40), "din_attention_global_forward"),
        (_din(B=2, T=515, K=32, H1=80, H2=40), "din_attention_global_forward"),
        (_din(B=2, T=200, K=64, H1=80, H2=40), "din_attention_global_forward"),
        (_din(B=2, T=1000, K=32, H1=80, H2=40), "din_attention_global_forward"),
        (_din(H1=257), "din_attention_global_forward"),
        (_din(B=2, T=50, K=32, H1=80, H2=40), "din_attention_forward"),
        (_din(B=2, T=100, K=32, H1=80, H2=40), "din_attention_forward")]),
}


# the backward's entry points after each forward of the attention, by the
# case's index in ROUTES: its scratch's size, then the launch, of the tile
# kernel (K <= 32, H1 <= 80, H2 <= 40, T <= 64), else of the wide kernel (K
# <= 128, H1 <= 80, H2 <= 40, any T), else of the global kernel
DIN_TILE_BACKWARD = ["din_attention_backward_scratch", "din_attention_backward"]
DIN_WIDE_BACKWARD = ["din_attention_wide_backward_scratch", "din_attention_wide_backward"]
DIN_GLOBAL_BACKWARD = ["din_attention_global_backward_scratch", "din_attention_global_backward"]
DIN_BACKWARD = [DIN_TILE_BACKWARD, *[DIN_WIDE_BACKWARD] * 4, DIN_GLOBAL_BACKWARD,
                DIN_TILE_BACKWARD, DIN_WIDE_BACKWARD]


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_wrapper_launches_a_kernel_at_every_shape(fake_card, name):
    fn, cases = ROUTES[name]
    cases = cases()
    for args, entry in cases:
        out = fn(*args)
        assert out.dtype == torch.float32
        assert fake_card.calls[-1] == entry
        if name == "din_attention":
            out.sum().backward()  # the backward kernel at either forward kernel's shapes
            assert all(a.grad is not None for a in args if a.dtype == torch.float32)
    backward = DIN_BACKWARD if name == "din_attention" else [[]] * len(cases)
    assert fake_card.calls == [call for (_, entry), back in zip(cases, backward)
                               for call in [entry, *back]]
    assert fn.launches == len(cases)
    assert fn.global_launches == sum("global" in entry for _, entry in cases)
    assert din_attention_backward.launches == sum(bool(back) for back in backward)
    assert din_attention_backward.wide_launches == sum(back == DIN_WIDE_BACKWARD
                                                       for back in backward)
    assert din_attention_backward.global_launches == sum(back == DIN_GLOBAL_BACKWARD
                                                         for back in backward)


@pytest.mark.parametrize("name,case", [(name, i) for name in sorted(ROUTES) for i in (0, 1)])
def test_wrapper_raises_where_the_build_fails(fake_card, monkeypatch, name, case):
    """Nothing falls back to the plain version on the card: a failing build
    raises at a shape of either kernel, and no launch is counted."""
    def no_build(source):
        raise RuntimeError(f"build of {source} failed")

    monkeypatch.setattr(kernels, "_library", no_build)
    fn, cases = ROUTES[name]
    args, _ = cases()[case]
    with pytest.raises(RuntimeError, match=f"build of {name} failed"):
        fn(*args)
    assert (fn.launches, fn.global_launches) == (0, 0)


# backward inputs -> the router's entries (the global kernel's follow on
# request): the tile kernel within its limits; the wide kernel past them
# (T past 64, K past 32) up to K=128 and 80-40; the global kernel past K=128
# or a scorer wider than 80-40, at any T
BACKWARD_ROUTES = [
    (dict(), DIN_TILE_BACKWARD),
    (dict(B=2, T=50, K=32, H1=80, H2=40), DIN_TILE_BACKWARD),
    (dict(B=2, T=64, K=32, H1=80, H2=40), DIN_TILE_BACKWARD),
    (dict(B=2, T=65, K=32, H1=80, H2=40), DIN_WIDE_BACKWARD),
    (dict(B=2, T=50, K=33, H1=80, H2=40), DIN_WIDE_BACKWARD),
    (dict(B=2, T=50, K=32, H1=81, H2=40), DIN_GLOBAL_BACKWARD),
    (dict(B=2, T=50, K=32, H1=80, H2=41), DIN_GLOBAL_BACKWARD),
    (dict(B=2, T=50, K=128, H1=80, H2=40), DIN_WIDE_BACKWARD),
    (dict(B=2, T=200, K=64, H1=80, H2=40), DIN_WIDE_BACKWARD),
    (dict(B=2, T=1000, K=32, H1=80, H2=40), DIN_WIDE_BACKWARD),
    (dict(B=2, T=7, K=100, H1=80, H2=40), DIN_WIDE_BACKWARD),
    (dict(B=2, T=50, K=129, H1=80, H2=40), DIN_GLOBAL_BACKWARD),
    (dict(B=2, T=65, K=8, H1=81, H2=40), DIN_GLOBAL_BACKWARD),
    (dict(B=2, T=200, K=128, H1=80, H2=41), DIN_GLOBAL_BACKWARD),
]


@pytest.mark.parametrize("return_scores", [False, True], ids=["pooled", "scores"])
@pytest.mark.parametrize("case", range(len(BACKWARD_ROUTES)))
def test_backward_counts_launches_per_route(fake_card, case, return_scores):
    """``din_attention_backward`` calls the tile kernel's entry points where
    ``din_backward_kernel_takes``, the wide kernel's where
    ``din_backward_wide_takes`` and the global kernel's elsewhere, as
    ``din_backward_route`` names them; each counts in ``launches``, the wide
    kernel also in ``wide_launches``, the global kernel in
    ``global_launches``; the launcher's ``global_kernel`` takes the global
    kernel at any shape."""
    shape, entries = BACKWARD_ROUTES[case]
    q, keys, mask, *weights = [t.detach() for t in _din(**shape)]
    B, T, K = keys.shape
    saved = torch.full((B, T), 1.0 / T)
    grad = torch.ones((B, T) if return_scores else (B, K))
    args = (q, keys, mask.float(), *weights, saved, grad, "sigmoid", True, return_scores)
    assert kernels.din_backward_kernel_takes(*args[:11], "sigmoid", return_scores) == (
        entries == DIN_TILE_BACKWARD)
    assert kernels.din_backward_wide_takes(*args[:11], "sigmoid", return_scores) == (
        entries == DIN_WIDE_BACKWARD)
    route = {"din_attention_backward": "tile", "din_attention_wide_backward": "wide",
             "din_attention_global_backward": "global"}[entries[1]]
    assert kernels.din_backward_route(*args[:11], "sigmoid", return_scores) == route
    grads = din_attention_backward(*args)
    assert [g.shape for g in grads] == [t.shape for t in (q, keys, *weights)]
    kernels._din_backward_launch(*args, global_kernel=True)
    assert fake_card.calls == [*entries, *DIN_GLOBAL_BACKWARD]
    assert din_attention_backward.launches == 2
    assert din_attention_backward.wide_launches == (entries == DIN_WIDE_BACKWARD)
    assert din_attention_backward.global_launches == 1 + (entries == DIN_GLOBAL_BACKWARD)
