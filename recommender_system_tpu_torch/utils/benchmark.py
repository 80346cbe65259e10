"""Differential timing on the card (counterpart of
``recommender_system_tpu/utils/benchmark.py``).

The protocol is the JAX module's:

1. warm up (``max(n1 // 2, 1)`` iterations: kernel builds, caches),
2. time a window of ``n1`` iterations,
3. time a window of ``n2 > n1`` iterations,
4. seconds per iteration = ``(t2 - t1) / (n2 - n1)``: what the two windows
   share (the launch of the first iteration, the tail of the last) cancels.

On a card each window lies between a pair of CUDA events recorded on the
current stream of ``device`` (which need not be the current device), and
the host waits for the second event after each window
(``Event.synchronize``), so no window's work runs into the next one's. The
host clock (``time.perf_counter``) is used only where the caller passes
``device="cpu"``, whose work is done when the call returns.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from ..ops.dispatch import DeviceLike, resolve_device


def _window_s(run_n: Callable[[int], object], n: int, device: torch.device) -> float:
    """Seconds that ``run_n(n)`` takes, on the card between CUDA events on
    ``device``'s current stream."""
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        run_n(n)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    run_n(n)
    return time.perf_counter() - t0


def time_iterations(run_n: Callable[[int], object], n1: int, n2: int,
                    device: DeviceLike = None) -> float:
    """Differential timing: ``run_n(n)`` must run ``n`` chained iterations.
    Returns seconds per iteration (see the module docstring); on the card
    unless ``device`` names another."""
    device = resolve_device(device)
    _window_s(run_n, max(n1 // 2, 1), device)  # warm-up
    t1 = _window_s(run_n, n1, device)
    t2 = _window_s(run_n, n2, device)
    return (t2 - t1) / (n2 - n1)


def bench_fn(f: Callable, *args, n1: int = 10, n2: int = 40,
             device: DeviceLike = None) -> float:
    """Seconds per call of ``f(*args)``, the calls issued back to back."""

    def run_n(n):
        r = None
        for _ in range(n):
            r = f(*args)
        return r

    return time_iterations(run_n, n1, n2, device)


def bench_train_step(step: Callable, *args, n1: int = 5, n2: int = 25,
                     device: DeviceLike = None) -> float:
    """Seconds per step of ``step(*args)``, a callable that trains one step
    and returns its loss (``Trainer.train_step``, or a ``multi_step`` call
    per iteration). The steps chain through the state they update in place,
    so each one follows the last on the device."""

    def run_n(n):
        loss = None
        for _ in range(n):
            loss = step(*args)
        return loss

    return time_iterations(run_n, n1, n2, device)
