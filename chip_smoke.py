"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

Run from the repository root, on a machine with one H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code not 0):

1. set-up: the card's name and power limit, TF32 off, the kernels built
   from ``recommender_system_tpu_torch/csrc`` (one nvcc per source);
2. every kernel against its plain PyTorch version on the card
   (``cross_fused`` vs ``cross_network``, forward and gradient,
   rtol=1e-4, atol=1e-5);
3. serving at full width: DCN on 26 sparse fields of 100,000 ids (dim 8)
   and 13 dense fields, 6 cross layers, deep tower 256-128-64, f32, random
   weights from a seed; ``Scorer(batch_size=4096)`` answers requests of 1,
   1000, 4096 and 10,000 rows. The kernel counts must show one launch per
   padded batch, and every answer must equal a plain forward on the card
   (atol=1e-5 on probabilities) and the CPU path on 1000 rows;
4. timings: each kernel's and its plain version's device time (from the
   profiler's trace) and time per call (CUDA events over back-to-back calls,
   host overhead included); the Scorer's latency and throughput (host
   clock), its device busy time per batch and its top kernels.

The line before the last lists every kernel with its launches on the
serving run, its error against the plain version, its time, its plain
version's time and its bound; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import collections
import copy
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

RTOL, ATOL = 1e-4, 1e-5
SERVE_BATCH = 4096
REQUESTS = (1, 1000, 4096, 10_000)
THROUGHPUT_ROWS = 65_536


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Time per call of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events: the device time, or the host's time to issue the call where that
    is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50) -> collections.Counter:
    """Device time per call of ``fn``, by kernel name, from the profiler's
    trace (kernels and copies; the gaps between them do not count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_name = collections.Counter()
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            per_name[event.name] += event.time_range.elapsed_us() / 1e3 / iters
    if not per_name:
        raise RuntimeError("the profiler traced no device time")
    return per_name


def host_ms(fn, iters: int, warmup: int = 3) -> list:
    """Host-clock times of ``fn`` (which returns host data, so each call ends
    after the device finished)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def cross_bound(B: int, D: int, L: int):
    """Least time for the cross stack: x0 read and the output written once,
    weights and biases read once; 5*B*D*L f32 flops."""
    byte_ms = 4 * (2 * B * D + 2 * L * D) / PEAK_BYTES_PER_S * 1e3
    flop_ms = 5 * B * D * L / PEAK_F32_FLOPS * 1e3
    return max(byte_ms, flop_ms), "bytes" if byte_ms >= flop_ms else "operations"


def check_cross_kernel(cross_fused, cross_network) -> float:
    """Phase 2: the kernel against its plain version; returns the largest
    absolute error of the forward."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    # the bench shape at three batch sizes, a D that is not a multiple of
    # 32, the widest D the kernel takes, and weights beyond 48 KB of
    # shared memory
    for B, D, L in [(1, 221, 6), (1000, 221, 6), (4096, 221, 6), (1000, 100, 6),
                    (1000, 1000, 6), (1000, 1000, 16)]:
        x0 = torch.randn(B, D, generator=gen, device="cuda")
        w = torch.randn(L, D, generator=gen, device="cuda") * (0.2 / math.sqrt(D))
        b = torch.randn(L, D, generator=gen, device="cuda") * 0.1
        with torch.inference_mode():
            out = cross_fused(x0, w, b)
            torch.cuda.synchronize()
            ref = cross_network(x0, w, b)
            torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        err = (out - ref).abs().max().item()
        max_err = max(max_err, err)

        grads = []
        for fn in (cross_fused, cross_network):
            args = [t.clone().requires_grad_(True) for t in (x0, w, b)]
            (fn(*args) ** 2).sum().backward()
            torch.cuda.synchronize()
            grads.append([a.grad for a in args])
        for g_kernel, g_plain in zip(*grads):
            # the cotangent 2*out carries the forward's rounding into sums
            # that cancel, so the absolute tolerance scales with the
            # gradient's largest entry
            torch.testing.assert_close(g_kernel, g_plain, rtol=RTOL,
                                       atol=ATOL * max(1.0, g_plain.abs().max().item()))
        print(f"kernel check cross_fused B={B} D={D} L={L}: max_abs_err={err:.3e}, "
              "gradients match", flush=True)
    return max_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2

    from recommender_system_tpu_torch import DCN, Scorer
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.interactions import cross_network
    from recommender_system_tpu_torch.ops.kernels import cross_fused
    from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

    # --- phase 1: set-up ---------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  nvcc {name}: {line.strip()}")

    # --- phase 2: kernels against their plain versions ---------------------
    cross_err = check_cross_kernel(cross_fused, cross_network)

    # --- phase 3: serving at full width ------------------------------------
    cols, X, _ = synthetic_criteo(n_rows=max(REQUESTS), vocab=100_000,
                                  embedding_dim=8, seed=0)
    model = DCN(tuple(cols), cross_layers=6, hidden_units=(256, 128, 64),
                device="cuda", generator=torch.Generator().manual_seed(0))
    table = model.embeddings.table_d8
    with torch.no_grad():
        # the default init std of 1e-4 would leave the embeddings no say in
        # the output
        table.normal_(0.0, 0.1, generator=torch.Generator(device="cuda").manual_seed(1))
    print(f"DCN: x0 width {model.cross.weights.shape[1]}, table {tuple(table.shape)}, "
          f"{sum(p.numel() for p in model.parameters())} parameters", flush=True)
    scorer = Scorer(model, batch_size=SERVE_BATCH)
    requests = {n: {k: v[:n] for k, v in X.items()} for n in REQUESTS}

    cross_fused.launches = 0
    answers = {n: scorer(req) for n, req in requests.items()}
    torch.cuda.synchronize()
    launches = {"cross_fused": cross_fused.launches}
    batches = sum(-(-n // SERVE_BATCH) for n in REQUESTS)
    print(f"serving launches: {launches} for {batches} padded batches", flush=True)
    if launches["cross_fused"] != batches:
        raise RuntimeError(f"cross_fused launched {launches['cross_fused']} times "
                           f"for {batches} served batches")

    def plain_forward(req):
        with torch.inference_mode():
            batch = {k: torch.as_tensor(v, device="cuda") for k, v in req.items()}
            x0 = model.embeddings(batch).concat_flat()
            cross = cross_network(x0, model.cross.weights, model.cross.biases)
            logits = model.head(torch.cat([cross, model.deep(x0)], dim=-1))
            return torch.sigmoid(logits).cpu().numpy()

    for n, got in answers.items():
        if got.shape != (n, 1) or got.dtype != np.float32 or not np.isfinite(got).all():
            raise RuntimeError(f"request of {n} rows answered {got.shape} {got.dtype}")
        np.testing.assert_allclose(got, plain_forward(requests[n]), rtol=0, atol=ATOL)
    spread = float(np.std(answers[max(REQUESTS)]))
    if spread < 1e-3:
        raise RuntimeError(f"scores barely vary (std {spread}): inputs have no say")
    cpu_scorer = Scorer(copy.deepcopy(model).to("cpu"), batch_size=SERVE_BATCH,
                        device="cpu")
    np.testing.assert_allclose(answers[1000], cpu_scorer(requests[1000]),
                               rtol=0, atol=ATOL)
    print(f"serving check: {len(REQUESTS)} requests equal the plain forward on the "
          f"card and the CPU path (atol={ATOL}); score std {spread:.4f}", flush=True)

    # --- phase 4: timings --------------------------------------------------
    with torch.inference_mode():
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in requests[SERVE_BATCH].items()}
        x0 = model.embeddings(batch).concat_flat()
        w, b = model.cross.weights, model.cross.biases
        B, D = x0.shape
        L = w.shape[0]
        # x0 (3.6 MB) stays in the 50 MB L2 across calls, as it does when
        # the Scorer's concat has just written it
        kernel_dev = device_ms(lambda: cross_fused(x0, w, b))
        plain_dev = device_ms(lambda: cross_network(x0, w, b))
        kernel_call = call_ms(lambda: cross_fused(x0, w, b))
        plain_call = call_ms(lambda: cross_network(x0, w, b))
    if not all("cross_stack_kernel" in name for name in kernel_dev):
        raise RuntimeError(f"cross_fused ran other device work: {dict(kernel_dev)}")
    kernel_ms, plain_ms = sum(kernel_dev.values()), sum(plain_dev.values())
    bound_ms, bound_by = cross_bound(B, D, L)
    print(f"timing cross_fused B={B} D={D} L={L}: device {kernel_ms:.5f} ms "
          f"({100 * bound_ms / kernel_ms:.1f}% of the bound {bound_ms:.5f} ms, "
          f"{bound_by}), {kernel_call:.5f} ms per call; plain cross_network: "
          f"device {plain_ms:.5f} ms in {len(plain_dev)} kernel kinds, "
          f"{plain_call:.5f} ms per call; on {card}", flush=True)

    lat = {n: host_ms(lambda n=n: scorer(requests[n]), iters=50)
           for n in (1, SERVE_BATCH)}
    for n, times in lat.items():
        print(f"timing Scorer {n}-row request: median {statistics.median(times):.3f} ms, "
              f"min {min(times):.3f} ms, max {max(times):.3f} ms over {len(times)}; "
              f"on {card}", flush=True)
    _, X_big, _ = synthetic_criteo(n_rows=THROUGHPUT_ROWS, vocab=100_000,
                                   embedding_dim=8, seed=1)
    big = host_ms(lambda: scorer(X_big), iters=5, warmup=1)
    print(f"timing Scorer throughput over {THROUGHPUT_ROWS} rows: "
          f"{THROUGHPUT_ROWS / (statistics.median(big) / 1e3):.1f} examples/s "
          f"(median of {len(big)} calls, {statistics.median(big):.2f} ms each); "
          f"on {card}", flush=True)
    serve_dev = device_ms(lambda: scorer(requests[SERVE_BATCH]), iters=10)
    busy = sum(serve_dev.values())
    wall = statistics.median(lat[SERVE_BATCH])
    print(f"Scorer {SERVE_BATCH}-row request: device busy {busy:.4f} ms of "
          f"{wall:.4f} ms wall, idle share {1 - busy / wall:.3f}; top device work:",
          flush=True)
    for name, ms in serve_dev.most_common(8):
        print(f"  {ms:.4f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "cross_fused", "route": "cuda",
        "source": "recommender_system_tpu_torch/csrc/cross.cu",
        "replaces": "recommender_system_tpu/ops/pallas_kernels.py:124",
        "launches": launches["cross_fused"], "max_abs_err": cross_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "call_ms": kernel_call, "plain_call_ms": plain_call,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
