"""How often ``torch.profiler``'s trace misses device records on the card,
where in a window the missing ones were launched, and what keeps them.

Run from the repository root, on a machine with one H100:

    python3 chip_lab_profiler.py [--traces 30] [--calls 50]

Each window traces ``--calls`` calls of one workload between two marker
kernels (``torch.cuda._sleep``: the first thing launched in the window and
the last), synchronises, and counts each kernel's records. A whole window
holds one record of each marker and a multiple of the calls of every other
kernel. Workloads: ``fm_fused`` at x [16,384, 4,000], k=8 (the FM global
kernel and its coefficient kernel), ``cross_fused`` at B=4,096, D=1,053,
L=6 (the cross global kernel), ``cross_network`` there (cuBLAS and
elementwise kernels), ``torch.sum`` over the FM's x. Modes, each a way to
end the window:

- ``plain``: synchronise and leave the profiler;
- ``filler``: then launch 2,000 one-element fills and synchronise before
  leaving, so that the measured records are not the last ones in the
  profiler's buffers;
- ``sleep``: then sleep 50 ms on the host before leaving;
- ``lead``: begin the window with 64 ``torch.cuda._sleep`` kernels of about
  10 us each and a synchronise, before the first marker (what
  ``chip_smoke.device_ms`` does).

It prints, by mode and workload, the windows that lost records, which
markers they lost, and the share of the calls' records they kept.
"""
from __future__ import annotations

import argparse
import collections
import math
import sys
import time

import torch

import chip_smoke as cs

MARKER = cs.LEAD_IN_KERNEL  # torch.cuda._sleep's kernel name holds it
LEAD, LEAD_CYCLES = cs.LEAD_IN, cs.LEAD_IN_CYCLES


def window(fn, calls: int, mode: str, filler: torch.Tensor):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if mode == "lead":
            for _ in range(LEAD):
                torch.cuda._sleep(LEAD_CYCLES)
            torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        if mode == "filler":
            for _ in range(2000):
                filler.fill_(0.0)
            torch.cuda.synchronize()
        elif mode == "sleep":
            time.sleep(0.05)
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if mode == "lead":  # the lead-in's records, kept or not, are not counted
        spins = [i for i, e in enumerate(events) if MARKER in e.name]
        if len(spins) >= 2:
            events = events[spins[-2]:]
    return events


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--traces", type=int, default=30)
    parser.add_argument("--calls", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_lab_profiler: no CUDA device", file=sys.stderr)
        return 2
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.interactions import cross_network
    from recommender_system_tpu_torch.ops.kernels import cross_fused, fm_fused

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, w1, v = cs.fm_inputs(gen, cs.FM_B, cs.WIDE_FM_D, 8)
    D = cs.FIELDS * cs.WIDE_DIM + 13
    x0 = torch.randn(cs.SERVE_BATCH, D, generator=gen, device="cuda")
    w = torch.randn(6, D, generator=gen, device="cuda") * (0.2 / math.sqrt(D))
    b = torch.randn(6, D, generator=gen, device="cuda") * 0.1
    filler = torch.zeros(1, device="cuda")
    workloads = {"fm_fused": lambda: fm_fused(x, w1, v),
                 "cross_fused": lambda: cross_fused(x0, w, b),
                 "cross_network": lambda: cross_network(x0, w, b),
                 "torch.sum": lambda: torch.sum(x, 1)}
    with torch.inference_mode():
        for fn in workloads.values():
            fn()
        torch.cuda.synchronize()
        for mode in ("plain", "lead", "filler", "sleep"):
            for name, fn in workloads.items():
                lost, kept, markers = 0, [], collections.Counter()
                for _ in range(args.traces):
                    events = window(fn, args.calls, mode, filler)
                    counts = collections.Counter(e.name for e in events
                                                 if MARKER not in e.name and
                                                 "fill" not in e.name.lower())
                    n_markers = sum(MARKER in e.name for e in events)
                    whole = counts and all(c % args.calls == 0 for c in counts.values())
                    if whole and n_markers == 2:
                        continue
                    lost += 1
                    first = bool(events) and MARKER in events[0].name
                    last = bool(events) and MARKER in events[-1].name
                    markers[f"first marker {'kept' if first else 'lost'}, last "
                            f"{'kept' if last else 'lost'}"] += 1
                    per_call = max(1, round(max(counts.values(), default=0) / args.calls))
                    kept.append(sum(counts.values()) / (per_call * args.calls * len(counts))
                                if counts else 0.0)
                print(f"{mode} {name}: {lost} of {args.traces} windows of {args.calls} calls "
                      f"lost records; {dict(markers)}; kept "
                      f"{[round(k, 3) for k in kept]}", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
