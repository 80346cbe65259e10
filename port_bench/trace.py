"""A short traced slice of calls, read from ``torch.profiler``: the device's
intervals by name, the benchmark's host spans, the busy time as the union
of the device intervals (``chip_smoke.py``'s ``device_busy_from_trace``,
over events instead of a file), and the idle gaps named by the host span
they fall in.

The profiler now and then loses device records, most often the first after
a trace begins (``chip_smoke.py``'s ``device_ms``), so a trace begins with
a lead-in of sleep kernels and a synchronise, not counted, and every
kernel's records must come to a whole multiple of the calls traced (each
call replays one graph); a trace that does not is taken again."""
from __future__ import annotations

import collections
import dataclasses
import re
import sys
from typing import Callable, Dict, Iterable, List, Tuple

import torch

LEAD_IN, LEAD_IN_CYCLES, LEAD_IN_KERNEL = 64, 20_000, "spin"
TRACES = 4
SPANS = ("rotate", "multi_step", "record", "sync")

Interval = Tuple[str, float, float]   # name, start us, end us


@dataclasses.dataclass
class Trace:
    device: List[Interval]   # kernels, copies and sets, in the traced span
    spans: List[Interval]    # the benchmark's host spans
    start: float
    end: float
    calls: int

    @property
    def span_ms(self) -> float:
        return (self.end - self.start) / 1e3

    def busy_ms(self) -> float:
        """The union of the device intervals within the span."""
        busy, reach = 0.0, self.start
        for _, lo, hi in sorted(self.device, key=lambda e: e[1]):
            if hi > reach:
                busy += hi - max(lo, reach)
                reach = hi
        return busy / 1e3

    def device_ms(self, patterns: Iterable[str]) -> float:
        """Device ms of the intervals whose name matches any pattern."""
        regexes = [re.compile(p) for p in patterns]
        return sum(hi - lo for name, lo, hi in self.device
                   if any(r.search(name) for r in regexes)) / 1e3

    def top_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = collections.Counter()
        for name, lo, hi in self.device:
            by_name[name] += (hi - lo) / 1e6
        return [[name, s] for name, s in by_name.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches in which the device ran nothing, each named
        by the host span it began in (``host`` outside every span)."""
        gaps, reach = [], self.start
        for _, lo, hi in sorted(self.device, key=lambda e: e[1]):
            if lo > reach:
                gaps.append((reach, lo))
            reach = max(reach, hi)
        named = []
        for lo, hi in gaps:
            around = [s for s in self.spans if s[1] <= lo < s[2]]
            name = min(around, key=lambda s: s[2] - s[1])[0] if around else "host"
            named.append([name, (hi - lo) / 1e6])
        return sorted(named, key=lambda g: -g[1])[:n]


def take(call: Callable[[int], None], calls: int) -> Trace:
    """Trace ``calls`` calls of ``call(i)``, which opens the benchmark's own
    spans (a ``multi_step`` span around each call), after the device has
    drained. The traced span runs from the second call's start (the first
    call's own issue, with nothing queued before it, is the drain's doing,
    not the program's) to the end of the last device operation; every
    call's device operations count in the breakdown."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(TRACES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(LEAD_IN_CYCLES)
            torch.cuda.synchronize()
            for i in range(calls):
                call(i)
            with record_function("sync"):
                torch.cuda.synchronize()
        device, spans = [], []
        for e in prof.events():
            lo, hi = e.time_range.start, e.time_range.end
            if e.name in SPANS:
                # a span's host range; its copy on the device's timeline is no work
                if e.device_type != DeviceType.CUDA:
                    spans.append((e.name, lo, hi))
            elif e.device_type == DeviceType.CUDA and LEAD_IN_KERNEL not in e.name:
                device.append((e.name, lo, hi))
        if not spans or not device:
            continue
        first = min(s[1] for s in spans)
        device = [d for d in device if d[1] >= first]
        if not device:
            continue
        calls_at = sorted(lo for name, lo, _ in spans if name == "multi_step")
        start = max(min(d[1] for d in device), calls_at[min(1, len(calls_at) - 1)])
        end = max(d[2] for d in device)
        records = collections.Counter(name for name, _, _ in device)
        if all(count % calls == 0 for count in records.values()):
            return Trace(device, spans, start, end, calls)
        print(f"trace: {calls} calls held {dict(records)} records, not a multiple of "
              f"{calls} a kernel; tracing again", file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler lost device records (or saw none) in {TRACES} traces")
