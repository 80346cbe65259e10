"""One run of one cell: set-up, the measured window, an optional traced
slice, and the check of set-up's steps against the plain reference.

Set-up makes the traffic (a pool of ``POOL_GROUPS`` groups of K batches)
and the initial weights on the device from the seed, builds the port's
model and ``Trainer`` (the configuration's dense and fused sparse
optimizers), loads the weights into the model, and makes the
``CHECK_CALLS`` calls of ``Trainer.multi_step`` on groups 0, 1 and 2: the
first runs the steps one by one, the second captures the K-step graph and
replays it, the third replays it as the window does, its inputs and step
scalars copied in. After them it reads the program's state: each leaf's
change from the initial weights and each optimizer slot's change from its
start (float64 norms), with the three calls' losses. The window then calls
``Trainer.multi_step`` on the next group, in turn, for ``seconds`` of the
host's clock, and ends in a synchronise. Once the window has closed and
the memory peak is read, the program is freed and the reference follows
the same ``CHECK_CALLS`` x K steps from weights and batches drawn again
from the seed.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

from . import generate, weights
from .reference import common as reference_common

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
POOL_GROUPS = 16
# set-up's calls, whose steps the reference follows: warm, capture and replay, replay
CHECK_CALLS = 3
TRACE_CALLS = 5
# calls timed on the host after the window, the device drained first
HOST_CALLS = 10
# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone (a bias under softmax): their change and their
# slots' are not held
MOVED_SHARE = 1e-3
# the program's optimizer slots, by the names the reference gives them
SLOT_NAMES = {"sum_of_squares": "acc", "mu": "m", "nu": "v"}
FUSED_SLOTS = {"sgd": (), "adagrad": ("acc",), "lazy_adam": ("m", "v")}
# modules that may not be loaded when a run prints its result, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "recommender_system_tpu")


# ---------------------------------------------------------------------------
# what a cell is made of, found by name

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    benchmark: dict

    @property
    def family(self) -> ModuleType:
        return importlib.import_module(f"{__package__}.models.{self.config['model']}")

    @property
    def reference(self) -> ModuleType:
        return importlib.import_module(f"{__package__}.reference.{self.config['model']}")


def load_cell(name: str) -> Cell:
    benchmark = load_json(ROOT / "BENCHMARK.json")
    by_name = {w["name"]: w for w in benchmark["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
    workload = by_name[name]
    configs = {c["name"]: c for c in benchmark["configs"]}
    config = load_json(ROOT / configs[workload["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{workload['traffic']}.json")
    limits_file = BENCH / "limits" / f"{name}.json"
    limits = load_json(limits_file)["limits"] if limits_file.exists() else {}
    return Cell(workload, config, traffic, limits, benchmark)


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``, whose ``read(ctx)`` gives the metric or None."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_patterns(name: str) -> List[str]:
    """The union of the kernel-name patterns in ``metrics/<name>/*.json``."""
    out = []
    for path in sorted((BENCH / "metrics" / name).glob("*.json")):
        out += load_json(path)["kernels"]
    return out


# ---------------------------------------------------------------------------
# set-up

def set_precision(config: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])


def optimizers(config: dict) -> tuple:
    """The port's dense and fused sparse optimizers the configuration states."""
    from recommender_system_tpu_torch import training as tr

    o, e = config["optimizer"], config["embedding_optimizer"]
    dense = {"sgd": lambda: tr.SGD(o["learning_rate"]),
             "adagrad": lambda: tr.Adagrad(o["learning_rate"], o["initial_accumulator_value"],
                                           o["eps"]),
             "adam": lambda: tr.Adam(o["learning_rate"], o["b1"], o["b2"], o["eps"])}
    fused = {"sgd": lambda: tr.FusedSGD(learning_rate=e["learning_rate"]),
             "adagrad": lambda: tr.FusedAdagrad(
                 learning_rate=e["learning_rate"], eps=e["eps"],
                 initial_accumulator_value=e["initial_accumulator_value"]),
             "lazy_adam": lambda: tr.FusedAdam(learning_rate=e["learning_rate"], b1=e["b1"],
                                               b2=e["b2"], eps=e["eps"])}
    return dense[o["name"]](), fused[e["name"]]()


@dataclasses.dataclass
class Program:
    trainer: object
    pool: list
    readings: dict             # the program's state after set-up's calls
    phases: Dict[str, float]   # set-up's seconds by phase


def slot_start(rule: dict, slot: str) -> float:
    return float(rule["initial_accumulator_value"]) if slot == "acc" else 0.0


def gap_norm(t: torch.Tensor, start, rows: int = 1 << 20) -> float:
    """The float64 norm of ``t - start`` (``start`` a tensor of ``t``'s
    shape or a number), a block of ``rows`` rows at a time, so that a large
    table adds little to the device's peak."""
    total = 0.0
    flat = t.reshape(t.shape[0], -1) if t.dim() else t.reshape(1, 1)
    base = start.reshape(flat.shape) if isinstance(start, torch.Tensor) else None
    for lo in range(0, flat.shape[0], rows):
        block = flat[lo:lo + rows].double()
        block -= base[lo:lo + rows].double() if base is not None else float(start)
        total += float(block.square().sum())
    return math.sqrt(total)


@torch.no_grad()
def read_state(trainer, config: dict, initial: Dict[str, torch.Tensor],
               losses: torch.Tensor) -> dict:
    """The losses, each leaf's change from ``initial`` and each optimizer
    slot's change from its start, as ``<leaf>.<slot>`` (float64 norms), read
    from the Trainer's state as the next call finds it."""
    params = dict(trainer.model.named_parameters())
    change = {n: gap_norm(p.detach(), initial[n]) for n, p in params.items()}
    state = {}
    for n, slots in trainer.opt_state.items():
        for key, t in slots.items():
            slot = SLOT_NAMES[key]
            state[f"{n}.{slot}"] = gap_norm(t, slot_start(config["optimizer"], slot))
    rule = config["embedding_optimizer"]
    for n, slots in trainer.fused_slots.items():
        for slot, t in zip(FUSED_SLOTS[rule["name"]], slots, strict=True):
            state[f"{n}.{slot}"] = gap_norm(t, slot_start(rule, slot))
    return {"losses": [float(v) for v in losses], "change": change, "state": state}


def set_up(cell: Cell, seed: int, device) -> Program:
    """The pool, the weights, the model and its Trainer from the seed, the
    calls that warm, capture and replay the graph, and the state they
    leave."""
    from recommender_system_tpu_torch.training import Trainer

    config = cell.config
    set_precision(config)
    family = cell.family
    phases, t = {}, time.perf_counter()

    def phase(name: str) -> None:
        nonlocal t
        synchronize(device)
        now = time.perf_counter()
        phases[name], t = now - t, now

    pool = generate.make_pool(config, cell.traffic, seed, device, POOL_GROUPS)
    initial = weights.draw(family.leaves(config, cell.traffic), seed, device)
    phase("traffic and weights")
    model = family.build(config, cell.traffic, device,
                         torch.Generator(device=device).manual_seed(0))
    params = dict(model.named_parameters())
    if {n: tuple(p.shape) for n, p in params.items()} != {
            n: tuple(w.shape) for n, w in initial.items()}:
        raise RuntimeError(f"the model's leaves {sorted(params)} are not the "
                           f"benchmark's {sorted(initial)}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(initial[n])
    dense, fused = optimizers(config)
    trainer = Trainer(model, dense, fused_embedding=fused, device=device)
    phase("model and trainer")
    losses = []
    for g, name in enumerate(("first call (kernels loaded or built)",
                              "second call (capture and replay)", "third call (replay)")):
        losses.append(trainer.multi_step(*pool[g]))
        phase(name)
    readings = read_state(trainer, config, initial, torch.cat(losses))
    del initial
    phase("state read")
    return Program(trainer, pool, readings, phases)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the window

@dataclasses.dataclass
class Window:
    seconds: float
    calls: int
    steps: int
    examples: int
    step_ms: List[float]      # each call's completion to the next's, over K
    groups: List[int]         # the pool group of each call


def measure(program: Program, seconds: float, device,
            first_group: int = CHECK_CALLS) -> Window:
    """Call ``multi_step`` on the pool's groups in turn for ``seconds`` of
    the host's clock; the window ends when the device has finished. On the
    card a CUDA event after each call, read once the window has closed,
    times each call's completion against the one before (a host stall
    between calls counts)."""
    trainer, pool = program.trainer, program.pool
    cuda = torch.device(device).type == "cuda"
    k, batch = pool[0][1].shape
    events, groups, marks = [], [], []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    g = first_group
    t0 = time.perf_counter()
    while True:
        columns, labels = pool[g % len(pool)]
        trainer.multi_step(columns, labels)
        h1 = time.perf_counter()
        if cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            events.append(event)
        else:
            marks.append(h1)
        groups.append(g % len(pool))
        g += 1
        if h1 - t0 >= seconds:
            break
    synchronize(device)
    t1 = time.perf_counter()
    if cuda:
        step_ms = [start.elapsed_time(events[0]) / k]
        step_ms += [a.elapsed_time(b) / k for a, b in zip(events, events[1:])]
    else:
        step_ms = [(b - a) * 1e3 / k for a, b in zip([t0] + marks, marks)]
    calls = len(groups)
    return Window(t1 - t0, calls, calls * k, calls * k * batch, step_ms, groups)


def host_calls(program: Program, first_group: int, device) -> List[float]:
    """The host's ms inside each of ``HOST_CALLS`` calls, each issued after
    the device has drained, so that none waits for room in the launch queue:
    copying the inputs and the steps' scalars in and launching the replay."""
    out = []
    for i in range(HOST_CALLS):
        columns, labels = program.pool[(first_group + i) % len(program.pool)]
        synchronize(device)
        h0 = time.perf_counter()
        program.trainer.multi_step(columns, labels)
        out.append((time.perf_counter() - h0) * 1e3)
    synchronize(device)
    return out


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    ordered = sorted(values)
    pos = (len(ordered) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def take_trace(program: Program, first_group: int):
    from torch.profiler import record_function

    from . import trace

    trainer, pool = program.trainer, program.pool
    groups = []

    def call(i: int) -> None:
        with record_function("rotate"):
            g = (first_group + i) % len(pool)
            columns, labels = pool[g]
        with record_function("multi_step"):
            trainer.multi_step(columns, labels)
        groups.append(g)

    got = trace.take(call, TRACE_CALLS)
    return got, groups[-TRACE_CALLS:]


# ---------------------------------------------------------------------------
# the check

def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves) -> tuple:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; and that leaf."""
    leaves = list(leaves)
    median = statistics.median(ref[n] for n in leaves)
    worst, at = 0.0, None
    for n in leaves:
        scale = max(ref[n], median)
        gap = abs(prog.get(n, math.nan) - ref[n]) / scale if scale > 0 else 0.0
        if not gap <= worst:
            worst, at = gap, n
    return worst, at


def numbers(prog: dict, ref: dict) -> Dict[str, tuple]:
    """Each number compared, with where it is worst: ``loss_gap``, the
    largest relative gap of the steps' losses; ``change_gap``, each leaf's
    change after the steps, by the worst leaf; ``state_gap``, where the
    optimizers keep state, each slot's change, by the worst slot, each kind
    of slot (``acc``, ``m``, ``v``: a gradient's sum, mean or square) against
    its own median. Both over the leaves the reference's first gradient
    moves (``MOVED_SHARE``)."""
    loss = max((abs(p - r) / abs(r), s) for s, (p, r) in
               enumerate(zip(prog["losses"], ref["losses"], strict=True)))
    loss = (math.nan, None) if any(math.isnan(p) for p in prog["losses"]) else loss
    median = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= MOVED_SHARE * median]
    out = {"loss_gap": loss, "change_gap": worst_leaf(prog["change"], ref["change"], moved)}
    kinds: Dict[str, List[str]] = {}
    for s in ref["state"]:
        leaf, kind = s.rsplit(".", 1)
        if leaf in moved:
            kinds.setdefault(kind, []).append(s)
    if kinds:
        out["state_gap"] = max((worst_leaf(prog["state"], ref["state"], slots)
                                for slots in kinds.values()), key=lambda g: g[0])
    return out


def tables(cell: Cell) -> List[str]:
    """The leaves the fused sparse optimizer updates: the embedding tables."""
    return [n for n in cell.family.leaves(cell.config, cell.traffic)
            if n.rsplit(".", 1)[-1].startswith("table_d")]


def follow_reference(cell: Cell, seed: int, device, control: bool = False,
                     fault: Optional[str] = None) -> dict:
    """The reference's steps over set-up's groups from the weights and the
    groups drawn again from the seed, in float32 with TF32 off (or as the
    control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initial = weights.draw(cell.family.leaves(cell.config, cell.traffic), seed, device)
    groups = generate.make_pool(cell.config, cell.traffic, seed, device,
                                POOL_GROUPS)[:CHECK_CALLS]
    return reference_common.follow(cell.reference.loss, cell.config, initial, groups,
                                   tables(cell), control=control, fault=fault)


def judge(cell: Cell, got: Dict[str, tuple]) -> tuple:
    """(correct, {number: {value, limit}}): correct where every number is at
    most its limit; a number with no limit, or that is not a number, fails."""
    compared, correct = {}, True
    for name, (value, _) in got.items():
        limit = cell.limits.get(name)
        compared[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            correct = False
    return correct, compared


# ---------------------------------------------------------------------------
# one run

class Context:
    """What a per-layer metric's reader reads (``metrics/<name>.py``)."""

    def __init__(self, name: str, cell: Cell, window: Window, host_ms: List[float], trace,
                 traced_groups: List[int], pool):
        self.name, self.cell, self.window, self.trace = name, cell, window, trace
        self.config, self.host_ms = cell.config, host_ms
        self._pool, self._family, self._traced = pool, cell.family, traced_groups
        self._stats: Dict[tuple, dict] = {}

    def patterns(self) -> List[str]:
        return metric_patterns(self.name)

    def stats(self, group: int, step: int) -> dict:
        key = (group, step)
        if key not in self._stats:
            columns, _ = self._pool[group]
            self._stats[key] = self._family.step_stats(
                self.config, {k: v[step] for k, v in columns.items()})
        return self._stats[key]

    def traced_steps(self) -> List[dict]:
        k = self._pool[0][1].shape[0]
        return [self.stats(g, s) for g in self._traced for s in range(k)]

    def window_steps(self):
        """(stats, how many times the window ran that step) of every step of
        every group the window ran."""
        k = self._pool[0][1].shape[0]
        counts: Dict[int, int] = {}
        for g in self.window.groups:
            counts[g] = counts.get(g, 0) + 1
        return [(self.stats(g, s), n) for g, n in sorted(counts.items()) for s in range(k)]

    def step_flops(self, stats: dict) -> int:
        return self._family.step_flops(self.config, stats)


def card() -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        out["power_limit"] = line.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "not read"
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_per_layer(cell: Cell, program: Program, window: Window, device) -> tuple:
    """After the window: ``HOST_CALLS`` calls timed on the host, then
    ``TRACE_CALLS`` traced (on the card), and each per-layer metric of the
    cell that its reader finds. Returns (metrics, the device's busy and
    traced seconds, the breakdown)."""
    name = cell.workload["name"]
    after = (CHECK_CALLS + window.calls) % POOL_GROUPS
    host_ms = host_calls(program, after, device)
    tr, traced_groups = None, []
    if torch.device(device).type == "cuda":
        tr, traced_groups = take_trace(program, (after + HOST_CALLS) % POOL_GROUPS)
    metrics = {}
    for metric in cell.benchmark["per_layer"]:
        if name not in metric.get("workloads", [name]):
            continue
        ctx = Context(metric["name"], cell, window, host_ms, tr, traced_groups, program.pool)
        value = metric_reader(metric["name"]).read(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    if tr is None:
        return metrics, {}, None
    return (metrics, {"busy_s": tr.busy_ms() / 1e3, "window_s": tr.span_ms / 1e3},
            {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()})


def run(cell: Cell, seed: int, seconds: float, traced: bool, started: float,
        device="cuda") -> dict:
    """One run of ``cell``; returns the result line's object, whose
    ``compared`` entry comes last, with ``notes`` for standard error.
    ``started`` is the process's start on the host's clock (``time.time()``)."""
    name = cell.workload["name"]
    program = set_up(cell, seed, device)
    setup_s = time.time() - started
    window = measure(program, seconds, device)
    cuda = torch.device(device).type == "cuda"
    out: dict = {"correct": False, "attempted": window.steps, "failed": 0}
    out["device"] = card() if cuda else {"platform": "cpu", "kind": "cpu", "count": 1}
    if traced:
        out["metrics"], busy, breakdown = read_per_layer(cell, program, window, device)
        out["device"].update(busy)
        if breakdown is not None:
            out["breakdown"] = breakdown
    else:
        computed = {"train_examples_per_s": window.examples / window.seconds,
                    "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": computed[m["name"]], "unit": m["unit"]}
                          for m in cell.benchmark["end_to_end"]
                          if name in m.get("workloads", [name])}
    out["device"]["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    prog, program_phases = program.readings, program.phases
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["correct"], compared = judge(cell, numbers(prog, follow_reference(cell, seed, device)))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded that the benchmark may not load: {found}")
    ms = window.step_ms
    out["notes"] = [
        f"set-up {setup_s:.3f} s: imports and the card's context "
        f"{setup_s - sum(program_phases.values()):.3f} s, " + ", ".join(
            f"{k} {v:.3f} s" for k, v in program_phases.items()),
        f"window: {window.calls} calls in {window.seconds:.3f} s; ms a step p5 "
        f"{percentile(ms, 5):.4f} p25 {percentile(ms, 25):.4f} p50 {percentile(ms, 50):.4f} "
        f"p75 {percentile(ms, 75):.4f} p95 {percentile(ms, 95):.4f} max {max(ms):.4f}, "
        f"mean {statistics.fmean(ms):.4f}",
        "ms a step, mean of each 50 calls: " + " ".join(
            f"{statistics.fmean(ms[i:i + 50]):.3f}" for i in range(0, len(ms), 50))]
    out["compared"] = compared
    return out
