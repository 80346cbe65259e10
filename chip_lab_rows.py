"""Variants of the sparse row rules (``recommender_system_tpu_torch/csrc/
sparse_rows.cu``), timed in turns on one card.

Run from the repository root, on a machine with one H100:

    python3 chip_lab_rows.py [--variants chunk128,...] [--parent DIR] [--equal]

Each variant is the source with the text replacements listed in VARIANTS
(each must match as often as stated), compiled with the port's nvcc flags
into ``recommender_system_tpu_torch/build/lab/`` (all compiles started
together) and called through ctypes; ``--parent DIR`` adds the source of
another tree (``DIR/recommender_system_tpu_torch/csrc/sparse_rows.cu``) as
the variant ``parent``: a rule whose C function in that source takes no
long-path scratch is called without it. The scatter-add, Adagrad, SGD and
lazy Adam run on ``bench.py``'s stream (N=425,984 into 2,600,000 rows of
dim 9), on the same stream with every other id on one hot row, and on
DIN's step stream (two sites of table_d32, ~184,850 positions on the
padding row, whose cotangents are zero). Each prints the device time from
the profiler, in the order base, the variants, base, whether the variant's
tables equal the base's bitwise, and ptxas' registers and spills.
``--equal`` instead runs every rule of every variant once on each stream
of ``chip_smoke.py``'s phase 2 (``sparse_cases``) and prints whether its
tables equal the base's bitwise.

(The earlier variants of where the rules load their step scalars are gone
with the long path, whose pass 2 reads them too; their times are in
PERF.md.)
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

CSRC = Path(__file__).resolve().parent / "recommender_system_tpu_torch" / "csrc"

_CHUNK = "constexpr int64_t kChunk = 256;"
_WALK = "__launch_bounds__(kThreads)\nsparse_rows_kernel("
_ADAM_BATCH = "constexpr int kAdamBatch = 2;"
_NO_PASS2 = ("  sparse_rows_long_kernel<kRule><<<", "  if (false) sparse_rows_long_kernel<kRule><<<",
             1)


# name -> [(old, new, times it must match)]; base is the source
VARIANTS = {
    "base": [],
    # the long path's chunk (and the length from which a segment is long)
    "chunk128": [(_CHUNK, _CHUNK.replace("256", "128"), 1)],
    "chunk512": [(_CHUNK, _CHUNK.replace("256", "512"), 1)],
    # timing probes on streams with no long segment (wrong where one is):
    # no pass 2; neither pass; no long check in the walk
    "nopass2": [_NO_PASS2],
    "nopasses": [_NO_PASS2,
                 ("<<<static_cast<unsigned>(blocks + lng.blocks)",
                  "<<<static_cast<unsigned>(blocks)", 1),
                 ("static_cast<float*>(s2), n, dim, h, lng);",
                  "static_cast<float*>(s2), n, dim, h, Long{nullptr, nullptr, 0});", 1)],
    "nocheck": [("is_long = p + kLong <= n && slid[p + kLong - 1] == row;", "is_long = false;",
                 1)],
    # the walk kernel's registers (lazy Adam's spills once pass 1 shares
    # its kernel): pass 1 compiled as a call; a floor of one block an SM;
    # a cap of 168 registers in place of the launch bounds
    "noinline": [("__device__ __forceinline__ void chunk_pass(",
                  "__device__ __noinline__ void chunk_pass(", 1)],
    "lb1": [(_WALK, _WALK.replace("(kThreads)", "(kThreads, 1)"), 1)],
    "maxreg168": [(_WALK, _WALK.replace("__launch_bounds__(kThreads)", "__maxnreg__(168)"), 1)],
    # lazy Adam's loads in flight in its walk (2 in the source; 4, the other
    # rules' kBatch, spills)
    "adam_batch3": [(_ADAM_BATCH, _ADAM_BATCH.replace("2", "3"), 1)],
    "adam_batch4": [(_ADAM_BATCH, _ADAM_BATCH.replace("2", "4"), 1)],
}
RULES = ("scatter", "adagrad", "sgd", "adam")
# each rule's C function in the source
FUNCTIONS = {"scatter": "scatter_add_rows", "adagrad": "fused_adagrad_rows",
             "sgd": "fused_sgd_rows", "adam": "fused_adam_rows"}
# the long-path scratch is sized for chunks of this many positions, the
# least any variant takes
SCRATCH_CHUNK = 64


def build(names, parent):
    from recommender_system_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_DIR / "lab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs, scratch = {}, {}
    for name in names:
        if name == "parent":
            text = (Path(parent) / "recommender_system_tpu_torch" / "csrc" /
                    "sparse_rows.cu").read_text()
        else:
            text = (CSRC / "sparse_rows.cu").read_text()
            for old, new, times in VARIANTS[name]:
                if text.count(old) != times:
                    raise RuntimeError(f"variant {name}: {old!r} matches {text.count(old)} "
                                       f"times, not {times}")
                text = text.replace(old, new)
        cu = out_dir / f"sparse_rows_{name}.cu"
        cu.write_text(text)
        scratch[name] = {
            rule: "void* partial" in re.search(rf'extern "C" int {fn}\(([^)]*)\)', text).group(1)
            for rule, fn in FUNCTIONS.items()}
        lib = out_dir / f"libsparse_rows_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        figures = [line.strip() for line in log.splitlines()
                   if "registers" in line or "spill" in line]
        print(f"built {name}: {' | '.join(figures)}", flush=True)
        libs[name] = (ctypes.CDLL(str(lib)), scratch[name])
    return libs


def launcher(lib, scratch: dict):
    """rule -> fn(state, slid, order, ct): one launch of the variant's rule
    on ``state`` (the table and its slots) at step 0; ``scratch[rule]``: the
    source's function for the rule takes the long path's scratch."""
    from recommender_system_tpu_torch.ops.fused_adagrad import adam_scalars

    P, I, I64, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lr, sgd_lr = cs.LR, cs.SGD_LR
    adam = adam_scalars(cs.ADAM_LR, 0, 0.9, 0.999)
    hyper = {"adagrad": cs.on_card(lr), "sgd": cs.on_card(sgd_lr), "adam": cs.on_card(*adam)}
    stream = torch.cuda.current_stream().cuda_stream
    extra = {rule: [P, P] if takes else [] for rule, takes in scratch.items()}
    lib.scatter_add_rows.argtypes = [P] * 4 + extra["scatter"] + [I64, I, P]
    lib.fused_adagrad_rows.argtypes = [P] * 5 + extra["adagrad"] + [I64, I, P, F, P]
    lib.fused_sgd_rows.argtypes = [P] * 4 + extra["sgd"] + [I64, I, P, P]
    lib.fused_adam_rows.argtypes = [P] * 6 + extra["adam"] + [I64, I, P] + [F] * 5 + [P]

    def run(rule, state, slid, order, ct):
        n, dim = slid.shape[0], ct.shape[1]
        ptrs = [slid.data_ptr(), order.data_ptr(), ct.data_ptr()]
        chunks = -(-n // SCRATCH_CHUNK)
        partial = torch.empty(chunks, 2, dim, device="cuda")
        starts = torch.empty(chunks, dtype=torch.int64, device="cuda")
        long_path = [partial.data_ptr(), starts.data_ptr()] if scratch[rule] else []
        if rule == "scatter":
            err = lib.scatter_add_rows(*ptrs, state[0].data_ptr(), *long_path, n, dim, stream)
        elif rule == "adagrad":
            err = lib.fused_adagrad_rows(*ptrs, state[0].data_ptr(), state[1].data_ptr(),
                                         *long_path, n, dim, hyper[rule].data_ptr(), cs.EPS,
                                         stream)
        elif rule == "sgd":
            err = lib.fused_sgd_rows(*ptrs, state[0].data_ptr(), *long_path, n, dim,
                                     hyper[rule].data_ptr(), stream)
        else:
            tables = [t.data_ptr() for t in state[:3]]
            err = lib.fused_adam_rows(*ptrs, *tables, *long_path, n, dim,
                                      hyper[rule].data_ptr(), 0.9, 0.999, 1e-8, 1.0 - 0.9,
                                      1.0 - 0.999, stream)
        if err != 0:
            raise RuntimeError(f"{rule} launch failed with CUDA error {err}")

    return run


def streams():
    """label -> (slid, order, ct, rows, dim)."""
    from recommender_system_tpu_torch.ops.stream_sort import blocked_sort, sort_ids

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, dim = cs.FIELDS * cs.VOCAB, cs.FACTOR_DIM + 1
    rows2d = torch.as_tensor(cs.bench_rows(0), device="cuda")
    lids = rows2d.reshape(-1)
    slid, order = blocked_sort(rows2d, [(f * cs.VOCAB, cs.VOCAB) for f in range(cs.FIELDS)])
    ct = torch.randn(lids.numel(), dim, generator=gen, device="cuda") * 1e-3
    hot = lids.clone()
    hot[::2] = 12_345
    din_lids = torch.as_tensor(cs.din_stream(cs.din_batch(0)[0]), device="cuda")
    din_ct = torch.randn(din_lids.numel(), cs.DIN_DIM, generator=gen, device="cuda") * 1e-3
    din_ct[din_lids == cs.DIN_USERS] = 0.0
    return {"bench": (slid, order, ct, rows, dim),
            "hot_row": (*sort_ids(hot), ct, rows, dim),
            "din_stream": (*sort_ids(din_lids), din_ct, cs.DIN_USERS + cs.DIN_ITEMS,
                           cs.DIN_DIM)}


def fresh(rule, rows, dim):
    """The tables ``rule`` updates, made the same way for every variant."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    table = torch.randn(rows, dim, generator=gen, device="cuda") * 1e-2
    if rule == "scatter":
        return [torch.zeros_like(table)]
    if rule == "adam":
        return [table, torch.zeros_like(table), torch.zeros_like(table)]
    return [table, torch.full_like(table, 0.1)]


def equal_on_phase2(runs, names) -> None:
    """Every rule of every variant once on each of phase 2's streams: its
    tables against the base's, bitwise; with the stream's count of long
    rows (a variant that sums them in another order may differ there)."""
    from recommender_system_tpu_torch.ops.kernels import SPARSE_CHUNK
    from recommender_system_tpu_torch.ops.stream_sort import sort_ids

    gen = torch.Generator(device="cuda").manual_seed(2)
    for case, lids, ct, rows in cs.sparse_cases(gen):
        if lids.numel() == 0:
            continue
        slid, order = sort_ids(lids)
        long_rows = int((torch.unique_consecutive(slid, return_counts=True)[1]
                         >= SPARSE_CHUNK).sum())
        for rule in RULES:
            results = {}
            for name in ["base", *names]:
                state = fresh(rule, rows, ct.shape[1])
                runs[name](rule, state, slid, order, ct)
                results[name] = state
            torch.cuda.synchronize()
            same = {name: all(map(torch.equal, results[name], results["base"]))
                    for name in names}
            print(f"{rule} on phase 2's {case} (N={lids.numel()}, dim={ct.shape[1]}, "
                  f"{long_rows} long rows): bitwise equal to base: {same}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default="chunk128,chunk512")
    parser.add_argument("--parent", help="a tree whose sparse_rows.cu is the variant parent")
    parser.add_argument("--equal", action="store_true",
                        help="compare the variants with base on phase 2's streams, no timing")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_lab_rows: no CUDA device", file=sys.stderr)
        return 2
    names = [n for n in args.variants.split(",") if n and n != "base"]
    if args.parent:
        names.append("parent")
    libs = build(["base", *names], args.parent)
    runs = {name: launcher(lib, scratch) for name, (lib, scratch) in libs.items()}
    if args.equal:
        equal_on_phase2(runs, names)
        print(cs.card_line())
        return 0
    order = ["base", *names, "base"]
    for label, (slid, order_, ct, rows, dim) in streams().items():
        for rule in RULES:
            want = None
            for name in order:
                state = fresh(rule, rows, dim)
                runs[name](rule, state, slid, order_, ct)
                torch.cuda.synchronize()
                if want is None:
                    want = [t.clone() for t in state]
                same = (", bitwise equal to base" if all(map(torch.equal, state, want))
                        else ", DIFFERS from base")
                dev = cs.device_ms(lambda: runs[name](rule, state, slid, order_, ct),
                                   iters=5 if label != "bench" else 50)
                split = ", ".join(f"{re.search(r'sparse_rows\w*', k).group(0)} {v:.5f}"
                                  for k, v in dev.most_common())
                print(f"{rule} on {label} variant {name}: device {sum(dev.values()):.5f} ms "
                      f"({split}){same}", flush=True)
                del state
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
