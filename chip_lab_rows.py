"""Variants of the sparse row rules (``recommender_system_tpu_torch/csrc/
sparse_rows.cu``), timed in turns on one card.

Run from the repository root, on a machine with one H100:

    python3 chip_lab_rows.py [--variants base,late,...] [--parent DIR]

Each variant is the source with the text replacements listed in VARIANTS
(each must match as often as stated), compiled with the port's nvcc flags
into ``recommender_system_tpu_torch/build/lab/`` (all compiles started
together) and called through ctypes; ``--parent DIR`` adds the source of
another tree (``DIR/recommender_system_tpu_torch/csrc/sparse_rows.cu``,
whose rules take ``lr`` and Adam's corrections by value) as the variant
``parent``. Adagrad, SGD and lazy Adam run on ``bench.py``'s stream
(N=425,984 into 2,600,000 rows of dim 9), on the same stream with every
other id on one hot row, and on DIN's step stream (two sites of table_d32,
~184,850 positions on the padding row, whose cotangents are zero). Each
prints the device time from the profiler, in the order base, the
variants, base, whether the variant's tables equal the base's bitwise on
the bench stream, and ptxas' registers and spills.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

CSRC = Path(__file__).resolve().parent / "recommender_system_tpu_torch" / "csrc"

_START = """  if constexpr (kRule == Rule::kSgd || kAdam) h.lr = h.step[0];
  if constexpr (kAdam) {
    h.bc1 = h.step[1];
    h.bc2 = h.step[2];
  }
"""
_ADAGRAD = "__fmul_rn(__fmul_rn(h.step[0], gk), inv)"
# name -> [(old, new, times it must match)]; base is the source: SGD and
# Adam load their scalars at the kernel's start, Adagrad where it updates
VARIANTS = {
    "base": [],
    # every rule's scalars loaded at the kernel's start
    "start": [(_START, _START.replace("kRule == Rule::kSgd || kAdam",
                                      "kRule != Rule::kScatterAdd"), 1),
              (_ADAGRAD, _ADAGRAD.replace("h.step[0]", "h.lr"), 1)],
    # every rule's scalars loaded where it uses them, the parameter struct
    # left as the launch gave it
    "late": [(_START, "", 1), ("h.lr", "h.step[0]", 2), ("h.bc1", "h.step[1]", 1),
             ("h.bc2", "h.step[2]", 1)],
    # as late, the loads through the read-only cache
    "late_ldg": [(_START, "", 1), ("h.step[0]", "__ldg(h.step)", 1),
                 ("h.lr", "__ldg(h.step)", 2), ("h.bc1", "__ldg(h.step + 1)", 1),
                 ("h.bc2", "__ldg(h.step + 2)", 1)],
}
RULES = ("adagrad", "sgd", "adam")


def build(names, parent):
    from recommender_system_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_DIR / "lab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
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
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def launcher(lib, by_value: bool):
    """rule -> fn(state, slid, order, ct): one launch of the variant's rule
    on ``state`` (the table and its slots) at step 0."""
    from recommender_system_tpu_torch.ops.fused_adagrad import adam_scalars

    P, I, I64, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lr, sgd_lr = cs.LR, cs.SGD_LR
    adam = adam_scalars(cs.ADAM_LR, 0, 0.9, 0.999)
    hyper = {"adagrad": cs.on_card(lr), "sgd": cs.on_card(sgd_lr), "adam": cs.on_card(*adam)}
    stream = torch.cuda.current_stream().cuda_stream
    if by_value:
        lib.fused_adagrad_rows.argtypes = [P] * 5 + [I64, I, F, F, P]
        lib.fused_sgd_rows.argtypes = [P] * 4 + [I64, I, F, P]
        lib.fused_adam_rows.argtypes = [P] * 6 + [I64, I] + [F] * 8 + [P]
    else:
        lib.fused_adagrad_rows.argtypes = [P] * 5 + [I64, I, P, F, P]
        lib.fused_sgd_rows.argtypes = [P] * 4 + [I64, I, P, P]
        lib.fused_adam_rows.argtypes = [P] * 6 + [I64, I, P] + [F] * 5 + [P]

    def run(rule, state, slid, order, ct):
        n, dim = slid.shape[0], ct.shape[1]
        ptrs = [slid.data_ptr(), order.data_ptr(), ct.data_ptr()]
        if rule == "adagrad":
            step = [lr] if by_value else [hyper[rule].data_ptr()]
            err = lib.fused_adagrad_rows(*ptrs, state[0].data_ptr(), state[1].data_ptr(), n,
                                         dim, *step, cs.EPS, stream)
        elif rule == "sgd":
            step = [sgd_lr] if by_value else [hyper[rule].data_ptr()]
            err = lib.fused_sgd_rows(*ptrs, state[0].data_ptr(), n, dim, *step, stream)
        else:
            tables = [t.data_ptr() for t in state[:3]]
            if by_value:
                err = lib.fused_adam_rows(*ptrs, *tables, n, dim, adam[0], 0.9, 0.999, 1e-8,
                                          adam[1], adam[2], 1.0 - 0.9, 1.0 - 0.999, stream)
            else:
                err = lib.fused_adam_rows(*ptrs, *tables, n, dim, hyper[rule].data_ptr(),
                                          0.9, 0.999, 1e-8, 1.0 - 0.9, 1.0 - 0.999, stream)
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


def fresh(rows, dim):
    gen = torch.Generator(device="cuda").manual_seed(5)
    table = torch.randn(rows, dim, generator=gen, device="cuda") * 1e-2
    return [table, torch.full_like(table, 0.1), torch.zeros_like(table)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--parent", help="a tree whose sparse_rows.cu is the variant parent")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_lab_rows: no CUDA device", file=sys.stderr)
        return 2
    names = [n for n in args.variants.split(",") if n != "base"]
    if args.parent:
        names.append("parent")
    libs = build(["base", *names], args.parent)
    runs = {name: launcher(lib, by_value=name == "parent") for name, lib in libs.items()}
    order = ["base", *names, "base"]
    for label, (slid, order_, ct, rows, dim) in streams().items():
        for rule in RULES:
            want = None
            for name in order:
                state = fresh(rows, dim)
                if rule == "adam":
                    state = [state[0], torch.zeros_like(state[0]), torch.zeros_like(state[0])]
                runs[name](rule, state, slid, order_, ct)
                torch.cuda.synchronize()
                same = ""
                if label == "bench":
                    if want is None:
                        want = [t.clone() for t in state]
                    same = (", bitwise equal to base" if all(torch.equal(a, b) for a, b in
                                                           zip(state, want)) else
                            ", DIFFERS from base")
                ms = sum(cs.device_ms(lambda: runs[name](rule, state, slid, order_, ct),
                                      iters=5 if label != "bench" else 50).values())
                print(f"{rule} on {label} variant {name}: device {ms:.5f} ms{same}", flush=True)
                del state
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
