"""Check and time the DIN attention's backward kernel on the card.

    python3 chip_lab_din_backward.py [--skip-check] [--skip-time] [--variants a,b]

Builds ``csrc/din_attention.cu`` and prints the backward kernel's registers
and spills. The check holds ``din_attention_backward`` to
``din_attention_backward_ref`` on the card at phase 2's shapes of
``chip_smoke.py`` (``chip_smoke.din_backward_close``), two calls to each
other bitwise, and the forward's saved weights to its returned weights
bitwise. The timing, at B=8,192 and a 80-40 scorer, at DIN's shape (K=32,
T=50) and the global kernel's three (``DIN_GLOBAL_SHAPES``), times by CUDA
events: the kernel, its plain version, and the route it replaced (autograd
through ``din_attention_ref``, the forward run again), each with its peak
memory beyond the inputs (``torch.cuda.max_memory_allocated``), and the
kernel's bound (``chip_smoke.din_backward_bound``). ``--variants`` builds
text-edited copies of the source (``VARIANTS``) and times each one's
backward entry point in turns with the unedited source (``base``) at those
shapes; their results are not checked.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

FLAGS = [(a, wn, rs) for a in ("sigmoid", "relu") for wn in (True, False) for rs in (False, True)]
SRC = Path(__file__).resolve().parent / "recommender_system_tpu_torch" / "csrc" / "din_attention.cu"
# name -> [(text, its replacement)] in csrc/din_attention.cu
VARIANTS = {
    "base": [],
    # no products in the weight gradients' tasks (their sums still read
    # and written)
    "no_tasks": [("  tile_mma<kGroupTiles>(acc, k_tiles, g, i4, a, b);\n", "  (void)a; (void)b;\n")],
    # fewer warps with the weights in shared memory before 8 or more with
    # them in device memory
    "wts_smem1": [("constexpr int kLeastSmemWarps = 8;", "constexpr int kLeastSmemWarps = 1;")],
    # no staging of a pass's keys from device memory
    "no_stage": [("      keys_s[p * Sk + c] = p < n && c < K ? keys[(pos0 + p) * K + c] : 0.f;",
                  "      keys_s[p * Sk + c] = 0.f;")],
    # none of the three kernels before the main one
    "no_prep": [("  din_backward_pack<<<", "  if (false) din_backward_pack<<<"),
                ("  din_attention_global_kernel_row_terms<<<term_grid, kTermCols, 0, s>>>",
                 "  if (false) din_attention_global_kernel_row_terms<<<term_grid, kTermCols, 0, s>>>"),
                ("  din_backward_dlogits<<<", "  if (false) din_backward_dlogits<<<")],
    # neither kernel after the main one
    "no_tail": [("  din_backward_reduce<<<", "  if (false) din_backward_reduce<<<"),
                ("  din_backward_dq<<<", "  if (false) din_backward_dq<<<")],
    # every region in shared memory, as the compiler sees it (right only
    # where the plan puts them there)
    "smem_ptrs": [("  float* work = L.act_smem ? smem : act_global + blockIdx.x * L.act;",
                   "  float* work = smem;"),
                  ("    return off < L.staged ? staged + off : packed + off;",
                   "    return staged + off;"),
                  ("  float* accs = L.acc_smem ? staged + L.staged : partials + blockIdx.x * L.acc;",
                   "  float* accs = staged + L.staged;")],
    # never the first layer's weights alone in shared memory
    "no_layer1": [("fits(warps, true, kLayer1, false)", "false")],
}


def check() -> None:
    from recommender_system_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(4)
    failed = []
    for B, T, K, H1, H2, combos in cs.DIN_BACKWARD_CASES:
        q, keys, mask, weights = cs.din_inputs(gen, B, T, K, H1, H2)
        maskf = mask.float()
        for flags in (FLAGS if combos == "all" else FLAGS[:combos]):
            with torch.inference_mode():
                out, saved = kernels._din_launch(q, keys, maskf, *weights, *flags, True)
                scores, _ = kernels._din_launch(q, keys, maskf, *weights, flags[0], flags[1],
                                                True)
            if not torch.equal(saved, scores):
                raise RuntimeError(f"B={B} T={T} K={K} {flags}: the saved weights differ "
                                   "from the returned ones")
            cot = torch.randn(out.shape, generator=gen, device="cuda")
            try:
                note, _ = cs.din_backward_close(q, keys, maskf, weights, saved, cot, flags)
            except (AssertionError, RuntimeError) as err:
                failed.append(f"B={B} T={T} K={K} H1={H1} H2={H2} {flags}")
                note = f"FAILED: {err}"
            print(f"backward check B={B} T={T} K={K} H1={H1} H2={H2} {flags}: {note}",
                  flush=True)
    if failed:
        raise RuntimeError(f"the backward kernel failed its check at {failed}")


def peak_mb(fn) -> float:
    """Device memory that one call of ``fn`` allocates at its peak beyond
    what was allocated before it, in MB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def time_shapes() -> None:
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.din_vjp import din_attention_backward_ref
    from recommender_system_tpu_torch.ops.kernels import (din_attention_backward,
                                                          din_attention_fused, din_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(5)
    for K, T in ((cs.DIN_DIM, cs.DIN_T), *cs.DIN_GLOBAL_SHAPES):
        B, H1, H2 = cs.DIN_BATCH, 80, 40
        q, keys, mask, weights = cs.din_inputs(gen, B, T, K, H1, H2)
        maskf = mask.float()
        with torch.inference_mode():
            out, saved = kernels._din_launch(q, keys, maskf, *weights, "sigmoid", True, False,
                                             True)
        cot = torch.randn(out.shape, generator=gen, device="cuda")
        args = [t.clone().requires_grad_(True) for t in (q, keys, *weights)]

        def old_route():
            res = din_attention_ref(args[0], args[1], maskf, *args[2:])
            return torch.autograd.grad(res, args, cot)

        def kernel():
            return din_attention_backward(q, keys, maskf, *weights, saved, cot)

        def plain():
            return din_attention_backward_ref(q, keys, maskf, *weights, saved, cot)

        rec = {}
        for name, fn in (("kernel", kernel), ("plain", plain), ("old_route", old_route),
                         ("kernel", kernel)):
            rec.setdefault(name, []).append(cs.call_ms(fn, iters=50, warmup=5))
        for name, fn in (("kernel", kernel), ("plain", plain), ("old_route", old_route)):
            rec[name + "_peak_mb"] = peak_mb(fn)
        with torch.inference_mode():
            fwd = cs.call_ms(lambda: din_attention_fused(q, keys, maskf, *weights), iters=50,
                             warmup=5)
        bound, by, f32_ms = cs.din_backward_bound(B, T, K, H1, H2)
        print(f"backward timing B={B} T={T} K={K} H1={H1} H2={H2}: kernel "
              f"{rec['kernel']} ms, plain {rec['plain']} ms, old route (forward again + "
              f"autograd) {rec['old_route']} ms; forward kernel {fwd} ms; bound {bound} ms "
              f"({by}; f32 outside the tensor cores {f32_ms} ms); peak MB beyond the inputs: "
              f"kernel {rec['kernel_peak_mb']}, plain {rec['plain_peak_mb']}, old route "
              f"{rec['old_route_peak_mb']}", flush=True)


def build_variants(names):
    from recommender_system_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_DIR / "lab_backward"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    jobs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        jobs[name] = (lib, subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                                              str(cu)], stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        handle = ctypes.CDLL(str(lib))
        for fn in ("din_attention_backward", "din_attention_backward_scratch"):
            argtypes, restype = kernels.SOURCES["din_attention"][fn]
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
        libs[name] = handle
    return libs


def time_variants(names) -> None:
    from recommender_system_tpu_torch.ops import kernels

    libs = build_variants(names)
    gen = torch.Generator(device="cuda").manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    for K, T in ((cs.DIN_DIM, cs.DIN_T), (128, 50)):
        B, H1, H2 = cs.DIN_BATCH, 80, 40
        q, keys, mask, weights = cs.din_inputs(gen, B, T, K, H1, H2)
        maskf = mask.float()
        with torch.inference_mode():
            out, saved = kernels._din_launch(q, keys, maskf, *weights, "sigmoid", True, False,
                                             True)
        cot = torch.randn(out.shape, generator=gen, device="cuda")
        grads = [torch.empty_like(t) for t in (q, keys, *weights)]

        def launch(lib):
            floats = lib.din_attention_backward_scratch(B, T, K, H1, H2)
            scratch = torch.empty(floats, device="cuda")
            err = lib.din_attention_backward(
                *(t.data_ptr() for t in (q, keys, maskf, *weights, saved, cot, *grads, scratch)),
                B, T, K, H1, H2, 0, 1, 0, stream)
            if err != 0:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        for name in ["base", *[n for n in names if n != "base"], "base"]:
            if name.startswith("smem") and K != cs.DIN_DIM:
                continue  # its regions are in shared memory only at DIN's shape
            ms = cs.call_ms(lambda: launch(libs[name]), iters=30, warmup=3)
            print(f"variant {name} B={B} T={T} K={K}: {ms:.5f} ms a call", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--skip-check", action="store_true")
    parser.add_argument("--skip-time", action="store_true")
    parser.add_argument("--variants", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_lab_din_backward: no CUDA device", file=sys.stderr)
        return 2
    from recommender_system_tpu_torch.ops import kernels

    logs = kernels.build()
    entry = ""
    for line in logs.get("din_attention", "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "din_backward" in entry and ("registers" in line or "spill" in line):
            print(f"{entry}: {line.strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not args.skip_check:
        check()
    if not args.skip_time:
        time_shapes()
    if args.variants:
        time_variants(args.variants.split(","))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
