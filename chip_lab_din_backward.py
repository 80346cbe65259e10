"""Check and time the DIN attention's two backward kernels on the card.

    python3 chip_lab_din_backward.py [--skip-check] [--skip-time] [--variants a,b]

Builds ``csrc/din_attention.cu`` and prints the backward kernels' registers
and spills (``din_backward_tile_kernel``, the tile kernel; the global
kernel's). The check holds ``din_attention_backward`` to
``din_attention_backward_ref`` on the card at phase 2's shapes of
``chip_smoke.py`` (``chip_smoke.din_backward_close``), on the kernel the
router picks and, where that is the tile kernel, on the global kernel too
(the launcher's ``global_kernel``); two calls to each other bitwise, and the
forward's saved weights to its returned weights bitwise. The timing, at
B=8,192 and a 80-40 scorer, at DIN's shape (K=32, T=50) and the global
forward kernel's three (``DIN_GLOBAL_SHAPES``), times by CUDA events in
turns: the tile kernel (where it takes the shape), the global kernel, the
plain version, and the route the backward kernels replaced (autograd through
``din_attention_ref``, the forward run again), each with its peak memory
beyond the inputs (``torch.cuda.max_memory_allocated``), and the bound
(``chip_smoke.din_backward_bound``). ``--variants`` builds text-edited
copies of the source (``VARIANTS``) and times each one's tile kernel entry
point in turns with the unedited source (``base``) at DIN's shape; their
results are not checked.
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
TILE_STEP = """  wg_fence();
  wgmma_tf32<N>(acc, as, smem_desc(b), 1);
  wgmma_tf32<N>(acc, ab, smem_desc(b + N * 8), 1);
  wgmma_tf32<N>(acc, ab, smem_desc(b), 1);
  wg_commit();
  wg_wait_all();
}
"""
VARIANTS = {
    "base": [],
    # every position through the products, masked ones too (a pair of rows
    # of T=50 then takes two tiles of 50 positions), as before the skip;
    # its dlogits of masked positions are not zeroed, so results are wrong
    "no_skip": [("      const unsigned lo = __ballot_sync(kFull, in0 && mr[lane] > 0.5f);",
                 "      const unsigned lo = __ballot_sync(kFull, in0);"),
                ("      const unsigned hi = __ballot_sync(kFull, in1 && mr[lane + 32] > 0.5f);",
                 "      const unsigned hi = __ballot_sync(kFull, in1);")],
    # no weight-gradient products (dW2 and dWX; their operands still staged)
    "no_wgrad": [
        ("        tile_sum_issue<kTH2, kTSumSteps>(ta, a0, du_s + (k0 - 4 * half) * kTStep2, kTStep2);\n"
         "        tile_sum_issue<kTH2, kTSumSteps>(tb, a1, du_s + (k0 - 4 * half) * kTStep2, kTStep2,\n"
         "                                         w != 0);",
         "        (void)a0; (void)a1; ta[0] = tb[0] = 0.f;"),
        ("        tile_sum_steps<kTH1, kTSumSteps>(dwx, xa, region + (k0 - 4 * half) * kTStep1, kTStep1);",
         "        (void)xa;")],
    # unsafe, for its cost alone: no proxy fence before the weight
    # gradients' halves
    "no_fence": [("      fence_async_smem();\n      wg_bar(wg);\n#pragma unroll\n      for (int k0 = 4 * half; k0 < 4 * half + 4; k0 += kTSumSteps) {\n        float a0",
                  "      wg_bar(wg);\n#pragma unroll\n      for (int k0 = 4 * half; k0 < 4 * half + 4; k0 += kTSumSteps) {\n        float a0"),
                 ("      fence_async_smem();\n      wg_bar(wg);\n#pragma unroll\n      for (int k0 = 4 * half; k0 < 4 * half + 4; k0 += kTSumSteps) {\n        float xa",
                  "      wg_bar(wg);\n#pragma unroll\n      for (int k0 = 4 * half; k0 < 4 * half + 4; k0 += kTSumSteps) {\n        float xa")],
    # a weight gradient's fresh accumulator a k-step, or two
    "sum1": [("constexpr int kTSumSteps = 4;", "constexpr int kTSumSteps = 1;")],
    "sum2": [("constexpr int kTSumSteps = 4;", "constexpr int kTSumSteps = 2;")],
    # parts left out, to see what each costs: the rows' sums of dh and of
    # the dq terms; dq and dA; the keys' copies; the dkeys stores
    "no_rows": [("    for (int r = 0; r < nr; ++r) {\n#pragma unroll\n      for (int j = 0; j < kTH1 / 8; ++j) {",
                 "    for (int r = 0; r < 0; ++r) {\n#pragma unroll\n      for (int j = 0; j < kTH1 / 8; ++j) {")],
    "no_dqda": [("      for (int i = 0; i < kTH1 / 4; ++i) {\n        const int h = hq * (kTH1 / 4) + i;",
                 "      for (int i = 0; i < 0; ++i) {\n        const int h = hq * (kTH1 / 4) + i;")],
    "no_keys": [("        for (int i = wt; i < np * per; i += 128) {", "        for (int i = wt; i < 0; i += 128) {")],
    "no_dkeys": [("            *reinterpret_cast<float2*>(o) = make_float2(dk[0], dk[1]);",
                  "            (void)o;")],
    # the per-position products' k-steps as the weight gradients' (a fresh
    # accumulator each, then rounded f32 adds)
    "fresh": [(TILE_STEP, """  float t[N / 2];
  wg_fence();
  wgmma_tf32_first<N>(t, as, smem_desc(b));
  wgmma_tf32<N>(t, ab, smem_desc(b + N * 8), 1);
  wgmma_tf32<N>(t, ab, smem_desc(b), 1);
  wg_commit();
  wg_wait_all();
  fence_regs(t);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = __fadd_rn(acc[i], t[i]);
}
""")],
    # one TF32 product a k-step (big by big) in every product: what the
    # other two cost
    "one_mma": [("  wgmma_tf32<N>(acc, as, smem_desc(b), 1);\n"
                 "  wgmma_tf32<N>(acc, ab, smem_desc(b + N * 8), 1);\n", ""),
                ("      wgmma_tf32<N>(t, as[s], smem_desc(bs), 1);\n    }\n"
                 "    wgmma_tf32<N>(t, ab[s], smem_desc(bs + N * 8), 1);\n",
                 "      wgmma_tf32<N>(t, as[s], smem_desc(bs), 1);\n    }\n")],
    # the per-position products' k-steps not waited for until the product's
    # last (ptxas keeps an in-flight product's registers)
    "pp_nowait": [("  wgmma_tf32<N>(acc, ab, smem_desc(b), 1);\n  wg_commit();\n  wg_wait_all();\n}",
                   "  wgmma_tf32<N>(acc, ab, smem_desc(b), 1);\n  wg_commit();\n}"),
                  ("__device__ __forceinline__ void tile_end(float (&acc)[M]) {\n",
                   "__device__ __forceinline__ void tile_end(float (&acc)[M]) {\n  wg_wait_all();\n")],
    # no dA (its 20 running sums a thread)
    "no_da": [("            da[i] = fmaf(q_s[r * kTK + ca], v, da[i]);\n", "")],
    # no reduction of the partials after the tile kernel
    "no_reduce": [
        ("  din_backward_reduce<<<static_cast<int>(red_blocks < 65536 ? red_blocks : 65536), kPrepThreads,",
         "  if (false) din_backward_reduce<<<static_cast<int>(red_blocks < 65536 ? red_blocks : 65536), kPrepThreads,")],
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
            tile = kernels.din_backward_kernel_takes(q, keys, maskf, *weights, saved, cot,
                                                     flags[0], flags[2])
            for global_kernel in ((False, True) if tile else (True,)):
                what = "global" if global_kernel else "tile"
                try:
                    note, _ = cs.din_backward_close(q, keys, maskf, weights, saved, cot, flags,
                                                    global_kernel)
                except (AssertionError, RuntimeError) as err:
                    failed.append(f"{what} B={B} T={T} K={K} H1={H1} H2={H2} {flags}")
                    note = f"FAILED: {err}"
                print(f"backward check, {what} kernel, B={B} T={T} K={K} H1={H1} H2={H2} "
                      f"{flags}: {note}", flush=True)
    if failed:
        raise RuntimeError(f"a backward kernel failed its check at {failed}")


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
    from recommender_system_tpu_torch.ops.kernels import din_attention_fused, din_attention_ref

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
        tensors = (q, keys, maskf, *weights, saved, cot, "sigmoid", True, False)
        tile = kernels.din_backward_kernel_takes(*tensors[:11], "sigmoid", False)

        def old_route():
            res = din_attention_ref(args[0], args[1], maskf, *args[2:])
            return torch.autograd.grad(res, args, cot)

        fns = {"tile": lambda: kernels._din_backward_launch(*tensors),
               "global": lambda: kernels._din_backward_launch(*tensors, global_kernel=True),
               "plain": lambda: din_attention_backward_ref(*tensors),
               "old_route": old_route}
        if not tile:
            del fns["tile"]
        order = [*fns, *reversed(fns)]
        rec = {}
        for name in order:
            rec.setdefault(name, []).append(cs.call_ms(fns[name], iters=50, warmup=5))
        for name, fn in fns.items():
            rec[name + "_peak_mb"] = peak_mb(fn)
        with torch.inference_mode():
            fwd = cs.call_ms(lambda: din_attention_fused(q, keys, maskf, *weights), iters=50,
                             warmup=5)
        by_kernel = {what: {name[:48]: round(ms, 5) for name, ms in
                            cs.device_ms(fns[what], iters=20).items()}
                     for what in ("tile", "global") if what in fns}
        bound, by, f32_ms = cs.din_backward_bound(B, T, K, H1, H2)
        valid = int((maskf > 0.5).sum().item())
        valid_bound = cs.din_backward_bound(B, T, K, H1, H2, positions=valid)[0]
        times = ", ".join(f"{name} {rec[name]} ms" for name in fns)
        peaks = ", ".join(f"{name} {rec[name + '_peak_mb']}" for name in fns)
        print(f"backward timing B={B} T={T} K={K} H1={H1} H2={H2}, in turns {order}: "
              f"{times} (old_route: the forward again + autograd); forward kernel {fwd} ms; "
              f"bound {bound} ms ({by}; f32 outside the tensor cores {f32_ms} ms; over the "
              f"{valid} valid positions of {B * T}: {valid_bound} ms); peak MB "
              f"beyond the inputs: {peaks}; device ms by kernel {by_kernel}", flush=True)


def tile_kernel_notes(log: str) -> list:
    """The tile kernel's lines of an ``nvcc -Xptxas -v`` log: its registers,
    spills and any warning that names it (wgmma serialization among them)."""
    notes, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "din_backward_tile_kernel" in line and "warning" in line.lower():
            notes.append(line.strip())
        elif "din_backward_tile_kernel" in entry and ("registers" in line or "spill" in line):
            notes.append(line.strip())
    return notes


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
        for line in tile_kernel_notes(log):
            print(f"variant {name}: {line}", flush=True)
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
    B, T, K, H1, H2 = cs.DIN_BATCH, cs.DIN_T, cs.DIN_DIM, 80, 40
    q, keys, mask, weights = cs.din_inputs(gen, B, T, K, H1, H2)
    maskf = mask.float()
    with torch.inference_mode():
        out, saved = kernels._din_launch(q, keys, maskf, *weights, "sigmoid", True, False, True)
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
    entry, ptxas = "", []
    for line in logs.get("din_attention", "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "din_backward" in entry and ("registers" in line or "spill" in line):
            ptxas.append(f"{entry}: {line.strip()}")
        elif "din_backward" in line and "warning" in line.lower():
            ptxas.append(line.strip())
    print("\n".join(ptxas), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not args.skip_check:
        check()
    if not args.skip_time:
        time_shapes()
    if args.variants:
        time_variants(args.variants.split(","))
    print("\n".join(ptxas))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
