"""The DIN attention's global kernel against its plain version and against
another tree's global kernel, at the shapes that the tiled kernel refuses.

Run from the repository root, on a machine with one H100:

    python3 chip_lab_din_global.py [--parent DIR] [--also name=DIR,...]
        [--variants name,...] [--skip-check]

It builds ``recommender_system_tpu_torch/csrc/din_attention.cu`` with the
port's nvcc flags (its register and spill lines are printed), checks
``din_attention_fused`` against ``din_attention_ref`` on the card at the
three timed shapes and at shapes where the kernel stages its chunks in
turn, then times the global entry point with CUDA events over back-to-back
calls and by the profiler's device time at B=8,192, 80-40, sigmoid,
softmax, pooled: (K=128, T=50), (K=64, T=200) and (K=32, T=1,000), and
reads the card's clocks under 400 calls. With ``--parent DIR`` it also
builds DIR's source (a ``git archive`` of another commit) into
``build/lab/`` and times the two in turns, parent, change, change, parent;
``--also`` adds other trees' sources after them. ``--variants`` names
text-edited copies of the source from VARIANTS, timed beside it;
``--skip-check`` leaves out the check. The plain version's time, its
backward's and the bounds (``chip_smoke.din_bound``) are printed beside
each shape.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs

SHAPES = ((128, 50), (64, 200), (32, 1000))  # (K, T) at B=8,192, 80-40
SRC = Path("recommender_system_tpu_torch") / "csrc" / "din_attention.cu"

# name -> [(old, new)] text replacements of the source, each matching once
VARIANTS = {
    # one TF32 product a k-step instead of three
    "one_pass": [("  wgmma_tf32_first<N>(t, as, big);\n  wgmma_tf32<N>(t, ab, small, 1);\n"
                  "  wgmma_tf32<N>(t, ab, big, 1);", "  wgmma_tf32_first<N>(t, ab, big);")],
    # no pooling pass over the keys
    "no_pool": [("    if (pool) {\n", "    if (false) {\n")],
    # no per-row term's sums (the row-term kernel's loop)
    "no_row_term": [("  for (int k0 = 0; k0 < K; k0 += kTermK) {",
                     "  for (int k0 = 0; k0 < 0; k0 += kTermK) {")],
    # no mask and softmax
    "no_softmax": [("    const float* mk = mask + row0 * T;\n",
                    "    const float* mk = mask + row0 * T;\n    if (false) {\n"),
                   ("    __syncthreads();  // the weights are final", "    }\n    __syncthreads();")],
    # no layer-2 products
    "no_layer2": [("            wg_step<N2>(z, h[4 * kt], h[4 * kt + 2], h[4 * kt + 1], h[4 * kt + 3],\n"
                   "                        w2c + kt * 2 * N2 * 8);",
                   "            z[kt % (N2 / 2)] += h[4 * kt];")],
    # 8 and 16 warps a block where NH <= 10
    "warps8": [("{ return nh <= 10 ? 12 : 8; }", "{ return 8; }")],
    "warps16": [("{ return nh <= 10 ? 12 : 8; }", "{ return nh <= 10 ? 16 : 8; }")],
}


def build_lab(trees: dict) -> dict:
    """Compile each named source (name -> path of a din_attention.cu) into
    build/lab/, all at once; returns name -> (library, has a scores
    argument)."""
    from recommender_system_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_DIR / "lab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in trees.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        jobs[name] = (lib, text, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, text, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines()
                if "global_kernel" in line or "registers" in line or "spill" in line]
        print(f"built {name}: " + " | ".join(regs[-12:]), flush=True)
        for line in log.splitlines():
            if "wgmma" in line or "arning" in line:
                print(f"  nvcc {name}: {line.strip()}", flush=True)
        handle = ctypes.CDLL(str(lib))
        scores = "float* scores" in text
        handle.din_attention_global_forward.argtypes = (
            [ctypes.c_void_p] * (11 if scores else 10) + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        handle.din_attention_global_forward.restype = ctypes.c_int
        libs[name] = (handle, scores)
    return libs


def check(card) -> None:
    """``din_attention_fused`` (the global kernel) against the plain version
    at the three shapes, both outputs, both activations, and at shapes whose
    chunks do not all fit (K=600; 300-260), with RTOL and ATOL."""
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.kernels import din_attention_fused, din_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(cs.DIN_BATCH, T, K, 80, 40) for K, T in SHAPES] + [
        (64, 50, 600, 80, 40), (100, 13, 8, 300, 260), (33, 1, 128, 80, 40),
        (70, 23, 150, 12, 70), (50, 40, 6, 260, 20)]
    for B, T, K, H1, H2 in cases:
        q, keys, mask, weights = cs.din_inputs(gen, B, T, K, H1, H2)
        fast = kernels.din_kernel_takes(q, keys, mask.float(), *weights, "sigmoid")
        worst = 0.0
        for activation in ("sigmoid", "relu"):
            for wn in (True, False):
                for rs in (False, True):
                    with torch.inference_mode():
                        got = din_attention_fused(q, keys, mask, *weights, activation, wn, rs)
                        want = din_attention_ref(q, keys, mask, *weights, activation, wn, rs)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    worst = max(worst, err)
                    ok = torch.allclose(got, want, rtol=cs.RTOL, atol=cs.ATOL)
                    if not ok:
                        print(f"MISMATCH B={B} T={T} K={K} {H1}-{H2} {activation} wn={wn} "
                              f"rs={rs}: max_abs_err {err:.3e}", flush=True)
        print(f"check B={B} T={T} K={K} {H1}-{H2} ({'tiled' if fast else 'global'}): "
              f"max_abs_err {worst:.3e} over 8 flag sets; on {card}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default=None)
    parser.add_argument("--variants", default="")
    parser.add_argument("--also", default="")
    parser.add_argument("--skip-check", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_lab_din_global: no CUDA device", file=sys.stderr)
        return 2
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.kernels import din_attention_ref

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in logs.get("din_attention", "").splitlines():
        if "registers" in line or "spill" in line or "global_kernel" in line:
            print(f"  nvcc din_attention: {line.strip()}", flush=True)
    if not args.skip_check:
        check(card)

    source = SRC.read_text()
    trees = {"change": source}
    if args.parent:
        trees["parent"] = (Path(args.parent) / SRC).read_text()
    for item in filter(None, args.also.split(",")):
        name, directory = item.split("=")
        trees[name] = (Path(directory) / SRC).read_text()
    for name in filter(None, args.variants.split(",")):
        text = source
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        trees[name] = text
    t0 = time.perf_counter()
    libs = build_lab(trees)
    print(f"built {sorted(trees)} in {time.perf_counter() - t0:.1f} s", flush=True)
    order = (["parent", "change", "change", "parent"] if args.parent else ["change"])
    order += [n for n in trees if n not in ("parent", "change")]

    gen = torch.Generator(device="cuda").manual_seed(11)
    stream = torch.cuda.current_stream().cuda_stream
    for K, T in SHAPES:
        B = cs.DIN_BATCH
        q, keys, mask, weights = cs.din_inputs(gen, B, T, K, 80, 40)
        mask = mask.float()
        out = torch.empty(B, K, device="cuda")
        scratch = torch.empty(B * (T + 80), device="cuda")

        def launch(name):
            lib, scores = libs[name]
            ptrs = [t.data_ptr() for t in (q, keys, mask, *weights, out)]
            if scores:
                ptrs.append(scratch.data_ptr())
            err = lib.din_attention_global_forward(*ptrs, B, T, K, 80, 40, 0, 1, 0, stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed with CUDA error {err}")

        with torch.inference_mode():
            ref = din_attention_ref(q, keys, mask, *weights)
        times = {}
        for name in order:
            launch(name)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ms = cs.call_ms(lambda: launch(name), iters=100, warmup=5)
            device = cs.device_ms(lambda: launch(name), iters=20)
            times.setdefault(name, []).append(ms)
            print(f"K={K} T={T}: {name} {ms:.5f} ms a call, device {sum(device.values()):.5f} "
                  f"ms ({', '.join(sorted(n[:40] for n in device))}), max_abs_err {err:.3e}",
                  flush=True)
        with torch.inference_mode():
            plain = cs.call_ms(lambda: din_attention_ref(q, keys, mask, *weights), iters=20,
                               warmup=3)
        leaves = [t.clone().requires_grad_(True) for t in (q, keys, *weights)]
        with torch.enable_grad():
            o = din_attention_ref(leaves[0], leaves[1], mask, *leaves[2:])
            cot = torch.randn_like(o)

            def backward():
                torch.autograd.grad(o, leaves, cot, retain_graph=True)

            back = cs.call_ms(backward, iters=10, warmup=2)
        clocks = cs.clocks_during(lambda: launch("change"), 400)
        bound, bound_by, f32 = cs.din_bound(B, T, K, 80, 40)
        print(f"K={K} T={T} B={B} 80-40: " + ", ".join(
            f"{n} {min(v):.5f} ms" for n, v in times.items())
              + f"; plain {plain:.5f} ms; plain backward (the VJP) {back:.5f} ms; bound "
              f"{bound:.5f} ms ({bound_by}, 3 TF32 passes), f32 {f32:.5f} ms; SM and memory "
              f"clocks under 400 calls of the change {clocks}; on {card}",
              flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
