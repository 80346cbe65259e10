"""Variants of the FM logit and cross stack kernels
(``recommender_system_tpu_torch/csrc/fm.cu`` and ``csrc/cross.cu``), each
with one constant or one part changed, timed in turns on one card.

Run from the repository root, on a machine with one H100:

    python3 chip_lab_fm_cross.py [--variants cross:base,cross:rows2,fm:base,...]

Each variant is its kernel's source with the text replacements listed in
VARIANTS (each must match once), compiled with the port's nvcc flags into
``recommender_system_tpu_torch/build/lab/`` (all compiles started together)
and called through ctypes: the FM at the ``FMLayer`` path's x [16,384,
221], k=8, the cross stack at B=4,096 and B=8,192 (D=221, L=6), on random
inputs from a seed (``chip_smoke.fm_inputs``; the cross inputs as
``chip_turns.py`` makes them); the global kernels (``cross_global``,
``fm_global``) through their own entry points at DCN's x0 1,053 wide (L=6,
B=4,096 and 8,192) and at x [16,384, 4,000] and [16,384, 3,419], k=8. Each
prints its largest difference from ``fm_ref`` / ``cross_network`` (a
variant that takes work out gives a wrong result) and its device time from
the profiler (the global kernels: by CUDA events around a graph of 100
launches), in the order base, the variants, base, and ptxas' registers and
spills of the instantiation those shapes run.
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

VARIANTS = {
    "cross": {
        "base": [],
        # 1 or 4 rows a warp instead of 2 (tiles of 16 or 64 rows)
        "rows1": [("constexpr int kTileRowsPerWarp = 2;", "constexpr int kTileRowsPerWarp = 1;")],
        "rows4": [("constexpr int kTileRowsPerWarp = 2;", "constexpr int kTileRowsPerWarp = 4;")],
        # 8 or 32 warps a block instead of 16 (tiles of 16 or 64 rows)
        "warps8": [("constexpr int kTileWarps = 16;", "constexpr int kTileWarps = 8;")],
        "warps32": [("constexpr int kTileWarps = 16;", "constexpr int kTileWarps = 32;")],
        # 32 warps of 1 row (tiles of 32 rows)
        "warps32_rows1": [("constexpr int kTileWarps = 16;", "constexpr int kTileWarps = 32;"),
                          ("constexpr int kTileRowsPerWarp = 2;",
                           "constexpr int kTileRowsPerWarp = 1;")],
        # the results written back into the tile, and the block's tile stored
        # 16 bytes at a time after a barrier
        "block_stores": [
            ("          if (r0 + r < rows && j < dim) dst[(r0 + r) * dim + j] = x[r][k];",
             "          if (r0 + r < rows && j < dim) tile[(r0 + r) * dim + j] = x[r][k];"),
            ("""        }
      }
    }
  }
}
""", """        }
      }
    }
    __syncthreads();
    float* dst = out + t * kTileRows * dim;
    const int n = rows * dim;
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(tile)[i];
    for (int i = n / 4 * 4 + threadIdx.x; i < n; i += blockDim.x) dst[i] = tile[i];
  }
}
""")],
        # the register kernel (x0 and the output through registers)
        "registers": [("  if (dim <= 32 * kTileMaxPerLane && aligned16(x0)",
                       "  if (false && dim <= 32 * kTileMaxPerLane && aligned16(x0)")],
        # no layers: x0 copied through (a wrong result; the memory phases alone)
        "no_layers": [("  for (int l = 0; l < layers; ++l) {", "  for (int l = 0; l < 0; ++l) {")],
    },
    "fm": {
        "base": [],
        # the next rows' loads after the shuffles, not before them
        "late_loads": [("    load_rows<kPerLane>(xr, x, group + stride, batch, dim, lane);\n", ""),
                       ("    if ((lane & 7) == 0 && r < batch) out[r] = fmaf(0.5f, sq, t);\n",
                        "    if ((lane & 7) == 0 && r < batch) out[r] = fmaf(0.5f, sq, t);\n"
                        "    load_rows<kPerLane>(xr, x, group + stride, batch, dim, lane);\n")],
        # 16 warps a block (128 registers a thread)
        "warps16": [("constexpr int kRowWarps = 12;", "constexpr int kRowWarps = 16;")],
        # 8 warps a block
        "warps8": [("constexpr int kRowWarps = 12;", "constexpr int kRowWarps = 8;")],
    },
}
VARIANTS["cross_global"] = {
    "base": [],
    # no layers: x0 copied through (a wrong result; the memory phases alone)
    "no_layers": [("      apply_layers_fused<kPerLane, kRows>(a, x, w_s, b_s, dim, n, lane);\n", "")],
    # each layer's update and the next layer's dot in two passes
    "unfused": [("      apply_layers_fused<kPerLane, kRows>(a, x, w_s, b_s, dim, n, lane);",
                 "      apply_layers<kPerLane, kRows>(a, x, w_s, b_s, dim, n, lane);")],
    # the stores kept only where the result is never equal to a constant
    # (a wrong result: the layers alone, without writing out)
    "no_stores": [("\n        if (r0 + r < rows && j < dim) dst[(r0 + r) * dim + j] = x[r][k];",
                   "\n        if (x[r][k] == 12345.f) dst[(r0 + r) * dim + j] = x[r][k];")],
    # 8 warps of 2 rows, their layers interleaved (207 registers)
    "warps8_rows2": [("launch_global<36, 1, 8>", "launch_global<36, 2, 8>")],
    # 4 or 16 warps of 1 row (tiles of 4 or 16 rows; 4: two blocks an SM)
    "warps4": [("launch_global<36, 1, 8>", "launch_global<36, 1, 4>")],
    "warps16": [("launch_global<36, 1, 8>", "launch_global<36, 1, 16>")],
    # the grid one block an SM, not the blocks resident at once
    "grid_sms": [("  const int64_t most = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);",
                  "  const int64_t most = sms;")],
}
VARIANTS["fm_global"] = {
    "base": [],
    # 3 or 6 stages in the ring (6: one block an SM)
    "stages3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "stages6": [("constexpr int kStages = 4;", "constexpr int kStages = 6;")],
}
FUNCTIONS = {"cross": "cross_forward", "fm": "fm_forward",
             "cross_global": "cross_global_forward", "fm_global": "fm_global_forward"}
SOURCE_FILES = {"cross": "cross", "fm": "fm", "cross_global": "cross", "fm_global": "fm"}
# the instantiation the timed shapes run, as ptxas names it
MAIN_KERNEL = {"cross": "ILi7E", "fm": "ILi7E", "cross_global": "cross_global_kernelILi36E",
               "fm_global": "fm_global_kernelILb1E"}


def build(names):
    from recommender_system_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_DIR / "lab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for full in names:
        source, name = full.split(":")
        text = (CSRC / f"{SOURCE_FILES[source]}.cu").read_text()
        for old, new in VARIANTS[source][name]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {full}: {old!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        cu = out_dir / f"{source}_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{source}_{name}.so"
        jobs[full] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for full, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {full}:\n{log}")
        lines = log.splitlines()
        # the function ptxas compiles is named in the line before its figures
        source = full.split(":")[0]
        at = [i for i, line in enumerate(lines)
              if "Compiling entry" in line and MAIN_KERNEL[source] in line]
        main = [line.strip() for line in lines[at[0]:at[0] + 4]
                if "registers" in line or "spill" in line] if at else []
        print(f"built {full}: {' | '.join(main)}", flush=True)
        handle = ctypes.CDLL(str(lib))
        fn = getattr(handle, FUNCTIONS[source])
        fn.argtypes, fn.restype = kernels.SOURCES[SOURCE_FILES[source]][FUNCTIONS[source]]
        libs[full] = fn
    return libs


def cases():
    """(source, label, argument tensors, output, plain result) at the main
    path's shapes."""
    from recommender_system_tpu_torch.ops.interactions import cross_network
    from recommender_system_tpu_torch.ops.kernels import fm_ref

    gen = torch.Generator(device="cuda").manual_seed(7)
    x, w1, v = cs.fm_inputs(gen, cs.FM_B, cs.FM_D, cs.FM_K)
    out = [("fm", f"B={cs.FM_B}", (x, w1, v), torch.empty(cs.FM_B, 1, device="cuda"),
            fm_ref(x, w1, v), (cs.FM_B, cs.FM_D, cs.FM_K))]
    gen = torch.Generator(device="cuda").manual_seed(8)
    D, L = 221, 6
    w = torch.randn(L, D, generator=gen, device="cuda") * (0.2 / D ** 0.5)
    b = torch.randn(L, D, generator=gen, device="cuda") * 0.1
    for B in (cs.SERVE_BATCH, cs.CTR_BATCH):
        x0 = torch.randn(B, D, generator=gen, device="cuda")
        out.append(("cross", f"B={B}", (x0, w, b), torch.empty_like(x0),
                    cross_network(x0, w, b), (B, D, L)))
    from recommender_system_tpu_torch.ops.kernels import fm_global_coef_floats

    D = cs.FIELDS * cs.WIDE_DIM + 13
    w = torch.randn(L, D, generator=gen, device="cuda") * (0.2 / D ** 0.5)
    b = torch.randn(L, D, generator=gen, device="cuda") * 0.1
    for B in (cs.SERVE_BATCH, cs.CTR_BATCH):
        x0 = torch.randn(B, D, generator=gen, device="cuda")
        out.append(("cross_global", f"B={B} D={D}", (x0, w, b), torch.empty_like(x0),
                    cross_network(x0, w, b), (B, D, L)))
    for D in (cs.WIDE_FM_D, 3419):
        x, w1, v = cs.fm_inputs(gen, cs.FM_B, D, 8)
        outs = torch.empty(cs.FM_B, 1, device="cuda")
        scratch = torch.empty(fm_global_coef_floats(D, 8), device="cuda")
        out.append(("fm_global", f"B={cs.FM_B} D={D}", (x, w1, v), outs,
                    fm_ref(x.double(), w1.double(), v.double()).float(), (cs.FM_B, D, 8),
                    scratch))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=",".join(
        f"{source}:{name}" for source, names in VARIANTS.items() for name in names))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_lab_fm_cross: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    names = args.variants.split(",")
    libs = build(names)
    with torch.inference_mode():
        for source, label, inputs, out, ref, sizes, *scratch in cases():
            mine = [n for n in names if n.startswith(f"{source}:") and n != f"{source}:base"]
            if not mine:
                continue
            order = [f"{source}:base", *mine, f"{source}:base"]

            def launch(fn):
                stream = torch.cuda.current_stream().cuda_stream
                err = fn(*(t.data_ptr() for t in (*inputs, out, *scratch)), *sizes, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed with CUDA error {err}")

            for name in order:
                out.zero_()
                launch(libs[name])
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                if source.endswith("_global"):
                    ms = cs.events_ms(lambda: launch(libs[name]))
                else:
                    ms = sum(cs.device_ms(lambda: launch(libs[name])).values())
                print(f"{source} {label} variant {name.split(':')[1]}: device {ms:.5f} ms, "
                      f"max_abs_err {err:.3e}", flush=True)
            print(f"{source} {label}: SM and memory clocks under load "
                  f"{cs.clocks_during(lambda: launch(libs[order[0]]), calls=200)}", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
