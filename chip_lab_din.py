"""Where the DIN attention kernel's time goes: variants of
``recommender_system_tpu_torch/csrc/din_attention.cu``, each with one part
changed or taken out, timed in turns on one card.

Run from the repository root, on a machine with one H100:

    python3 chip_lab_din.py [--variants base,one_pass,...]

Each variant is the source with the text replacements listed in VARIANTS
(each must match), compiled with the port's nvcc flags into
``recommender_system_tpu_torch/build/lab/`` (all compiles started together)
and called through ctypes on DIN's bench shape (B=8,192, T=50, K=32, 80-40,
sigmoid, softmax, pooled) with a DIN batch's embeddings. A variant that takes
work out gives wrong outputs: its difference from ``din_attention_ref`` is
printed for the base only. Times are CUDA events over 200 back-to-back
calls, in the order base, the variants, base.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

SRC = Path(__file__).resolve().parent / "recommender_system_tpu_torch" / "csrc" / "din_attention.cu"

VARIANTS = {
    "base": [],
    # one TF32 product a (k-tile, n-tile) instead of three
    "one_pass": [("  mma(t, a_small, b.x, b.z);\n  mma(t, a_big, b.y, b.w);\n", "")],
    # the three products straight into the running sum, no fresh accumulator
    "no_fresh": [("  float t[4] = {0.f, 0.f, 0.f, 0.f};\n  mma(t, a_small, b.x, b.z);\n"
                  "  mma(t, a_big, b.y, b.w);\n  mma(t, a_big, b.x, b.z);\n#pragma unroll\n"
                  "  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], t[i]);",
                  "  mma(d, a_small, b.x, b.z);\n  mma(d, a_big, b.y, b.w);\n"
                  "  mma(d, a_big, b.x, b.z);")],
    # no mask, softmax and pooling phase
    "no_tail": [("for (int r = warp; r < nr; r += kWarps) {", "for (int r = warp; r < 0; r += kWarps) {")],
    # no per-row term q (Wq + Wm)
    "no_row_term": [("        for (int k = 0; k < K; ++k) s = fmaf(q_s[r * K + k], wqm[k * H1 + j], s);\n", "")],
    # the sigmoid's reciprocal IEEE-rounded
    "exact_sigmoid": [("__fdividef(1.f, 1.f + __expf(-x))", "__frcp_rn(1.f + __expf(-x))")],
    # no second layer: the score from h1's first columns
    "no_layer2": [("          for (int j = 0; j < kTiles2; ++j) mma3(z[j], ab, as, bp[j * 32]);",
                   "          for (int j = 0; j < kTiles2; ++j) z[j][0] += h[kt][j & 3];")],
    # no first layer's products
    "no_layer1": [("        for (int j = 0; j < NT1; ++j) mma3(h[j], ab, as, bp[j * 32]);",
                   "        for (int j = 0; j < NT1; ++j) h[j][j & 3] += __uint_as_float(ab[j & 3]);")],
    # the group size that fills the warps' rounds best, without the fixed
    # work (5 rows at DIN's shape, not 9)
    "rows_fill": [("static_cast<double>(r) * T / (rounds + 0.5);",
                   "static_cast<double>(r) * T / (16.0 * warps * rounds);")],
    # layer 1's k-tiles two at a time
    "unroll2": [("      for (int kt = 0; kt < kt1; ++kt) {", "#pragma unroll 2\n      for (int kt = 0; kt < kt1; ++kt) {")],
}


def build(names):
    from recommender_system_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_DIR / "lab"
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
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "ILi10E" in line or "registers" in line]
        print(f"built {name}: {' | '.join(regs[-4:])}", flush=True)
        handle = ctypes.CDLL(str(lib))
        argtypes, restype = kernels.SOURCES["din_attention"]["din_attention_forward"]
        handle.din_attention_forward.argtypes = argtypes
        handle.din_attention_forward.restype = restype
        libs[name] = handle
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_lab_din: no CUDA device", file=sys.stderr)
        return 2
    from recommender_system_tpu_torch.ops.kernels import din_attention_ref

    names = args.variants.split(",")
    libs = build(names)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = cs.din_model().eval()
    a = model.attention
    weights = [t.detach().contiguous() for t in (a.w1, a.b1, a.w2, a.b2, a.w3, a.b3)]
    batches, _ = cs.din_staged(range(1))
    with torch.inference_mode():
        emb = model.embeddings({k: v[0] for k, v in batches.items()})
        q = emb.sparse["item_id"].contiguous()
        keys = emb.varlen_raw["hist_item_id"].contiguous()
        mask = emb.varlen_mask["hist_item_id"].float().contiguous()
        ref = din_attention_ref(q, keys, mask, *weights)
    B, T, K = keys.shape
    H1, H2 = weights[0].shape[1], weights[2].shape[1]
    out = torch.empty(B, K, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        # no weights output: the serving launch
        err = lib.din_attention_forward(*(t.data_ptr() for t in (q, keys, mask, *weights, out)),
                                        None, B, T, K, H1, H2, 0, 1, 0, stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")

    launch(libs["base"])
    torch.cuda.synchronize()
    print(f"base against din_attention_ref: max_abs_err {(out - ref).abs().max().item():.3e}")
    for name in ["base", *[n for n in names if n != "base"], "base"]:
        ms = cs.call_ms(lambda: launch(libs[name]))
        print(f"variant {name}: {ms:.5f} ms a call", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
