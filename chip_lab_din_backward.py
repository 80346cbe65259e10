"""Check and time the DIN attention's two backward kernels on the card.

    python3 chip_lab_din_backward.py [--skip-check] [--skip-time] [--variants a,b]
        [--wide-variants a,b] [--wide-clocks] [--wide-at-tile] [--only tile|wide|global]

Builds ``csrc/din_attention.cu`` and prints the backward kernels' registers
and spills (``din_backward_tile_kernel``, the tile kernel;
``din_backward_wide_kernel<KT>``, the wide kernel; the global kernel's).
The check holds ``din_attention_backward`` to ``din_attention_backward_ref``
on the card at phase 2's shapes of ``chip_smoke.py``
(``chip_smoke.din_backward_close``), on the kernel the router picks
(``din_backward_route``; ``--only tile|wide|global`` keeps the cases routed
to one) and, where that is the tile or the wide kernel, on the global kernel
too (the launcher's ``global_kernel``); two calls to each other bitwise, and
the forward's saved weights to its returned weights bitwise. The timing, at
B=8,192 and a 80-40 scorer, at DIN's shape (K=32, T=50) and the global
forward kernel's three (``DIN_GLOBAL_SHAPES``), times by CUDA events in
turns: the kernel the router picks (the tile kernel at DIN's shape, the wide
kernel at the other three), the global kernel, the plain version, and the
route the backward kernels replaced (autograd through ``din_attention_ref``,
the forward run again), each with its peak memory beyond the inputs
(``torch.cuda.max_memory_allocated``), and the bound over all positions and
over the valid ones (``chip_smoke.din_backward_bound``). The parent's
kernels in turns with these: ``chip_turns.py --what backward``. ``--variants`` builds text-edited
copies of the source (``VARIANTS``) and times each one's tile kernel entry
point in turns with the unedited source (``base``) at DIN's shape, and
``--wide-variants`` each one's wide kernel entry point at the three global
shapes; their results are not checked. ``--wide-clocks`` prints the wide
kernel's cycles by phase (the ``wide_clocks`` variant, which inserts the
clock reads), ``--wide-at-tile`` times the wide kernel against the tile
kernel at DIN's shape (the ``wide_at_tile`` variant).
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
    "no_dkeys": [("\n            *reinterpret_cast<float2*>(o) = make_float2(dk[0], dk[1]);",
                  "\n            (void)o;")],
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
    # the wide kernel's dlogit from din_backward_dlogits launched first (a
    # fourth launch, one more read of the keys, a [B * T] scratch) instead
    # of its own sweep over the unit and g . k a tile
    "wide_pre_dlogits": [
        ("const float* __restrict__ terms, float* __restrict__ dq,",
         "const float* __restrict__ terms, const float* __restrict__ dlg, float* __restrict__ dq,"),
        ("const float*, const float*, float*, float*, float*, BackPlan",
         "const float*, const float*, const float*, float*, float*, float*, BackPlan"),
        ("      const bool dots = softmax;  // c needs g . k only under the softmax",
         "      const bool dots = false;"),
        ("if (!pool) cp_async4(dl_s + lt, grad + pos);", "cp_async4(dl_s + lt, dlg + pos);"),
        ("      for (int i = lt; i < 4 * kWM; i += NT) {\n        const int p = i >> 2, qtr = i & 3;",
         "      if (lt >= np && lt < kWM) dl_s[lt] = 0.f;\n"
         "      for (int i = lt; i < 0; i += NT) {\n        const int p = i >> 2, qtr = i & 3;"),
        ("  return wide_pack(kWideK[slot]).total + L.blocks * L.acc + static_cast<long long>(batch) * H1;",
         "  return wide_pack(kWideK[slot]).total + L.blocks * L.acc + static_cast<long long>(batch) * H1 +\n"
         "         static_cast<long long>(batch) * T;"),
        ("  float* terms = partials + L.blocks * L.acc;\n",
         "  float* terms = partials + L.blocks * L.acc;\n"
         "  float* dl = terms + static_cast<long long>(batch) * H1;\n"),
        ("  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&\n"
         "                   reinterpret_cast<uintptr_t>(dkeys) % 16 == 0;\n",
         "  {\n"
         "    const long long grid = (32LL * batch + kPrepThreads - 1) / kPrepThreads;\n"
         "    din_backward_dlogits<<<static_cast<int>(grid < 65536 ? grid : 65536), kPrepThreads, 0, s>>>(\n"
         "        keys, mask, weights, grad, dl, batch, T, K, softmax != 0, scores == 0,\n"
         "        K % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&\n"
         "            reinterpret_cast<uintptr_t>(grad) % 16 == 0);\n"
         "    if ((err = cudaGetLastError()) != cudaSuccess) return err;\n"
         "  }\n"
         "  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&\n"
         "                   reinterpret_cast<uintptr_t>(dkeys) % 16 == 0;\n"),
        ("packed, terms, dq, dkeys", "packed, terms, dl, dq, dkeys")],
    # the wide kernel's weight ring, 3 or 6 k-steps a warpgroup
    "wide_slots3": [("constexpr int kWSlots = 4; ", "constexpr int kWSlots = 3; ")],
    "wide_slots6": [("constexpr int kWSlots = 4; ", "constexpr int kWSlots = 6; ")],
    # the wide kernel's parts left out, to see what each costs (results
    # wrong): the sweep's masked dkeys stores; its g . k for c; the
    # weight-gradient products; dX's products; the keys' copies
    "wide_no_masked": [("            if (in[u] && !valid[u]) {", "            if (false) {")],
    "wide_no_c": [("      const bool dots = softmax;  // c needs g . k only under the softmax",
                   "      const bool dots = false;")],
    "wide_no_wgrad": [
        ("            tile_sum_issue<kTH2, kTSumSteps>(t[mi], a[mi], du_s + (k0 - KS * half) * kTStep2,\n"
         "                                             kTStep2, mt == 1 && w != 0);",
         "            (void)mt; t[mi][0] = 0.f;"),
        ("        tile_sum_steps<kTH1, kTSumSteps>(dwx[mi], xa, b, kTStep1);",
         "        (void)xa; (void)b;")],
    "wide_no_dx": [("          tile_step<64>(x, dh[4 * kt], dh[4 * kt + 2], dh[4 * kt + 1], dh[4 * kt + 3], b);",
                    "          (void)b;")],
    "wide_no_keys": [("            cp_async16(keys_s + p * S::kSK + c, keys + ((b0 + row_of(p)) * T + idx_s[p]) * K + c);",
                      "            (void)c;")],
    # the wide kernel's pair end without dA's updates
    "wide_no_da": [("      for (int r = 0; r < nrows; ++r) v = fmaf(q_s[r * KT + c], rs_s[r * kTH1 + h], v);\n      dA[i] = v;",
                    "      (void)v;")],
    # the wide kernel's cycles a phase (time_clocks reads them): a team's
    # first thread sums each phase's cycles (tick(i), WIDE_PHASES) over its
    # units and tiles and writes the sums, as floats, over the first
    # positions of dkeys at the end (its results are not gradients)
    "wide_clocks": [
        ("constexpr int kWStepX = 2 * 2 * 32 * 8;  // a dX k-step: N = 64, big and small\n",
         "constexpr int kWStepX = 2 * 2 * 32 * 8;  // a dX k-step: N = 64, big and small\n"
         "constexpr int kWidePhases = 15;\n"),
        ("(kMisc + 20 * kRows + 31)", "(kMisc + 20 * kRows + 2 * kWidePhases + 31)"),
        ("  int* cur_s = reinterpret_cast<int*>(misc + 18 * R);\n",
         "  int* cur_s = reinterpret_cast<int*>(misc + 18 * R);\n"
         "  long long* clk_s = reinterpret_cast<long long*>(misc + 20 * R);\n"
         "  long long tprev = 0;\n"
         "  auto tick = [&](int phase) {\n"
         "    if (lt == 0) {\n"
         "      const long long now = clock64();\n"
         "      clk_s[phase] += now - tprev;\n"
         "      tprev = now;\n"
         "    }\n"
         "  };\n"),
        ("  const long long units = (static_cast<long long>(batch) + R - 1) / R;\n",
         "  const long long units = (static_cast<long long>(batch) + R - 1) / R;\n"
         "  if (lt == 0) tprev = clock64();\n"),
        *[(f"{sp}{a}", f"{sp}tick({i});\n{sp}{a}") for i, sp, a in (
            (0, "    ", "// the unit's valid positions, the rows' in turn"),
            (1, "      ", "// the tile's keys, weights and (for scores) cotangents, by cp.async"),
            (2, "      ", "// dlogit: dscore = g . k (four threads a position"),
            (5, "      ", "// layer 2 again (both warpgroups); du = dlogit w3 act'(h2)"))],
        *[(a, f"{a}{sp}{t}\n") for a, sp, t in (
            ("      tile_end(hacc);\n", "      ", "tick(4);"),
            ("        if (half + 1 < HV) bar();  // the half's parts are read before the next "
             "half's go in\n      }\n", "      ", "tick(7);"),
            ("      bar();  // h1 and du's parts are read: the region takes dh's parts\n", "      ",
             "tick(8);"),
            ("        for (int j = 0; j < kTH1 / 8; ++j) rows_dh(j);\n", "        ", "tick(9);"),
            ("        dx_chunk(0);\n", "        ", "tick(10);"),
            ("          if (half == 0) bar();  // the half's parts are read before the next "
             "half's go in\n        }\n", "        ", "tick(11);\n        tick(12);\n        tick(13);"),
            ("          if (ci < nx) dx_chunk(ci);\n        }\n", "        ", "tick(10);"))],
        ("        bar();\n#pragma unroll\n        for (int k0 = KS * half; k0 < KS * (half + 1); "
         "k0 += kTSumSteps) {",
         "        bar();\n        if (half == 0) tick(6);\n#pragma unroll\n"
         "        for (int k0 = KS * half; k0 < KS * (half + 1); k0 += kTSumSteps) {"),
        ("      bar();\n\n      const bool v_lo = p_lo < np, v_hi = p_hi < np;",
         "      bar();\n      tick(3);\n\n      const bool v_lo = p_lo < np, v_hi = p_hi < np;"),
        ("        bar();\n#pragma unroll\n        for (int ci = 0; ci < NXW; ++ci) {",
         "        bar();\n        tick(9);\n#pragma unroll\n        for (int ci = 0; ci < NXW; ++ci) {"),
        ("        }\n        bar();\n        add_sums();\n      }",
         "        }\n        tick(11);\n        bar();\n        tick(12);\n        add_sums();\n"
         "        tick(13);\n      }"),
        ("      sums[lt] += v;\n    }\n  }\n",
         "      sums[lt] += v;\n    }\n    tick(kWidePhases - 1);\n  }\n"
         "  if (lt == 0) {\n"
         "    for (int i = 0; i < kWidePhases; ++i) {\n"
         "      dkeys[(static_cast<long long>(blockIdx.x) * S::kTeams + team) * 16 + i] =\n"
         "          static_cast<float>(clk_s[i]);\n"
         "    }\n"
         "  }\n")],
    # the wide kernel also at the tile kernel's shapes (time_wide_at_tile)
    "wide_at_tile": [("  return K <= 128 && H1 <= kTH1 && H2 <= kTH2 && !tile_takes(T, K, H1, H2);",
                      "  return K <= 128 && H1 <= kTH1 && H2 <= kTH2;")],
    # no reduction of the partials after the tile kernel
    "no_reduce": [
        ("      H1, H2, relu != 0, softmax != 0, scores == 0, vec);\n"
         "  if ((err = cudaGetLastError()) != cudaSuccess) return err;\n"
         "  const long long outs = 4LL * K * H1 + H1 + static_cast<long long>(H1) * H2 + 2LL * H2 + 1;\n"
         "  const long long red_blocks = (32 * outs + kPrepThreads - 1) / kPrepThreads;\n"
         "  din_backward_reduce<<<",
         "      H1, H2, relu != 0, softmax != 0, scores == 0, vec);\n"
         "  if ((err = cudaGetLastError()) != cudaSuccess) return err;\n"
         "  const long long outs = 4LL * K * H1 + H1 + static_cast<long long>(H1) * H2 + 2LL * H2 + 1;\n"
         "  const long long red_blocks = (32 * outs + kPrepThreads - 1) / kPrepThreads;\n"
         "  if (false) din_backward_reduce<<<")],
}


def check(only: str = "") -> None:
    from recommender_system_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(4)
    failed = []
    for B, T, K, H1, H2, combos in cs.DIN_BACKWARD_CASES:
        q, keys, mask, weights = cs.din_inputs(gen, B, T, K, H1, H2,
                                               cs.DIN_BACKWARD_LENGTHS.get((B, T, K, H1, H2)))
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
            route = kernels.din_backward_route(q, keys, maskf, *weights, saved, cot, flags[0],
                                               flags[2])
            if only and route != only:
                continue
            for global_kernel in ((False, True) if route != "global" else (True,)):
                what = "global" if global_kernel else route
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
        route = kernels.din_backward_route(*tensors[:11], "sigmoid", False)

        def old_route():
            res = din_attention_ref(args[0], args[1], maskf, *args[2:])
            return torch.autograd.grad(res, args, cot)

        fns = {route: lambda: kernels._din_backward_launch(*tensors),
               "global": lambda: kernels._din_backward_launch(*tensors, global_kernel=True),
               "plain": lambda: din_attention_backward_ref(*tensors),
               "old_route": old_route}
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
                     for what in ("tile", "wide", "global") if what in fns}
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


_BUILT = {}  # variant name -> its library, built once a run


def build_variants(names):
    """The variants' libraries, each built once a run: those not yet built,
    by one ``nvcc`` each, all started together."""
    from recommender_system_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_DIR / "lab_backward"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    jobs = {}
    for name in dict.fromkeys(names):
        if name in _BUILT:
            continue
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
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        for line in tile_kernel_notes(log):
            print(f"variant {name}: {line}", flush=True)
        handle = ctypes.CDLL(str(lib))
        for fn in ("din_attention_backward", "din_attention_backward_scratch",
                   "din_attention_wide_backward", "din_attention_wide_backward_scratch"):
            argtypes, restype = kernels.SOURCES["din_attention"][fn]
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
        _BUILT[name] = handle
    return {name: _BUILT[name] for name in names}


def time_variants(names, wide: bool = False) -> None:
    """Each variant's tile kernel entry point at DIN's shape, in turns with
    ``base``; with ``wide``, its wide kernel entry point at the three global
    shapes instead."""
    from recommender_system_tpu_torch.ops import kernels

    libs = build_variants(["base", *names])
    gen = torch.Generator(device="cuda").manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    shapes = ([(cs.DIN_BATCH, T, K, 80, 40) for K, T in cs.DIN_GLOBAL_SHAPES] if wide
              else [(cs.DIN_BATCH, cs.DIN_T, cs.DIN_DIM, 80, 40)])
    entry = "din_attention_wide_backward" if wide else "din_attention_backward"
    for B, T, K, H1, H2 in shapes:
        q, keys, mask, weights = cs.din_inputs(gen, B, T, K, H1, H2)
        maskf = mask.float()
        with torch.inference_mode():
            out, saved = kernels._din_launch(q, keys, maskf, *weights, "sigmoid", True, False,
                                             True)
        cot = torch.randn(out.shape, generator=gen, device="cuda")
        grads = [torch.empty_like(t) for t in (q, keys, *weights)]

        def launch(lib):
            floats = getattr(lib, entry + "_scratch")(B, T, K, H1, H2)
            scratch = torch.empty(floats, device="cuda")
            err = getattr(lib, entry)(
                *(t.data_ptr() for t in (q, keys, maskf, *weights, saved, cot, *grads, scratch)),
                B, T, K, H1, H2, 0, 1, 0, stream)
            if err != 0:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        for name in ["base", *[n for n in names if n != "base"], "base"]:
            ms = cs.call_ms(lambda: launch(libs[name]), iters=10 if wide else 30, warmup=3)
            print(f"variant {name} ({entry}) B={B} T={T} K={K}: {ms:.5f} ms a call",
                  flush=True)
        del q, keys, mask, weights, saved, cot, grads


def time_wide_at_tile(turns: int = 3) -> None:
    """The wide kernel (``din_backward_wide_kernel<32>``, the
    ``wide_at_tile`` variant) against the tile kernel at DIN's shape (B=8,192,
    T=50, K=32, 80-40), the tile kernel then the wide kernel, ``turns``
    times, by CUDA events; the wide kernel's gradients against the plain
    version's (largest error over each gradient's scale)."""
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.din_vjp import din_attention_backward_ref

    libs = build_variants(["base", "wide_at_tile"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    B, T, K, H1, H2 = cs.DIN_BATCH, cs.DIN_T, cs.DIN_DIM, 80, 40
    q, keys, mask, weights = cs.din_inputs(gen, B, T, K, H1, H2)
    maskf = mask.float()
    with torch.inference_mode():
        out, saved = kernels._din_launch(q, keys, maskf, *weights, "sigmoid", True, False, True)
    cot = torch.randn(out.shape, generator=gen, device="cuda")
    grads = [torch.empty_like(t) for t in (q, keys, *weights)]
    runs = {"tile": (libs["base"], "din_attention_backward"),
            "wide": (libs["wide_at_tile"], "din_attention_wide_backward")}

    def launch(what):
        lib, entry = runs[what]
        scratch = torch.empty(getattr(lib, entry + "_scratch")(B, T, K, H1, H2), device="cuda")
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in (q, keys, maskf, *weights, saved, cot, *grads, scratch)),
            B, T, K, H1, H2, 0, 1, 0, stream)
        if err != 0:
            raise RuntimeError(f"{what} launch failed with CUDA error {err}")

    launch("wide")
    torch.cuda.synchronize()
    names = ("dq", "dkeys", "dw1", "db1", "dw2", "db2", "dw3", "db3")
    ref = din_attention_backward_ref(q, keys, maskf, *weights, saved, cot, "sigmoid", True,
                                     False)
    errs = {n: (g - r).abs().max().item()
            / cs.din_grad_scale(n, r, keys, maskf, saved, cot, ("sigmoid", True, False))
            for n, g, r in zip(names, grads, ref)}
    rec = {"tile": [], "wide": []}
    for _ in range(turns):
        for what in ("tile", "wide"):
            rec[what].append(cs.call_ms(lambda: launch(what), iters=30, warmup=3))
    print(f"wide kernel at the tile kernel's shape B={B} T={T} K={K} H1={H1} H2={H2}, "
          f"in turns: tile kernel {rec['tile']} ms, wide kernel {rec['wide']} ms a call; the "
          f"wide kernel's error over each gradient's scale against the plain version "
          f"{ {n: f'{e:.2e}' for n, e in errs.items()} }", flush=True)
    del q, keys, mask, weights, saved, cot, grads


# the wide kernel's phases in the wide_clocks variant, in its order (tick(i))
WIDE_PHASES = ["unit: rows, sweep", "collect", "stage keys", "dlogit", "layer 1",
               "swap, h1", "layer 2, du", "dW2", "dh", "dh parts", "dX", "dWX", "barrier",
               "row sums", "unit: dq, dA"]


def time_clocks() -> None:
    """The wide kernel's cycles by phase at the three global shapes: a
    team's first thread's sums over its pairs and tiles, summed over the
    teams (the ``wide_clocks`` variant)."""
    from recommender_system_tpu_torch.ops import kernels

    lib = build_variants(["wide_clocks"])["wide_clocks"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for K, T in cs.DIN_GLOBAL_SHAPES:
        B, H1, H2 = cs.DIN_BATCH, 80, 40
        q, keys, mask, weights = cs.din_inputs(gen, B, T, K, H1, H2)
        maskf = mask.float()
        with torch.inference_mode():
            out, saved = kernels._din_launch(q, keys, maskf, *weights, "sigmoid", True, False,
                                             True)
        cot = torch.randn(out.shape, generator=gen, device="cuda")
        grads = [torch.empty_like(t) for t in (q, keys, *weights)]
        scratch = torch.empty(lib.din_attention_wide_backward_scratch(B, T, K, H1, H2),
                              device="cuda")
        for _ in range(2):
            err = lib.din_attention_wide_backward(
                *(t.data_ptr() for t in (q, keys, maskf, *weights, saved, cot, *grads, scratch)),
                B, T, K, H1, H2, 0, 1, 0, stream)
            if err != 0:
                raise RuntimeError(f"launch failed with CUDA error {err}")
        torch.cuda.synchronize()
        per_block = 2 if K <= 32 else 1
        teams = min(sms, -(-((B + 1) // 2) // per_block)) * per_block
        clocks = grads[1].reshape(-1)[:16 * teams].reshape(teams, 16)[:, :len(WIDE_PHASES)]
        total = clocks.sum(0).double()
        share = ", ".join(f"{name} {100 * float(v / total.sum()):.1f}%"
                          for name, v in zip(WIDE_PHASES, total))
        print(f"wide kernel cycles by phase, K={K} T={T} ({teams} teams, "
              f"{float(total.sum() / teams):.0f} cycles a team): {share}", flush=True)
        del q, keys, mask, weights, saved, cot, grads, scratch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--skip-check", action="store_true")
    parser.add_argument("--skip-time", action="store_true")
    parser.add_argument("--variants", default="")
    parser.add_argument("--wide-variants", default="",
                        help="variants timed on the wide kernel at the three global shapes")
    parser.add_argument("--wide-clocks", action="store_true",
                        help="the wide kernel's cycles by phase (the wide_clocks variant)")
    parser.add_argument("--wide-at-tile", action="store_true",
                        help="the wide kernel against the tile kernel at DIN's shape")
    parser.add_argument("--only", default="", choices=["", "tile", "wide", "global"],
                        help="check only the cases the router sends to this kernel")
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
    variants = [*filter(None, args.variants.split(",")),
                *filter(None, args.wide_variants.split(","))]
    variants += ["wide_clocks"] * args.wide_clocks + ["base", "wide_at_tile"] * args.wide_at_tile
    if variants:
        build_variants(["base", *variants])
    if not args.skip_check:
        check(args.only)
    if not args.skip_time:
        time_shapes()
    if args.variants:
        time_variants(args.variants.split(","))
    if args.wide_variants:
        time_variants(args.wide_variants.split(","), wide=True)
    if args.wide_clocks:
        time_clocks()
    if args.wide_at_tile:
        time_wide_at_tile()
    print("\n".join(ptxas))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
