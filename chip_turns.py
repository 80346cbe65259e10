"""Time the port's kernels and steps from two trees in turns on one card.

Run from the repository root, on a machine with one H100, with a second
tree of the port (for example a ``git archive`` of the parent commit,
unpacked into a directory that ``.gitignore`` lists):

    python3 chip_turns.py parent=chip_parent change=. --order parent,change,change,parent

Each turn is a process of its own, started in its tree's directory, so that
it imports and builds that tree's ``recommender_system_tpu_torch`` (into the
tree's own build directory). The timing code is this file's and the
``chip_smoke.py`` beside it, the same for every turn. A turn measures, with
TF32 off:

- ``fused_adam_apply`` (lazy Adam) on ``bench.py``'s stream (N=425,984 into
  2,600,000 rows of dim 9): device time from the profiler and time per call;
  on the same stream with every other id on one hot row; on DIN's step
  stream (two sites of table_d32, the padding row's cotangents zero);
- the other three sparse row kernels (``fused_adagrad_apply``,
  ``fused_sgd_apply``, ``scatter_add_sorted``) on the same three streams;
- ``din_attention_fused`` at DIN's bench shape (B=8,192, T=50, K=32, 80-40)
  on a DIN batch's embeddings: device time, time per call, and its largest
  difference from ``din_attention_ref``; and its forward where a gradient
  is needed (the weights requiring grad, grad mode on: a tree whose
  backward kernel reads the forward's weights saves them), device time;
  and ``din_attention_backward`` on the forward's saved weights and a
  cotangent, device time and time per call;
- DIN's and NFM's fused K=8 training step (``chip_smoke.time_training``:
  CUDA events over 5 calls, device busy time and idle share);
- ``fm_fused`` at the ``FMLayer`` path's x [16,384, 221], k=8, and
  ``cross_fused`` at the DCN Scorer's B=4,096 and DCN training's B=8,192
  (D=221, L=6), on random inputs from a seed: device time, time per call,
  the largest difference from ``fm_ref`` / ``cross_network``, and beside
  each the card's practical floor for the same bytes, a plain device copy
  (``torch.sum(x, 1)`` for the FM, ``x0.clone()`` for the cross stack),
  timed the same way on the same warm inputs.

- the fused K=8 steps of DeepCrossing, PNN, AFM and FFM at
  ``model_step.py``'s Criteo width (``family``);
- DeepFM's fused K=8 call at ``bench.py``'s width, and WideDeep's and
  DIN's at ``model_step.py``'s, issued step by step (a tree's
  ``make_multi_step(graphed=False)``, or its ``multi_step`` where it has
  no graphs) and, where the tree has them, as one CUDA graph replay
  (``multi_step``): ms a step by CUDA events over 5 calls, three times
  (``loops``).

- the global kernels: ``fm_fused`` at x [16,384, 4,000] and [16,384,
  3,419], k=8, and ``cross_fused`` at x0 1,053 wide, L=6, B=4,096 and
  8,192, each by CUDA events around a graph of 100 calls and by the
  profiler, beside the same read of its bytes (``fm_global``,
  ``cross_global``).

- DIN's graphed K=8 call with each fused sparse rule (``FusedAdagrad``,
  ``FusedSGD``, ``FusedAdam``), and WideDeep's (``FusedSGD``) and NFM's
  (``FusedAdam``) on Criteo batches with 5 % of the fields missing
  (``rules``).

- DIEN's graphed K=8 call at ``model_step.py``'s width with ``Adagrad`` and
  ``FusedAdagrad`` (``dien``).

- ``din_attention_backward`` at B=8,192, 80-40, at DIN's shape and the
  global forward kernel's three: device time, time per call and peak
  memory beyond the inputs (``backward``); the graphed K=8 calls of DIN at
  embedding dim 128 and of ``DIEN(gru_hidden=128)`` (``wide_steps``).

``--what fm,cross`` keeps only the parts named (default: all fourteen,
``adam,rows,attention,steps,fm,cross,family,loops,fm_global,cross_global,rules,dien,backward,wide_steps``).

Each turn prints ``TURN <label> {json}``; the run ends with one line per
metric listing every turn's value, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def harness():
    """This file's chip_smoke.py, whatever tree the turn imports."""
    spec = importlib.util.spec_from_file_location("turns_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_adam(cs, torch) -> dict:
    from recommender_system_tpu_torch.ops.fused_adagrad import fused_adam_apply
    from recommender_system_tpu_torch.ops.stream_sort import blocked_sort, sort_ids

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, dim = cs.FIELDS * cs.VOCAB, cs.FACTOR_DIM + 1
    rows2d = torch.as_tensor(cs.bench_rows(0), device="cuda")
    lids = rows2d.reshape(-1)
    slid, order = blocked_sort(rows2d, [(f * cs.VOCAB, cs.VOCAB) for f in range(cs.FIELDS)])
    ct = torch.randn(lids.numel(), dim, generator=gen, device="cuda") * 1e-3
    table = torch.randn(rows, dim, generator=gen, device="cuda") * 1e-4
    m, v = torch.zeros_like(table), torch.zeros_like(table)
    hot = lids.clone()
    hot[::2] = 12_345
    hot_sorted = sort_ids(hot)
    din_lids = torch.as_tensor(cs.din_stream(cs.din_batch(0)[0]), device="cuda")
    din_ct = torch.randn(din_lids.numel(), cs.DIN_DIM, generator=gen, device="cuda") * 1e-3
    din_ct[din_lids == cs.DIN_USERS] = 0.0
    din_table = torch.randn(cs.DIN_USERS + cs.DIN_ITEMS, cs.DIN_DIM, generator=gen,
                            device="cuda")
    din_m, din_v = torch.zeros_like(din_table), torch.zeros_like(din_table)
    din_sorted = sort_ids(din_lids)

    def bench():
        fused_adam_apply(table, m, v, lids, ct, lr=cs.ADAM_LR, step=0, presorted=(slid, order))

    return {
        "adam_ms": sum(cs.device_ms(bench).values()),
        "adam_call_ms": cs.call_ms(bench),
        "adam_hot_row_ms": sum(cs.device_ms(
            lambda: fused_adam_apply(table, m, v, hot, ct, lr=cs.ADAM_LR, step=0,
                                     presorted=hot_sorted), iters=5).values()),
        "adam_din_stream_ms": sum(cs.device_ms(
            lambda: fused_adam_apply(din_table, din_m, din_v, din_lids, din_ct,
                                     lr=cs.ADAM_LR, step=0, presorted=din_sorted),
            iters=5).values()),
    }


def time_rows(cs, torch) -> dict:
    from recommender_system_tpu_torch.ops.embedding_grad import scatter_add_sorted
    from recommender_system_tpu_torch.ops.fused_adagrad import (fused_adagrad_apply,
                                                                fused_sgd_apply)
    from recommender_system_tpu_torch.ops.stream_sort import blocked_sort, sort_ids

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, dim = cs.FIELDS * cs.VOCAB, cs.FACTOR_DIM + 1
    rows2d = torch.as_tensor(cs.bench_rows(0), device="cuda")
    lids = rows2d.reshape(-1)
    bench = blocked_sort(rows2d, [(f * cs.VOCAB, cs.VOCAB) for f in range(cs.FIELDS)])
    ct = torch.randn(lids.numel(), dim, generator=gen, device="cuda") * 1e-3
    table = torch.randn(rows, dim, generator=gen, device="cuda") * 1e-4
    acc = torch.full((rows, dim), 0.1, device="cuda")
    hot = lids.clone()
    hot[::2] = 12_345
    hot_sorted = sort_ids(hot)
    din_lids = torch.as_tensor(cs.din_stream(cs.din_batch(0)[0]), device="cuda")
    din_ct = torch.randn(din_lids.numel(), cs.DIN_DIM, generator=gen, device="cuda") * 1e-3
    din_ct[din_lids == cs.DIN_USERS] = 0.0
    din_table = torch.randn(cs.DIN_USERS + cs.DIN_ITEMS, cs.DIN_DIM, generator=gen,
                            device="cuda")
    din_acc = torch.full_like(din_table, 0.1)
    din_sorted = sort_ids(din_lids)
    runs = {
        "adagrad": lambda t, a, ids, c, s: fused_adagrad_apply(t, a, ids, c, lr=cs.LR,
                                                               eps=cs.EPS, presorted=s),
        "sgd": lambda t, a, ids, c, s: fused_sgd_apply(t, ids, c, lr=cs.SGD_LR, presorted=s),
        "scatter": lambda t, a, ids, c, s: scatter_add_sorted(*s, c, t.shape[0]),
    }
    out = {}
    for name, run in runs.items():
        out[f"{name}_ms"] = sum(cs.device_ms(lambda: run(table, acc, lids, ct, bench)).values())
        out[f"{name}_hot_row_ms"] = sum(cs.device_ms(
            lambda: run(table, acc, hot, ct, hot_sorted), iters=5).values())
        out[f"{name}_din_stream_ms"] = sum(cs.device_ms(
            lambda: run(din_table, din_acc, din_lids, din_ct, din_sorted), iters=5).values())
    return out


def time_attention(cs, torch) -> dict:
    from recommender_system_tpu_torch.ops.kernels import din_attention_fused, din_attention_ref

    model = cs.din_model().eval()
    a = model.attention
    weights = (a.w1, a.b1, a.w2, a.b2, a.w3, a.b3)
    batches, _ = cs.din_staged(range(1))
    with torch.inference_mode():
        emb = model.embeddings({k: v[0] for k, v in batches.items()})
        q = emb.sparse["item_id"].contiguous()
        keys = emb.varlen_raw["hist_item_id"]
        mask = emb.varlen_mask["hist_item_id"].float()

        def fused():
            return din_attention_fused(q, keys, mask, *weights)

        err = (fused() - din_attention_ref(q, keys, mask, *weights)).abs().max().item()
        out = {"din_attention_ms": sum(cs.device_ms(fused).values()),
               "din_attention_call_ms": cs.call_ms(fused), "din_attention_max_abs_err": err}
    # where a gradient is needed (the weights are parameters): the forward
    # only, its autograd graph dropped after each call; the inputs copied
    # out of inference mode, which autograd may not save
    q, keys, mask = (t.clone() for t in (q, keys, mask))
    out["din_attention_train_ms"] = sum(cs.device_ms(
        lambda: din_attention_fused(q, keys, mask, *weights)).values())
    # the backward on the forward's saved weights and a cotangent
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.kernels import din_attention_backward

    with torch.inference_mode():
        _, saved = kernels._din_launch(q, keys, mask, *weights, "sigmoid", True, False, True)
        cot = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(6),
                          device="cuda")
        args = (q, keys, mask, *weights, saved, cot)
        out["din_backward_ms"] = sum(cs.device_ms(lambda: din_attention_backward(*args),
                                                  iters=20).values())
        out["din_backward_call_ms"] = cs.call_ms(lambda: din_attention_backward(*args),
                                                 iters=50)
    return out


def time_steps(cs, torch, card) -> dict:
    from recommender_system_tpu_torch import FusedAdagrad, FusedAdam, Trainer
    from recommender_system_tpu_torch.training import Adagrad, Adam

    out = {}
    din = Trainer(cs.din_model(), Adagrad(cs.LR), fused_embedding=FusedAdagrad(cs.LR))
    rec = cs.time_training(din, *cs.din_staged(range(cs.K)), card, "DIN fused training")
    out["din_step_ms"], out["din_step_busy_ms"] = rec["step_ms"], rec["busy_ms"]
    cols, batches, labels = cs.staged_batches(range(cs.K), batch=cs.CTR_BATCH)
    nfm = Trainer(cs.ctr_model("nfm", cols), Adam(cs.ADAM_LR),
                  fused_embedding=FusedAdam(cs.ADAM_LR))
    rec = cs.time_training(nfm, batches, labels, card, "NFM fused training")
    out["nfm_step_ms"], out["nfm_step_busy_ms"] = rec["step_ms"], rec["busy_ms"]
    return out


def time_family(cs, torch, card) -> dict:
    """The fused K=8 steps of DeepCrossing, PNN (inner), AFM and FFM at
    model_step.py's width with ``Adagrad`` and ``FusedAdagrad``, as
    ``chip_smoke.py``'s phase 4 times them."""
    from recommender_system_tpu_torch import FusedAdagrad, Trainer
    from recommender_system_tpu_torch.training import Adagrad

    cols, batches, labels = cs.staged_batches(range(cs.K), batch=cs.CTR_BATCH)
    out = {}
    for name in ("deep_crossing", "pnn", "afm", "ffm"):
        trainer = Trainer(cs.ctr_model(name, cols), Adagrad(cs.LR),
                          fused_embedding=FusedAdagrad(cs.LR))
        rec = cs.time_training(trainer, batches, labels, card, f"{name} fused training")
        out[f"{name}_step_ms"], out[f"{name}_step_busy_ms"] = rec["step_ms"], rec["busy_ms"]
        del trainer
    return out


def per_step(torch, run, batches, labels, reps=3, calls=5):
    """ms a step of the K-step call ``run`` over ``calls`` calls by CUDA
    events, ``reps`` times, after two calls (a signature's first runs step
    by step, its second captures): sorted."""
    for _ in range(2):
        run(batches, labels)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            run(batches, labels)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls / labels.shape[0])
    return sorted(times)


def time_loops(cs, torch) -> dict:
    """DeepFM fused, WideDeep (``FusedSGD``) and DIN fused: a K=8 call
    looped and, in a tree with graphs, graphed; each form's ms a step over
    5 calls by CUDA events, three times (``per_step``): the median, least
    and most of the three."""
    from recommender_system_tpu_torch import FusedAdagrad, FusedSGD, Trainer
    from recommender_system_tpu_torch.training import SGD, Adagrad

    cols, batches, labels = cs.staged_batches(range(cs.K))
    ctr_cols, ctr_batches, ctr_labels = cs.staged_batches(range(cs.K), batch=cs.CTR_BATCH)
    cells = {
        "deepfm": (lambda: Trainer(cs.deepfm(cols, torch.bfloat16), Adagrad(cs.LR),
                                   fused_embedding=FusedAdagrad(cs.LR)), batches, labels),
        "wide_deep": (lambda: Trainer(cs.ctr_model("wide_deep", ctr_cols), SGD(cs.SGD_LR),
                                      fused_embedding=FusedSGD(cs.SGD_LR)),
                      ctr_batches, ctr_labels),
        "din": (lambda: Trainer(cs.din_model(), Adagrad(cs.LR),
                                fused_embedding=FusedAdagrad(cs.LR)), *cs.din_staged(range(cs.K))),
    }
    out = {}
    for name, (build, cell_batches, cell_labels) in cells.items():
        trainer = build()
        graphs = hasattr(trainer, "make_multi_step")
        looped = trainer.make_multi_step(graphed=False) if graphs else trainer.multi_step
        forms = {"looped": looped, **({"graphed": trainer.multi_step} if graphs else {})}
        for form, run in forms.items():
            least, median, most = per_step(torch, run, cell_batches, cell_labels)
            out.update({f"{name}_{form}_ms": median, f"{name}_{form}_min_ms": least,
                        f"{name}_{form}_max_ms": most})
        del trainer
    return out


def kernel_and_floor(cs, name, kernel, plain, floor) -> dict:
    """Device time (profiler) and time per call of ``kernel`` and of the
    ``floor`` copy, and the kernel's largest difference from ``plain``."""
    err = (kernel() - plain()).abs().max().item()
    return {f"{name}_ms": sum(cs.device_ms(kernel).values()),
            f"{name}_call_ms": cs.call_ms(kernel), f"{name}_max_abs_err": err,
            f"{name}_floor_ms": sum(cs.device_ms(floor).values()),
            f"{name}_floor_call_ms": cs.call_ms(floor)}


def time_fm(cs, torch) -> dict:
    from recommender_system_tpu_torch.ops.kernels import fm_fused, fm_ref

    gen = torch.Generator(device="cuda").manual_seed(7)
    x, w1, v = cs.fm_inputs(gen, cs.FM_B, cs.FM_D, cs.FM_K)
    with torch.inference_mode():
        return kernel_and_floor(cs, "fm", lambda: fm_fused(x, w1, v), lambda: fm_ref(x, w1, v),
                                lambda: torch.sum(x, 1))


def time_cross(cs, torch) -> dict:
    from recommender_system_tpu_torch.ops.interactions import cross_network
    from recommender_system_tpu_torch.ops.kernels import cross_fused

    gen = torch.Generator(device="cuda").manual_seed(8)
    D, L = 221, 6
    w = torch.randn(L, D, generator=gen, device="cuda") * (0.2 / D ** 0.5)
    b = torch.randn(L, D, generator=gen, device="cuda") * 0.1
    out = {}
    for B in (cs.SERVE_BATCH, cs.CTR_BATCH):
        x0 = torch.randn(B, D, generator=gen, device="cuda")
        with torch.inference_mode():
            out.update(kernel_and_floor(cs, f"cross_{B}", lambda: cross_fused(x0, w, b),
                                        lambda: cross_network(x0, w, b), lambda: x0.clone()))
    return out


def global_and_floor(cs, name, kernel, plain, floor) -> dict:
    """A global kernel's time by CUDA events over a graph of 100 calls and
    by the profiler (50 calls), the same for the ``floor`` read of its
    bytes, and the kernel's largest difference from ``plain``."""
    err = (kernel() - plain()).abs().max().item()
    return {f"{name}_events_ms": cs.events_ms(kernel),
            f"{name}_ms": sum(cs.device_ms(kernel).values()), f"{name}_max_abs_err": err,
            f"{name}_floor_events_ms": cs.events_ms(floor),
            f"{name}_floor_ms": sum(cs.device_ms(floor).values())}


def time_fm_global(cs, torch) -> dict:
    """``fm_fused`` on the global kernel at x [16,384, D], k=8: D=4,000, and
    D=3,419 (rows off 16-byte alignment); beside ``torch.sum(x, 1)``."""
    from recommender_system_tpu_torch.ops.kernels import fm_fused, fm_kernel_takes, fm_ref

    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for D in (cs.WIDE_FM_D, 3419):
        x, w1, v = cs.fm_inputs(gen, cs.FM_B, D, 8)
        assert not fm_kernel_takes(x, w1, v)
        with torch.inference_mode():
            out.update(global_and_floor(cs, f"fm_global_{D}", lambda: fm_fused(x, w1, v),
                                        lambda: fm_ref(x, w1, v), lambda: torch.sum(x, 1)))
        del x, w1, v
    return out


def time_cross_global(cs, torch) -> dict:
    """``cross_fused`` on the global kernel at DCN's x0 1,053 wide (dim 40),
    L=6, B=4,096 and 8,192; beside ``x0.clone()``."""
    from recommender_system_tpu_torch.ops.interactions import cross_network
    from recommender_system_tpu_torch.ops.kernels import cross_fused, cross_kernel_takes

    gen = torch.Generator(device="cuda").manual_seed(13)
    D, L = cs.FIELDS * cs.WIDE_DIM + 13, 6
    w = torch.randn(L, D, generator=gen, device="cuda") * (0.2 / D ** 0.5)
    b = torch.randn(L, D, generator=gen, device="cuda") * 0.1
    out = {}
    for B in (cs.SERVE_BATCH, cs.CTR_BATCH):
        x0 = torch.randn(B, D, generator=gen, device="cuda")
        assert not cross_kernel_takes(x0, w, b)
        with torch.inference_mode():
            out.update(global_and_floor(cs, f"cross_global_{B}", lambda: cross_fused(x0, w, b),
                                        lambda: cross_network(x0, w, b), lambda: x0.clone()))
    return out


def time_rules(cs, torch) -> dict:
    """The graphed K=8 call (``multi_step``) of DIN at model_step.py's width
    with each fused sparse rule (Adagrad, SGD, Adam, with the dense
    optimizer of the same kind), and of WideDeep (``FusedSGD``) and NFM
    (``FusedAdam``) at its Criteo width on ``chip_smoke.missing_fields``
    batches: ms a step (``per_step``), the median, least and most of
    three."""
    from recommender_system_tpu_torch import FusedAdagrad, FusedAdam, FusedSGD, Trainer
    from recommender_system_tpu_torch.training import SGD, Adagrad, Adam

    din = cs.din_staged(range(cs.K))
    cols, batches, labels = cs.staged_batches(range(cs.K), batch=cs.CTR_BATCH)
    missing = (cs.missing_fields(batches), labels)
    cells = {
        "din_adagrad": (lambda: Trainer(cs.din_model(), Adagrad(cs.LR),
                                        fused_embedding=FusedAdagrad(cs.LR)), din),
        "din_sgd": (lambda: Trainer(cs.din_model(), SGD(cs.SGD_LR),
                                    fused_embedding=FusedSGD(cs.SGD_LR)), din),
        "din_adam": (lambda: Trainer(cs.din_model(), Adam(cs.ADAM_LR),
                                     fused_embedding=FusedAdam(cs.ADAM_LR)), din),
        "wide_deep_missing": (lambda: Trainer(cs.ctr_model("wide_deep", cols), SGD(cs.SGD_LR),
                                              fused_embedding=FusedSGD(cs.SGD_LR)), missing),
        "nfm_missing": (lambda: Trainer(cs.ctr_model("nfm", cols), Adam(cs.ADAM_LR),
                                        fused_embedding=FusedAdam(cs.ADAM_LR)), missing),
    }
    out = {}
    for name, (build, data) in cells.items():
        trainer = build()
        least, median, most = per_step(torch, trainer.multi_step, *data)
        out.update({f"{name}_graphed_ms": median, f"{name}_graphed_min_ms": least,
                    f"{name}_graphed_max_ms": most})
        del trainer
    return out


def time_dien(cs, torch) -> dict:
    """DIEN's graphed K=8 call (``multi_step``) at model_step.py's width with
    ``Adagrad`` and ``FusedAdagrad``, as phase 3j trains it: ms a step
    (``per_step``), the median, least and most of three."""
    from recommender_system_tpu_torch import FusedAdagrad, Trainer
    from recommender_system_tpu_torch.training import Adagrad

    trainer = Trainer(cs.dien_model(), Adagrad(cs.LR), fused_embedding=FusedAdagrad(cs.LR))
    least, median, most = per_step(torch, trainer.multi_step,
                                   *cs.din_staged(range(cs.K), negatives=True))
    return {"dien_graphed_ms": median, "dien_graphed_min_ms": least,
            "dien_graphed_max_ms": most}


def peak_mb(torch, fn) -> float:
    """Device memory one call of ``fn`` allocates at its peak beyond what
    was allocated before it, in MB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def time_backward(cs, torch) -> dict:
    """``din_attention_backward`` (the public wrapper: whichever kernel the
    tree routes to) at B=8,192, 80-40, at DIN's shape and the global forward
    kernel's three (``DIN_GLOBAL_SHAPES``), and at DIN's shape with a
    128-64 scorer (``DIN_WIDE_SCORER``, the global kernel's own path), on
    the forward's saved weights and a cotangent from a seed: device time
    (profiler), time per call (CUDA events) and peak memory beyond the
    inputs (``backward``)."""
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.kernels import din_attention_backward

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    shapes = [(cs.DIN_DIM, cs.DIN_T, 80, 40), *((K_, T, 80, 40) for K_, T in cs.DIN_GLOBAL_SHAPES),
              (cs.DIN_DIM, cs.DIN_T, *cs.DIN_WIDE_SCORER)]
    for K_, T, H1, H2 in shapes:
        q, keys, mask, weights = cs.din_inputs(gen, cs.DIN_BATCH, T, K_, H1, H2)
        mask = mask.float()
        with torch.inference_mode():
            _, saved = kernels._din_launch(q, keys, mask, *weights, "sigmoid", True, False, True)
            cot = torch.randn(cs.DIN_BATCH, K_, generator=gen, device="cuda")
            args = (q, keys, mask, *weights, saved, cot)
            name = f"backward_k{K_}_t{T}" + ("" if (H1, H2) == (80, 40) else f"_h{H1}_{H2}")
            out[f"{name}_ms"] = sum(cs.device_ms(lambda: din_attention_backward(*args),
                                                 iters=5).values())
            out[f"{name}_call_ms"] = cs.call_ms(lambda: din_attention_backward(*args),
                                                iters=10, warmup=2)
            out[f"{name}_peak_mb"] = peak_mb(torch, lambda: din_attention_backward(*args))
        del q, keys, mask, weights, saved, cot, args
    return out


def time_wide_steps(cs, torch) -> dict:
    """The graphed K=8 calls whose attention backward takes K=128: DIN at
    embedding dim 128 (phase 3r's) and ``DIEN(gru_hidden=128)``, at
    model_step.py's width with ``Adagrad`` and ``FusedAdagrad``: ms a step
    (``per_step``), the median, least and most of three (``wide_steps``)."""
    from recommender_system_tpu_torch import FusedAdagrad, Trainer
    from recommender_system_tpu_torch.training import Adagrad

    out = {}
    cells = {"din_d128": (lambda: cs.din_model(cs.DIN_WIDE_DIM),
                          lambda: cs.din_staged(range(cs.K))),
             "dien_h128": (lambda: cs.dien_model(gru_hidden=128),
                           lambda: cs.din_staged(range(cs.K), negatives=True))}
    for name, (model, data) in cells.items():
        trainer = Trainer(model(), Adagrad(cs.LR), fused_embedding=FusedAdagrad(cs.LR))
        least, median, most = per_step(torch, trainer.multi_step, *data())
        out.update({f"{name}_graphed_ms": median, f"{name}_graphed_min_ms": least,
                    f"{name}_graphed_max_ms": most})
        del trainer
    return out


PARTS = ("adam", "rows", "attention", "steps", "fm", "cross", "family", "loops",
         "fm_global", "cross_global", "rules", "dien", "backward", "wide_steps")


def turn(label: str, tree: Path, what) -> None:
    sys.path.insert(0, str(tree))
    import torch

    import recommender_system_tpu_torch as package

    if not Path(package.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {package.__file__}, not the package of {tree}")
    cs = harness()
    from recommender_system_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    card = cs.card_line()
    rec = {"tree": str(tree)}
    if "adam" in what:
        rec.update(time_adam(cs, torch))
    if "rows" in what:
        rec.update(time_rows(cs, torch))
    if "attention" in what:
        rec.update(time_attention(cs, torch))
    if "steps" in what:
        rec.update(time_steps(cs, torch, card))
    if "fm" in what:
        rec.update(time_fm(cs, torch))
    if "cross" in what:
        rec.update(time_cross(cs, torch))
    if "family" in what:
        rec.update(time_family(cs, torch, card))
    if "loops" in what:
        rec.update(time_loops(cs, torch))
    if "fm_global" in what:
        rec.update(time_fm_global(cs, torch))
    if "cross_global" in what:
        rec.update(time_cross_global(cs, torch))
    if "rules" in what:
        rec.update(time_rules(cs, torch))
    if "dien" in what:
        rec.update(time_dien(cs, torch))
    if "backward" in what:
        rec.update(time_backward(cs, torch))
    if "wide_steps" in what:
        rec.update(time_wide_steps(cs, torch))
    print(f"TURN {label} {json.dumps(rec)}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="*", help="label=directory, one per tree")
    parser.add_argument("--order", help="labels in the order of the turns")
    parser.add_argument("--what", default=",".join(PARTS),
                        help=f"parts to time, from {','.join(PARTS)}")
    parser.add_argument("--turn", nargs=2, metavar=("LABEL", "TREE"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    what = args.what.split(",")
    if not set(what) <= set(PARTS):
        parser.error(f"--what takes parts from {PARTS}, got {what}")
    if args.turn:
        turn(args.turn[0], Path(args.turn[1]).resolve(), what)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_turns: no CUDA device", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.trees)
    order = args.order.split(",") if args.order else list(trees)
    results = []
    for label in order:
        tree = Path(trees[label]).resolve()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", label,
                               str(tree), "--what", args.what], cwd=tree,
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise RuntimeError(f"turn {label} in {tree} failed with {proc.returncode}")
        line, = [x for x in proc.stdout.splitlines() if x.startswith(f"TURN {label} ")]
        results.append((label, json.loads(line.split(" ", 2)[2])))
    keys = [k for _, rec in results for k in rec if k != "tree"]
    for key in dict.fromkeys(keys):  # in order, once each
        form = ".3e" if key.endswith("_err") else ".5f"
        print(f"{key}: " + ", ".join(f"{label} {rec[key]:{form}}" for label, rec in results
                                     if key in rec))
    print(harness().card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
