"""The readings a cell's limits are set from (not run by the benchmark's
runs): each number compared, for the program on many seeds (the lower
readings), for the control (the reference one step below the stated
precision, in the program's place) and for the half-batch fault planted in
the reference, each on a few seeds (the upper readings). Training needs no
measured window, so each seed is a set-up with its calls, then the
reference.

    python3 port_bench/calibrate.py --workload din.train.t50 \\
        --seeds 1-12 --control-seeds 101-103 --fault-seeds 201-203

prints one JSON line a reading and, last, the largest program reading and
the smallest control and fault readings of each number. On the CPU
(``--device cpu``) it runs the cell cut to the tests' size.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=seeds("1-12"))
    p.add_argument("--control-seeds", type=seeds, default=seeds("101-103"))
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import harness

    cell = harness.load_cell(args.workload)
    if args.device == "cpu":
        sys.path.insert(0, str(ROOT / "port_bench" / "tests"))
        from conftest import tiny

        cell = tiny(cell)
    elif not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    kinds = {"program": [], "control": [], "half_batch": []}

    def report(kind, seed, prog, t0):
        ref = harness.follow_reference(cell, seed, args.device)
        got = harness.numbers(prog, ref)
        kinds[kind].append(got)
        print(json.dumps({"kind": kind, "seed": seed, "seconds": time.time() - t0,
                          "numbers": got, "losses": [prog["losses"], ref["losses"]],
                          "leaves": {k: [prog[k], ref[k]] for k in ("change", "state")},
                          "grad": ref["grad"],
                          "sizes": ref["sizes"]}), flush=True)

    for seed in args.seeds:
        t0 = time.time()
        program = harness.set_up(cell, seed, args.device)
        prog = program.readings
        del program
        report("program", seed, prog, t0)
    for seed in args.control_seeds:
        t0 = time.time()
        report("control", seed, harness.follow_reference(cell, seed, args.device,
                                                         control=True), t0)
    for seed in args.fault_seeds:
        t0 = time.time()
        report("half_batch", seed, harness.follow_reference(cell, seed, args.device,
                                                            fault="half_batch"), t0)
    summary = {}
    for number in kinds["program"][0] if kinds["program"] else ():
        summary[number] = {
            "program_max": max((g[number][0] for g in kinds["program"]), default=None),
            "control_min": min((g[number][0] for g in kinds["control"]), default=None),
            "half_batch_min": min((g[number][0] for g in kinds["half_batch"]), default=None)}
    print(json.dumps({"workload": args.workload, "device": args.device,
                      "kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
