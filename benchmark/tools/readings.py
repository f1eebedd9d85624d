"""The readings that a cell's limits are set from: for each seed, one short
run of the cell (the same set-up, timed path and sample as a benchmark
run), then the numbers the comparison makes of the program and of its
control, the reference computed in bfloat16 in the program's place on the
same sample. The benchmark's own runs never run the control.

    python3 benchmark/tools/readings.py --workload <cell> --seconds <s> \\
        --seeds 11 12 13 [--no-control] [--out chiprun_out/readings.jsonl]

One JSON line a seed, on standard output and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)


def readings(cell, seed: int, seconds: float, device, control: bool) -> dict:
    import torch

    from benchmark.harness import judge
    from benchmark.reference.lowp import factorisations_in_low_precision

    run = cell.driver().run(cell, seed, seconds, False, time.perf_counter(),
                            device)
    run["close"]()
    records = run["records"]
    began = time.perf_counter()
    comp = judge.compare(cell, records, run["warm_rule"], seed, device)
    out = {"workload": cell.name, "seed": seed,
           "attempted": run["attempted"], "failed": run["failed"],
           "e2e": run["e2e"], "setup_s": run["setup_s"],
           "program": comp.program_numbers(),
           "compare_s": time.perf_counter() - began,
           "compare_parts": comp.seconds, "worst": comp.worst()}
    if control:
        with factorisations_in_low_precision():
            low = cell.reference().reference(cell.config,
                                              dtype=torch.bfloat16,
                                              device=device)
            began = time.perf_counter()
            out["control"] = comp.control_numbers(low)
            out["control_s"] = time.perf_counter() - began
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness.spec import load_cell
    if not torch.cuda.is_available():
        sys.exit("readings: no GPU")
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for seed in args.seeds:
        line = json.dumps(readings(cell, seed, args.seconds, device,
                                   not args.no_control))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
