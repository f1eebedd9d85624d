"""The benchmark of ``contactimplicitmpc_tpu_torch``: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the GPUs the cell asks
for. It builds the cell from the files that ``BENCHMARK.json`` names,
warms up its shapes (set-up), measures for ``--seconds``, compares what
the window produced with the plain reference, and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, with ``--trace 1``, ``breakdown``, then
the numbers compared beside their limits (``checks``, also the last lines
on standard error). It exits non-zero, printing no result, where there is
no GPU or too few, and where JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness import imports  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell, seed: int, seconds: float, trace: bool, t0: float,
            device) -> dict:
    """One run of ``cell`` on ``device``: the window, then the comparison.
    Returns the result line as a dict (``checks`` last)."""
    import torch

    from benchmark.harness import judge, layers

    run = cell.driver().run(cell, seed, seconds, trace, t0, device)
    reference = run.pop("reference")     # built on the host for the inputs
    metrics = {m["name"]: {"value": run["e2e"][m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end if m["name"] in run["e2e"]}
    setup_s, parts = run["setup_s"], run["setup_parts"]
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    line = {"attempted": run["attempted"], "failed": run["failed"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": int(run["memory_peak_bytes"])}
    if trace:
        ctx = layers.Context(cell, run["layer"], device, reference.dims)
        metrics = layers.read_all(cell, ctx)
        t = run["layer"]["trace"]
        info.update(busy_s=t.busy_s(), window_s=t.window_s)
        line["breakdown"] = t.breakdown()
    records, rule = run.pop("records"), run.pop("warm_rule")
    log = run.pop("log", "")
    run["close"]()
    del run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    began = time.perf_counter()
    comparison = judge.compare(cell, records, rule, seed, device)
    numbers = comparison.program_numbers()
    correct, checks = judge.verdict(numbers, cell.limits)
    print(f"benchmark: set-up {setup_s:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
          + "), comparison "
          f"{time.perf_counter() - began:.1f} s over {len(records)} "
          f"rollouts; the reference's sim solve converged on "
          f"{int(comparison.ref_ok.sum())} of "
          f"{len(comparison.picked['steps'])} sampled steps; "
          "control updates compared where both Newtons converged: "
          "{} of {}".format(*comparison.compared()), file=sys.stderr)
    if log:
        print(f"benchmark: {log}", file=sys.stderr)
    return {"correct": correct, **line, "metrics": metrics, "device": info,
            "checks": checks}


def main(argv=None) -> int:
    imports.require_clean("at start")
    args = parse(argv)
    from benchmark.harness.spec import load_cell
    cell = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} GPU(s), "
              f"found {found}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result = measure(cell, args.seed, args.seconds, bool(args.trace), T0,
                     torch.device("cuda", 0))
    imports.require_clean("after the window")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
