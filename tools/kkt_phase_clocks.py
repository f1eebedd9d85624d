#!/usr/bin/env python
"""Where the Newton's two KKT kernels spend a launch: the SM clock cycles of
each phase, on the GPU.

    python3 tools/kkt_phase_clocks.py [--reps 20]

Runs each kernel through its wrapper on seeded inputs at the paths' shapes:
the structured solve (``ops/structure_kkt.py``) at path A's (16 lanes, nq
11, nu 8, H 10) and the 2D hopper's widths (nq 4, nu 2), the LDLᵀ
(``ops/ldl.py``) at n = 100, 300 and 480 (16 SQD matrices), float32 and
float64. One JSON line a case: the launch's time over ``--reps`` launches
of the build the Newton solves run (CUDA events), and the cycles a launch
of each phase and their sum, averaged over ``--reps`` launches of the
clocked build (``-DKKT_PHASE_CLOCKS``, ``phase_clocks``: thread 0 of
block 0, for the LDLᵀ CTA 0 of cluster 0, reads ``clock64()`` at the
phases' marks; the wrappers' ``PHASES`` name them; a phase that overlaps
another, as the LDLᵀ's diagonal-block factor overlaps the trailing
update's columns past it, is clocked on thread 0's own warp), the LDLᵀ's
cluster geometry and how many such clusters the card runs at once
(``cudaOccupancyMaxActiveClusters``), beside the card's name, SM clocks
and power limit as ``nvidia-smi`` reads them. The marks leave the
arithmetic as it is.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def measure(launch, clocked, reps):
    """(ms a launch over ``reps`` launches, {phase: cycles a launch} over
    ``reps`` clocked launches)."""
    import torch
    launch()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    total = {}
    for _ in range(reps):
        for phase, cycles in clocked().items():
            total[phase] = total.get(phase, 0) + cycles
    return (start.elapsed_time(end) / reps,
            {phase: c / reps for phase, c in total.items()})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from contactimplicitmpc_tpu_torch.control import structure_solver as ss
    from contactimplicitmpc_tpu_torch.device import describe
    from contactimplicitmpc_tpu_torch.dims import Dims
    from contactimplicitmpc_tpu_torch.ops import ldl as ldl_mod
    from contactimplicitmpc_tpu_torch.ops import structure_kkt as sk_mod

    if not torch.cuda.is_available():
        raise SystemExit("kkt_phase_clocks: CUDA is not available")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()

    def report(kernel, dtype, shape, ms, cycles):
        print(json.dumps({"kernel": kernel, "dtype": str(dtype), **shape,
                          "ms": ms, "cycles": cycles,
                          "cycles_total": sum(cycles.values()), "card": smi}),
              flush=True)

    for dtype in (torch.float32, torch.float64):
        for nq, nu in ((11, 8), (4, 2)):
            h, lanes = 10, 16
            rng = np.random.default_rng(0)
            t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
            dims = Dims(nq=nq, nu=nu, nw=0, nc=1, nf=2, ne=2)
            obj = ss.build_structure_objective(
                dims, t(0.5 + rng.random((h + 1, nq))),
                t(0.1 + 0.1 * rng.random((h + 1, nq))),
                t(0.5 + rng.random((h + 1, nu))), 1e-6, h)
            shapes = [(h, nq, nq), (h, nq, nq), (h, nq, nu), (h, nu), (h, nq),
                      (h, nq), (h, nq), (h, nq)]
            xs = [t(rng.standard_normal((lanes,) + s)
                    * (0.3 if len(s) == 3 else 1.0)) for s in shapes]
            call = (dims, obj, *xs, 1e-5, h)
            ms, cycles = measure(lambda: sk_mod.structure_kkt(*call),
                                 lambda: sk_mod.phase_clocks(*call), args.reps)
            report("structure_kkt", dtype,
                   {"lanes": lanes, "nq": nq, "nu": nu, "h": h}, ms, cycles)
        for n, m in ((100, 40), (300, 110), (480, 180)):
            rng = np.random.default_rng(1)
            p = rng.standard_normal((16, n - m, n - m))
            p = p @ p.transpose(0, 2, 1) / (n - m) + np.eye(n - m)
            r = rng.standard_normal((16, m, m))
            r = r @ r.transpose(0, 2, 1) / m + 1e-2 * np.eye(m)
            b = 0.3 * rng.standard_normal((16, m, n - m))
            a = np.concatenate([np.concatenate([p, b.transpose(0, 2, 1)], -1),
                                np.concatenate([b, -r], -1)], -2)
            mats = torch.as_tensor(a, dtype=dtype, device=dev)
            rhs = torch.as_tensor(rng.standard_normal((16, n)), dtype=dtype,
                                  device=dev)
            ms, cycles = measure(lambda: ldl_mod.ldl(mats, rhs),
                                 lambda: ldl_mod.phase_clocks(mats, rhs),
                                 args.reps)
            elem = mats.element_size()
            report("ldl", dtype, {"lanes": 16, "n": n,
                                  **ldl_mod.geometry(n, elem),
                                  "max_active_clusters":
                                      ldl_mod.max_active_clusters(n, elem)},
                   ms, cycles)
    print(describe(dev))


if __name__ == "__main__":
    main()
