"""Where a trip of the quadruped's sim kernel spends its time, on the card.

Builds the sim kernel (csrc/sim_ip.cu over csrc/sim_ip.cuh) twice, as the
sim steps run it and with ``-DSIM_IP_PHASE_CLOCKS`` (one thread of problem
0 adds ``clock64()`` deltas a phase, ``ops.sim_ip.phase_clocks``), and runs
the sim steps that chip_smoke.py's phase S times: the first sim step of a
plain run of path A (tests/test_torch_sim_ip_cuda.py's ``record_states``),
16 lanes and 1 lane with the hot path's options, 1 lane with phase L's, in
float32 (float64 inside). The problem that takes the most trips is put
first, so that the clocked problem is the one that sets the step's time.

For each case it prints the step's time (CUDA events, the build the sim
steps run), the clocked problem's trips, and each phase's cycles and
microseconds, in all and a trip, at the SM clock ``nvidia-smi`` reported
during a burst of launches (``clocks.sm``; ``clocks.max.sm`` beside it).
The phases (``ops.sim_ip.PHASES``): the trigonometry and the Jacobian, the
Schur factors, the three structured solves, the line-search candidates,
the bookkeeping of a trip (step lengths, σ, the pick, the copies), and the
start and finish of a solve (θ's terms, the first residual, the outputs).
Then ptxas's registers and spills of both builds, and one JSON line a case
after the card's name and power limit.

    python3 tools/sim_ip_phases.py            # on the card
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from contactimplicitmpc_tpu_torch.device import describe  # noqa: E402
from contactimplicitmpc_tpu_torch.env import flat_2d_lc  # noqa: E402
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped  # noqa: E402
from contactimplicitmpc_tpu_torch.ops import cuda_build, sim_ip  # noqa: E402

CASES = ((16, "hot_path"), (1, "hot_path"), (1, "phase_L"))
SPIN_CYCLES = 60_000_000   # ≈ 35 ms of device spin ahead of timed launches


def sm_clocks(burst) -> tuple:
    """(clocks.sm, clocks.max.sm) in MHz, the first read while ``burst``
    keeps the card busy."""
    query = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits",
             f"--id={torch.cuda.current_device()}"]
    stop = threading.Event()

    def run():
        while not stop.is_set():
            burst()
            torch.cuda.synchronize()

    worker = threading.Thread(target=run)
    worker.start()
    try:
        time.sleep(0.5)
        out = subprocess.run(query, capture_output=True, text=True,
                             check=True, timeout=60).stdout
    finally:
        stop.set()
        worker.join()
    now, top = (float(x) for x in out.strip().splitlines()[0].split(","))
    return now, top


def step_ms(fn, reps=20) -> float:
    """CUDA-event time of one call, the calls queued behind a device spin."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sim_ip_phases: CUDA is not available")
    import test_torch_sim_ip_cuda as sim_tests
    card = describe("cuda")
    dev = torch.device("cuda")
    libs = {"main": sim_ip.build(), "clocked": sim_ip.build(phase_clocks=True)}
    for name, lib in libs.items():
        for r in cuda_build.resources(lib):
            print(f"ptxas, {name} build: {json.dumps(r)}", flush=True)
    z32, th32 = sim_tests.record_states(dev, steps=sim_tests.CFG.n_sample)
    rows = []
    for lanes, name in CASES:
        opts = sim_tests.OPTIONS[name]
        z0, theta = z32[:lanes].contiguous(), th32[:lanes].contiguous()
        run = lambda: sim_ip.sim_ip(quadruped, flat_2d_lc, z0, theta, opts)
        iters = run().iterations
        first = int(torch.argmax(iters))          # the slowest problem first
        order = torch.tensor([first] + [i for i in range(lanes) if i != first],
                             dtype=torch.long, device=dev)
        z0, theta = z0[order].contiguous(), theta[order].contiguous()
        ms = step_ms(run)
        now, top = sm_clocks(run)
        clk = sim_ip.phase_clocks(quadruped, flat_2d_lc, z0, theta, opts)
        trips = clk["trips"]
        us = lambda c: c / now            # cycles at `now` MHz → µs
        phases = {p: {"cycles": clk[p], "us": us(clk[p]),
                      "us_a_trip": us(clk[p]) / max(trips, 1)}
                  for p in sim_ip.PHASES}
        print(f"{lanes} lane(s), {name} options: a step {ms:.4f} ms "
              f"(CUDA events), {int(iters.sum())} trips in all, the clocked "
              f"(slowest) problem {trips} trips, its solve {us(clk['total']):.2f}"
              f" us ({us(clk['total']) / max(trips, 1):.2f} us a trip) at "
              f"{now:.0f} MHz (max {top:.0f}) [{card}]", flush=True)
        for p, v in phases.items():
            print(f"  {p:14s} {v['cycles']:>10d} cycles {v['us']:9.2f} us "
                  f"{v['us_a_trip']:8.2f} us a trip "
                  f"({v['cycles'] / max(clk['total'], 1):.1%})", flush=True)
        rows.append({"lanes": lanes, "options": name, "step_ms": ms,
                     "trips_all": int(iters.sum()), "trips": trips,
                     "total_cycles": clk["total"], "total_us": us(clk["total"]),
                     "sm_mhz": now, "sm_max_mhz": top, "phases": phases})
    print(card)
    for row in rows:
        print(json.dumps({"sim_ip_phases": row, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
