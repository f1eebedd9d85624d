"""Cells cut to a size a CPU test run holds: the same files, the same
harness, a few lanes and steps."""

import time

import torch

from benchmark.harness.spec import load_cell

# ten control periods, so that the first updates' solves from perturbed
# poses do not set a lane's quantile; four lanes, so that a fault on a
# minority of them can be planted
SIZES = {"quadruped-sweep": (4, 50), "centroidal-sweep": (4, 50),
         "quadruped-rt": (1, 50)}
CHECK = {"sim_steps": 8, "lanes": 4, "updates": 10}


def tiny_cell(name: str, benchmark: str = None):
    cell = load_cell(name, benchmark)
    lanes, steps = SIZES.get(name, (4, 50))
    cell.traffic.update(lanes=lanes, steps=steps, draws=2, profile_updates=1,
                        check=dict(CHECK))
    return cell


def tiny_run(cell, seed: int = 2 ** 31 + 7, seconds: float = 1.0,
             trace: bool = False) -> dict:
    """One run of ``cell`` on the CPU: a window of ``seconds`` that the
    first rollout outlasts, so that exactly one completes."""
    from benchmark.run import measure
    return measure(cell, seed, seconds, trace, time.perf_counter(),
                   torch.device("cpu"))
