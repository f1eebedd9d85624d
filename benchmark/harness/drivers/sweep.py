"""The Monte-Carlo sweep: closed-loop rollouts of ``lanes`` lanes and
``steps`` sim steps, back to back from one caller, through the port's
sharded sweep (``parallel.make_sharded_mpc_rollouts``) over a one-rank
mesh. The rollouts take the mix's ``draws`` sets of initial states in
turn; ``attempted`` and ``failed`` count each drawn lane once
(``traffic.operations``).

The window holds whole rollouts: one starts while the time left holds the
longest so far, and one that ends after the window closes is not counted
(the first always is: a window shorter than one rollout ends with it).
``lane_steps_per_s`` is lanes × steps of the rollouts completed, over the
time from the window's start to the end of the last of them (each ended by
a synchronisation): every rollout's own linearization and graph captures
are inside it.

A traced run first profiles one whole rollout with the spans off (the
trace), then runs the window with the program's spans on.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist
from torch.profiler import profile, record_function

from contactimplicitmpc_tpu_torch.parallel import (make_mesh,
                                                   make_sharded_mpc_rollouts)

from benchmark.reference.mpc import WarmRule

from .. import probes, traffic as draws
from ..trace import Trace

MARK = "benchmark.traced"


def gait_lane(i: int) -> bool:
    """Lane 0 of every rollout starts from the gait's own initial state."""
    return True


def warm_rule(config: dict) -> WarmRule:
    """``mpc_rollout``'s warm start under the configuration's settings."""
    mpc = config["mpc"]
    return WarmRule(full=mpc.get("structure_full_warm", True),
                    reset_scale=mpc.get("newton_reset_scale", 0.0))


def _host(traj, stats, q1, draw) -> dict:
    return {"draw": draw, "q1": q1.cpu().numpy(), "q": traj.q.cpu().numpy(),
            "u": traj.u.cpu().numpy(), "gamma": traj.gamma.cpu().numpy(),
            "b": traj.b.cpu().numpy(), "conv": traj.sim_converged.cpu().numpy(),
            "n": int(round(float(stats.n_rollouts))),
            "newton_r": traj.mpc_r_norm.double().cpu().numpy(),
            "sim_iters": traj.sim_iterations.cpu().numpy()}


def _lost(record):
    """A lane is lost where some sim step of it did not converge."""
    return ~record["conv"].all(axis=1)


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device) -> dict:
    program, refmod = cell.program(), cell.reference()
    traffic, config = cell.traffic, cell.config
    lanes, steps = traffic["lanes"], traffic["steps"]
    n_sample = config["mpc"]["n_sample"]
    dtype = getattr(torch, config["dtype"])

    parts = {"imports": time.perf_counter() - t0}
    reference = refmod.reference(config)
    states = draws.initial_states(refmod, reference, traffic, seed,
                                  gait_lane)
    inputs = [tuple(torch.as_tensor(x, dtype=dtype, device=device)
                    for x in pair) for pair in states]
    mesh = make_mesh(device=device)
    rollout, gait = program.rollout(config, steps, device)
    sweep = make_sharded_mpc_rollouts(mesh, rollout, gait, n_sample)
    warm_rollout, _ = program.rollout(config, n_sample, device)
    parts["inputs and program"] = probes.sync(device) - t0 - sum(parts.values())
    make_sharded_mpc_rollouts(mesh, warm_rollout, gait, n_sample)(*inputs[0])
    setup_s = probes.sync(device) - t0
    parts["warm-up"] = setup_s - sum(parts.values())

    out = {"setup_s": setup_s, "setup_parts": parts, "reference": reference,
           "warm_rule": warm_rule(config), "layer": {}}
    done = []
    if trace:
        before = probes.snapshot()
        with profile(activities=probes.activities(device)) as prof:
            with record_function(MARK):
                traced = sweep(*inputs[0])
                probes.sync(device)
        out["layer"]["counters"] = probes.difference(probes.snapshot(), before)
        out["layer"]["trace"] = Trace.from_profiler(prof, MARK)
        done.append((traced, inputs[0][0], 0))

    spans, first, durations = {}, len(done), []
    before = probes.snapshot()
    with probes.spans_on(spans) if trace else contextlib.nullcontext():
        start = last = probes.sync(device)
        end, longest, i = start + seconds, 0.0, 0
        while True:
            begin = time.perf_counter()
            if i and begin + longest > end:
                break
            traj = sweep(*inputs[i % len(inputs)])
            finish = probes.sync(device)
            longest = max(longest, finish - begin)
            if i and finish > end:
                break
            done.append((traj, inputs[i % len(inputs)][0], i % len(inputs)))
            durations.append(finish - begin)
            last, i = finish, i + 1
    completed = len(done) - first
    window = last - start
    out["e2e"] = {"lane_steps_per_s": completed * lanes * steps / window}
    out["log"] = "rollouts (s): " + " ".join(f"{d:.3f}" for d in durations)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if torch.device(device).type == "cuda" else 0)
    if trace:
        out["layer"].update(spans=spans, window_s=window,
                            window_counters=probes.difference(
                                probes.snapshot(), before))
    out["records"] = [_host(traj, stats, q1, d)
                      for (traj, stats), q1, d in done]
    out["attempted"], out["failed"] = draws.operations(out["records"], _lost)
    out["log"] += "; lanes lost a rollout (draw): " + " ".join(
        f"{int(_lost(r).sum())} ({r['draw']})" for r in out["records"])
    if trace:
        out["layer"]["traced"] = {"lanes": lanes, "steps": steps,
                                  "periods": steps // n_sample,
                                  "sim_trips": out["records"][0]["sim_iters"]
                                  .sum(axis=0).tolist()}
    out["close"] = dist.destroy_process_group
    return out
