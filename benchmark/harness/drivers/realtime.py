"""One robot under real-time control: the MPC policy, built once in set-up,
driving the physics (``simulate``) through episodes of ``steps`` sim steps,
back to back, taking the mix's ``draws`` initial states in turn;
``attempted`` and ``failed`` count each drawn episode once
(``traffic.operations``).

A control update runs from the observation being ready on the device (the
harness synchronises first, untimed) to the control copied to the host, as
a controller would send it to the motors; the next update follows as soon
as the plant's sim steps are done. ``control_ms_p50`` and
``control_ms_p95`` are the median and the 95th percentile of every update
that ends inside the window. The episode running when the window closes is
stopped and neither counted nor compared (the first always runs to its
end: a window shorter than one episode ends with it).

A traced run profiles the window's first ``profile_updates`` updates (the
trace; each update is a ``benchmark.update`` range in it).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.profiler import profile, record_function

from benchmark.reference.mpc import WarmRule

from .. import probes, traffic as draws
from ..trace import Trace

MARK, UPDATE = "benchmark.traced", "benchmark.update"
# ``ci_mpc_policy`` warm-starts every update after the first from the
# previous plan shifted one knot, and never restarts
WARM_RULE = WarmRule(full=True, reset_scale=0.0)


def gait_lane(i: int) -> bool:
    """The first episode starts from the gait's own initial state."""
    return i == 0


class WindowClosed(Exception):
    pass


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device) -> dict:
    program, refmod = cell.program(), cell.reference()
    traffic, config = cell.traffic, cell.config
    steps, n_sample = traffic["steps"], config["mpc"]["n_sample"]
    dtype = getattr(torch, config["dtype"])
    cuda = torch.device(device).type == "cuda"

    parts = {"imports": time.perf_counter() - t0}
    reference = refmod.reference(config)
    states = draws.initial_states(refmod, reference, traffic, seed,
                                  gait_lane)
    inputs = [tuple(torch.as_tensor(x, dtype=dtype, device=device)
                    for x in pair) for pair in states]
    (init, apply), simulate = program.policy(config, device)
    parts["inputs and program"] = probes.sync(device) - t0 - sum(parts.values())
    simulate(*inputs[0], n_sample, (init, apply))
    setup_s = probes.sync(device) - t0
    parts["warm-up"] = setup_s - sum(parts.values())

    times, records, clock = [], [], {"end": float("inf")}
    prof = profile(activities=probes.activities(device)) if trace else None
    traced = {"left": traffic["profile_updates"] if trace else 0,
              "mark": record_function(MARK)}

    def timed_apply(state, obs):
        if state.cnt != n_sample:
            return apply(state, obs)
        begin = probes.sync(device)
        if records and begin >= clock["end"]:
            raise WindowClosed
        with record_function(UPDATE) if traced["left"] else \
                contextlib.nullcontext():
            u, state = apply(state, obs)
            u.cpu()
        finish = time.perf_counter()
        if finish <= clock["end"] or not records:
            times.append(finish - begin)
        if traced["left"]:
            traced["left"] -= 1
            if not traced["left"]:
                probes.sync(device)
                traced["mark"].__exit__(None, None, None)
                prof.stop()
        return u, state

    out = {"setup_s": setup_s, "setup_parts": parts, "reference": reference,
           "warm_rule": WARM_RULE, "layer": {}}
    if trace:
        prof.start()
        traced["mark"].__enter__()
    start = probes.sync(device)
    clock["end"] = start + seconds
    i = 0
    while not records or time.perf_counter() < clock["end"]:
        q1, v1 = inputs[i % len(inputs)]
        try:
            traj = simulate(q1, v1, steps, (init, timed_apply))
        except WindowClosed:
            break
        records.append({"draw": i % len(inputs), "q1": q1.cpu().numpy(), "q": traj.q.cpu().numpy(),
                        "u": traj.u.cpu().numpy(),
                        "gamma": traj.gamma.cpu().numpy(),
                        "b": traj.b.cpu().numpy(),
                        "conv": traj.converged.cpu().numpy(),
                        "n": traj.q.shape[0]})
        i += 1
    if traced["left"]:
        raise RuntimeError("realtime: the window ended before "
                           f"{traffic['profile_updates']} updates were traced")
    ms = 1e3 * np.asarray(times)
    out["e2e"] = {"control_ms_p50": float(np.percentile(ms, 50)),
                  "control_ms_p95": float(np.percentile(ms, 95))}
    out["updates"] = len(times)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if cuda else 0)
    if trace:
        out["layer"]["trace"] = Trace.from_profiler(prof, MARK)
    out["records"] = records
    out["attempted"], out["failed"] = draws.operations(
        records, lambda r: [not r["conv"].all()])
    out["log"] = "episodes lost (draw): " + " ".join(
        f"{int(not r['conv'].all())} ({r['draw']})" for r in records)
    out["close"] = lambda: None
    return out
