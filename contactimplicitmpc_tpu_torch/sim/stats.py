"""Simulator statistics: the ``SimulatorStatistics`` / ``process!`` /
speed-ratio surface of the reference (``examples/quadruped/flat.jl:77-79``
computes ``speed ratio = H_sim*h_sim / sum(stats.policy_time)``).

PyTorch counterpart of ``contactimplicitmpc_tpu/sim/stats.py``:

* ``time_policy``: wall clock of the policy update in isolation, after a
  warm-up call; on CUDA inputs each call is bracketed by
  ``torch.cuda.synchronize()``, so the time includes the device's work;
* ``SimulatorStatistics.speed_ratio``: simulated time per control update
  against that measured policy time — ≥ 1 means real-time capable.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch


class SimulatorStatistics(NamedTuple):
    """process! output (RoboDojo SimulatorStatistics equivalent)."""

    policy_time_mean: float   # seconds per control update
    policy_time_std: float
    speed_ratio: float        # sim-time / compute-time; ≥ 1 ⇒ real-time


def process(policy_times, h_sim: float, n_sample: int,
            horizon_sim: int) -> SimulatorStatistics:
    """Aggregate per-update policy times (process!, plus the examples'
    speed-ratio recipe): ``horizon_sim`` sim steps of length ``h_sim``
    contain ``horizon_sim / n_sample`` policy updates."""
    t = np.asarray(policy_times, dtype=np.float64)
    n_ctrl = max(1, horizon_sim // n_sample)
    total_compute = float(t.mean()) * n_ctrl
    sim_time = h_sim * horizon_sim
    return SimulatorStatistics(
        policy_time_mean=float(t.mean()),
        policy_time_std=float(t.std()),
        speed_ratio=sim_time / max(total_compute, 1e-12),
    )


def time_policy(policy, obs, reps: int = 10):
    """Wall-clock the policy update in isolation.

    ``policy`` is the ``(init_state, apply)`` pair from ``ci_mpc_policy``;
    ``obs`` a representative ``PolicyObs`` of (B, ·) tensors. Every call
    starts from the initial state, so each is a control update. Returns
    per-call seconds (array of length ``reps``), measured after one
    warm-up call.
    """
    init_state, apply = policy
    batch = obs.q1.shape[0]
    sync = torch.cuda.synchronize if obs.q1.is_cuda else (lambda: None)
    apply(init_state(batch), obs)  # warm: builds kernels, fills caches
    sync()
    out = []
    for _ in range(reps):
        state = init_state(batch)
        t0 = time.perf_counter()
        apply(state, obs)
        sync()
        out.append(time.perf_counter() - t0)
    return np.asarray(out)
