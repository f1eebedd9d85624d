"""The plain reference of ``quadruped-flat``: the flat-ground quadruped on
``flat_2d_lc`` tracking ``gait2``, from the frozen copy in
``benchmark/reference``; and the reference study's initial states."""

import numpy as np
import torch

from benchmark.reference.cimpc.control.objective import tracking_objective
from benchmark.reference.cimpc.env import flat_2d_lc
from benchmark.reference.cimpc.models.quadruped import (initial_configuration,
                                                        quadruped)
from benchmark.reference.mpc import ReferenceMPC


def reference(config: dict, dtype=torch.float64,
              device="cpu") -> ReferenceMPC:
    weights = config["mpc"]["objective"]

    def objective(dims, h, dtype, device):
        return tracking_objective(
            dims, h, q=np.tile(weights["q"], (h, 1)),
            u=weights["u"] * np.ones((h, dims.nu)),
            gamma=weights["gamma"] * np.ones((h, dims.nc)),
            b=weights["b"] * np.ones((h, dims.nb)), dtype=dtype,
            device=device)

    return ReferenceMPC(quadruped, flat_2d_lc, config, objective, dtype,
                        device)


def initial_states(ref: ReferenceMPC, draws: np.ndarray, gait_lane: bool):
    """(q1, v1), float64 arrays (lanes, nq): kinematically consistent
    standing poses from the leg angles and body offsets ``draws`` (lanes,
    6) (examples/quadruped/monte_carlo.jl:80-116: the last column, the
    height offset, is floored at 0), at the gait's initial velocity; with
    ``gait_lane`` lane 0 is the gait's own initial state."""
    conf = torch.as_tensor(draws, dtype=torch.float64).clone()
    conf[:, 5] = torch.clamp(conf[:, 5], min=0.0)
    q1 = initial_configuration(quadruped, *conf.T)
    g_q1, g_v1 = (x.to(torch.float64) for x in ref.gait_start())
    if gait_lane:
        q1[0] = g_q1
    return q1.numpy(), g_v1.expand_as(q1).numpy().copy()
