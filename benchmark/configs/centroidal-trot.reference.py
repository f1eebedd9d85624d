"""The plain reference of ``centroidal-trot``: the 18-DoF centroidal
quadruped on ``flat_3d_lc`` trotting in place (``inplace_trot_v2``), from
the frozen copy in ``benchmark/reference``; and its initial states."""

import numpy as np
import torch

from benchmark.reference.cimpc.control.objective import \
    tracking_velocity_objective
from benchmark.reference.cimpc.env import flat_3d_lc
from benchmark.reference.cimpc.models.centroidal_quadruped import \
    centroidal_quadruped
from benchmark.reference.mpc import ReferenceMPC


def reference(config: dict, dtype=torch.float64,
              device="cpu") -> ReferenceMPC:
    weights = config["mpc"]["objective"]

    def objective(dims, h, dtype, device):
        return tracking_velocity_objective(
            dims, h, q=np.asarray(weights["q"]), v=np.asarray(weights["v"]),
            u=weights["u"] * np.ones(dims.nu), dtype=dtype, device=device)

    return ReferenceMPC(centroidal_quadruped, flat_3d_lc, config, objective,
                        dtype, device)


def initial_states(ref: ReferenceMPC, draws: np.ndarray, gait_lane: bool):
    """(q1, v1), float64 arrays (lanes, nq): the gait's initial state with
    the body moved by ``draws`` (lanes, 6), position then Euler angles
    (tools/centroidal_lanes_reference.py's offsets); the feet stay; with
    ``gait_lane`` lane 0 is the gait's own initial state."""
    g_q1, g_v1 = (x.to(torch.float64).numpy() for x in ref.gait_start())
    q1 = np.repeat(g_q1[None], draws.shape[0], axis=0)
    first = 1 if gait_lane else 0
    q1[first:, :6] += draws[first:, :6]
    return q1, np.repeat(g_v1[None], draws.shape[0], axis=0)
