"""``centroidal-trot`` as the program runs it: ``mpc_rollout`` with the
options of ``examples/torch_centroidal_trot.py`` (direct-mode Newton, fixed
knot solves, the adaptive sim interior point)."""

import numpy as np
import torch

from contactimplicitmpc_tpu_torch.control.implicit_dynamics import \
    CONFIGURATION
from contactimplicitmpc_tpu_torch.control.newton import NewtonOptions
from contactimplicitmpc_tpu_torch.control.objective import \
    tracking_velocity_objective
from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
from contactimplicitmpc_tpu_torch.control.trajectory import from_gait
from contactimplicitmpc_tpu_torch.env import flat_3d_lc
from contactimplicitmpc_tpu_torch.models import centroidal_quadruped
from contactimplicitmpc_tpu_torch.models.base import dims_of
from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait


def options(settings: dict) -> IPOptions:
    return IPOptions(**{k: float(v) if isinstance(v, str) else v
                        for k, v in settings.items()})


def rollout(config: dict, steps: int, device):
    """(rollout_fn(q1, v1) -> MPCRollout, gait reference) of ``steps`` sim
    steps for every lane of (B, nq) on ``device``."""
    mpc = config["mpc"]
    model, env = centroidal_quadruped, flat_3d_lc
    dims = dims_of(model, env)
    dtype = getattr(torch, config["dtype"])
    ref = from_gait(model, env, load_gait(*config["gait"].split("/")),
                    update_friction=True, dtype=dtype, device=device)
    weights = mpc["objective"]
    obj = tracking_velocity_objective(
        dims, mpc["h_mpc"], q=np.asarray(weights["q"]),
        v=np.asarray(weights["v"]), u=weights["u"] * np.ones(dims.nu),
        dtype=dtype, device=device)
    n_opts = NewtonOptions(**mpc["newton"])
    ip_opts, sim_opts = options(mpc["knot_ip"]), options(mpc["sim_ip"])

    def fn(q1, v1):
        return mpc_rollout(model, env, ref, obj, steps, mpc["h_mpc"],
                           mpc["n_sample"], mpc["kappa_mpc"], CONFIGURATION,
                           q1, v1, n_opts=n_opts, ip_opts=ip_opts,
                           sim_opts=sim_opts,
                           warm_start_floor=mpc["warm_start_floor"])

    return fn, ref
