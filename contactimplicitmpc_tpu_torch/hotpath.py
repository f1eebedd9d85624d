"""The shipped product hot-path configuration, as one importable object.

PyTorch counterpart of ``contactimplicitmpc_tpu/hotpath.py``: the
flat-ground quadruped Monte-Carlo rollout (gait ``gait2``, terrain
``flat_2d_lc``) with the defaults of the JAX package's ``HotPathConfig``.

Reference contract anchors:
* MPC recipe: ``examples/quadruped/flat.jl:25-29`` (N_sample=5,
  H_mpc=10, κ_mpc=2e-4)
* tracking thresholds: ``test/controller/mpc_quadruped.jl:61-68``
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

# The 16 "conf" leg-angle/pose draws of tests/test_hotpath.py (bench.py's
# Monte-Carlo distribution, drawn by JAX from PRNGKey(0)), kept as numpy so
# that the port reproduces those lanes one for one without JAX.
CONF_POSES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets", "hotpath_conf16.npz")


@dataclasses.dataclass(frozen=True)
class HotPathConfig:
    """Every knob of the product Monte-Carlo rollout; field names and
    defaults match the JAX package's ``HotPathConfig`` (its TPU loop
    unroll factors are not ported). ``newton_mode="direct"`` runs the dense
    horizon KKT instead of the structure-mode sweep."""

    h_mpc: int = 10
    n_sample: int = 5
    kappa_mpc: float = 2.0e-4
    newton_mode: str = "structure"

    # Newton options
    newton_r_tol: float = 3.0e-4
    newton_iters: int = 5
    newton_max_ls: int = 6           # line-search halvings (newton.jl:249)
    fixed_ip_iters: int = 8          # fixed-iteration knot solves
    trial_ip_iters: int = 0          # >0: reduced budget for LS trials
    fixed_newton_iters: int = 0      # 0 = adaptive Newton loop
    ls_growth_allow: float = 2.0     # bounded no-accept fallback (f32)
    newton_reset_scale: float = 10.0  # cold-restart trapped warm starts

    # MPC-knot interior point
    mpc_r_tol: float = 1.0e-5
    mpc_ip_iters: int = 30
    gamma_reg: float = 0.1
    mpc_max_ls: int = 3
    refine: int = 1                  # knot-solve refinement passes

    # simulation-path interior point
    sim_r_tol: float = 1.0e-3
    sim_kappa_tol: float = 1.0e-5
    sim_iters: int = 40
    sim_max_ls: int = 6
    sim_refine: int = 0
    sim_fixed_iters: int = 24        # masked fixed-iteration sim solves
    sim_retries: int = 0

    # warm starts
    warm_start_floor: float = 1.0e-2
    structure_full_warm: bool = False  # duals-only

    def newton_options(self):
        from .control.newton import NewtonOptions
        return NewtonOptions(r_tol=self.newton_r_tol,
                             max_iter=self.newton_iters,
                             max_ls=self.newton_max_ls,
                             fixed_ip_iters=self.fixed_ip_iters,
                             trial_ip_iters=self.trial_ip_iters,
                             fixed_newton_iters=self.fixed_newton_iters,
                             ls_growth_allow=self.ls_growth_allow)

    def mpc_ip_options(self):
        from .sim.interior_point import IPOptions
        return IPOptions(r_tol=self.mpc_r_tol, kappa_tol=self.kappa_mpc,
                         max_iter=self.mpc_ip_iters, undercut=5.0,
                         gamma_reg=self.gamma_reg, diff_sol=True,
                         max_ls=self.mpc_max_ls, refine=self.refine)

    def sim_ip_options(self):
        from .sim.interior_point import IPOptions
        return IPOptions(r_tol=self.sim_r_tol,
                         kappa_tol=self.sim_kappa_tol,
                         max_iter=self.sim_iters,
                         undercut=float("inf"), max_ls=self.sim_max_ls,
                         retries=self.sim_retries, refine=self.sim_refine,
                         fixed_iters=self.sim_fixed_iters)


def quadruped_tracking_weights(dims, h_mpc, dtype, device=None):
    """The flat-ground quadruped objective (mpc_quadruped.jl:23-27 /
    examples/quadruped/flat.jl:31-36), on ``device``, by default the GPU."""
    from .control.objective import tracking_objective
    qw = 1e-2 * np.array([1.0, 0.02, 0.25] + [0.25] * (dims.nq - 3))
    return tracking_objective(
        dims, h_mpc, q=np.tile(qw, (h_mpc, 1)),
        u=3e-2 * np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype, device=device)


def conf_initial_states(model, ref):
    """(q1s, v1s), each (16, nq) on ``ref``'s dtype and device: the lanes
    of tests/test_hotpath.py. Lane 0 is the gait's own initial condition,
    lanes 1-15 the standing poses of ``CONF_POSES``; all at the gait's
    initial velocity."""
    from .control.trajectory import initial_conditions
    from .models.quadruped import initial_configuration
    q1, v1 = initial_conditions(ref)
    with np.load(CONF_POSES) as f:
        conf = torch.as_tensor(f["conf"].T.copy(), dtype=ref.q.dtype,
                               device=ref.q.device)
    q1s = initial_configuration(model, *conf)
    q1s[0] = q1
    return q1s, v1.expand_as(q1s).contiguous()


def make_quadruped_rollout(cfg: HotPathConfig, steps: int, dtype,
                           device=None):
    """Build (rollout_fn, ref, model, env, dims) for the flat-ground
    quadruped Monte-Carlo program; ``ref`` lies on ``device``, by default
    the GPU (``device.default_device`` raises where there is none; pass
    ``device="cpu"`` to run on the CPU).

    ``rollout_fn(q1s, v1s)`` runs one closed-loop rollout of ``steps`` sim
    steps for every lane of the batch ``(B, nq)``, on the device of its
    inputs.
    """
    from .control.implicit_dynamics import CONFIGURATION
    from .control.rollout import mpc_rollout
    from .control.trajectory import from_gait
    from .device import resolve_device
    from .env import flat_2d_lc
    from .models.base import dims_of
    from .models.quadruped import quadruped as model
    from .utils.gaits import load_gait

    device = resolve_device(device)
    env = flat_2d_lc
    dims = dims_of(model, env)
    gait = load_gait("quadruped", "gait2")
    per_device = {}

    def setup(dev):
        dev = torch.device(dev)
        if dev not in per_device:
            per_device[dev] = (
                from_gait(model, env, gait, update_friction=True,
                          dtype=dtype, device=dev),
                quadruped_tracking_weights(dims, cfg.h_mpc, dtype, dev))
        return per_device[dev]

    def rollout(q1s, v1s):
        ref, obj = setup(q1s.device)
        return mpc_rollout(model, env, ref, obj, steps, cfg.h_mpc,
                           cfg.n_sample, cfg.kappa_mpc, CONFIGURATION,
                           q1s, v1s,
                           n_opts=cfg.newton_options(),
                           ip_opts=cfg.mpc_ip_options(),
                           sim_opts=cfg.sim_ip_options(),
                           warm_start_floor=cfg.warm_start_floor,
                           newton_mode=cfg.newton_mode,
                           newton_reset_scale=cfg.newton_reset_scale,
                           structure_full_warm=cfg.structure_full_warm)

    return rollout, setup(device)[0], model, env, dims
