"""Flamingo biped walking up a smooth slope under the flat-ground
controller on the PyTorch port — model-mismatch MPC with terrain-height
(altitude) discovery; the counterpart of examples/flamingo_slope.py.

Mirror of the reference's ``examples/flamingo/slope.jl``: the controller is
linearized about the FLAT-ground gait; the physics runs on slope_smooth_2D_lc;
altitude updates (threshold 0.02) let the flat model track the discovered
surface height. Float64 on the CPU, as the JAX example; float32 on the card
(the knot kernel's type), with float32 sim options (r_tol 1e-3, κ_tol 1e-5, 40
iterations: the example's 1e-8 is out of float32's reach). The knot solves run
eight fixed iterations, the card kernel's form (the JAX example's are
adaptive).

Run: python examples/torch_flamingo_slope.py [--steps 1000] [--cpu]
     [--gif out.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--gif", type=str, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import contactimplicitmpc_tpu_torch as pt
    from contactimplicitmpc_tpu_torch.control.implicit_dynamics import \
        CONFIGURATION
    from contactimplicitmpc_tpu_torch.control.newton import NewtonOptions
    from contactimplicitmpc_tpu_torch.control.objective import \
        tracking_velocity_objective
    from contactimplicitmpc_tpu_torch.control.policy import CIMPCOptions
    from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
    from contactimplicitmpc_tpu_torch.control.trajectory import (
        from_gait, initial_conditions)
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models import flamingo as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    tk = dict(dtype=dtype, device=device)
    env = pt.flat_2d_lc                 # controller model (slope.jl:12)
    sim_env = pt.slope_smooth_2d_lc     # physics terrain (slope.jl:11)
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("flamingo", "gait_forward_36_4"),
                    **tk)
    n_sample, h_mpc, kappa_mpc = 5, 15, 2.0e-4

    # slope.jl:31-36
    obj = tracking_velocity_objective(
        dims, h_mpc,
        v=np.tile(1e-3 * np.array([1e0, 1, 1e4, 1, 1, 1, 1, 1e4, 1e4]),
                  (h_mpc, 1)),
        q=np.tile(1e-1 * np.array([3e2, 1e-6, 3e2, 1, 1, 1, 1, 0.1, 0.1]),
                  (h_mpc, 1)),
        u=np.tile(3e-1 * np.array([0.1, 0.1, 0.3, 0.3, 2.0, 2.0]),
                  (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), **tk)

    mpc_ip = IPOptions(r_tol=1e-8, kappa_tol=kappa_mpc, max_iter=100,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    if dtype == torch.float64:
        sim_opts = IPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=100,
                             undercut=float("inf"), max_ls=6)
    else:
        sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                             undercut=float("inf"), max_ls=6, refine=1)

    q1, v1 = initial_conditions(ref)
    traj, dt = timed(lambda: mpc_rollout(
        model, env, ref, obj, args.steps, h_mpc, n_sample, kappa_mpc,
        CONFIGURATION, q1[None], v1[None],
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5,
                             fixed_ip_iters=8),
        ip_opts=mpc_ip, sim_opts=sim_opts, warm_start_floor=1e-2,
        mpc_opts=CIMPCOptions(altitude_update=True,
                              altitude_impact_threshold=0.02),
        sim_env=sim_env), device)

    q = traj.q[0]
    heights = q[:, 1] - sim_env.surf(q[:, :1])
    print(f"sim converged: {bool(traj.sim_converged.all())}")
    print(f"x: {float(q[1, 0]):+.3f} -> {float(q[-1, 0]):+.3f} m "
          f"(up the slope); min torso clearance "
          f"{float(heights.min()):.3f} m")
    print(f"run {dt:.1f}s (first run) for {args.steps} steps, "
          f"{str(dtype).removeprefix('torch.')} {tag}")

    if args.gif:
        from contactimplicitmpc_tpu_torch.utils.visuals import animate_2d
        animate_2d(model, q[::10], env=sim_env, path=args.gif)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
