"""Hopper CI-MPC on rough terrain on the PyTorch port: sine, piecewise slope,
and 3D sine — the counterpart of examples/hopper_terrain.py.

Mirrors of the reference's ``examples/hopper/``:

* ``sine.jl`` — 2D hopper, flat-ground controller model + altitude
  updates, simulated on ``sine2_2D_lc`` (gait_forward, N_sample 5,
  H_mpc 10, κ 2e-4)
* ``piecewise.jl`` — same controller on the piecewise slope terrain
* ``3D_sine.jl`` — 3D hopper forward gait on ``sine2_3D_lc``
  (N_sample 10, H_mpc 20, κ 1e-4, altitude threshold 0.05)

The controller is always linearized about the FLAT environment; terrain enters
only through the simulated physics and the altitude discovery loop
(update_altitude!, mpc_utils.jl:109-135). The knot solves run eight fixed
iterations, the card kernel's form (the JAX example's are adaptive).

Run: python examples/torch_hopper_terrain.py [--case sine|piecewise|sine3d]
     [--steps 1000] [--cpu] [--f64] [--gif out.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# model: (gait folder, N_sample, H_mpc, κ, q weights, u weights), the
# weights of sine.jl:31-35 for the 2D hopper, 3D_sine.jl:38-42 for the 3D
RECIPES = {
    "hopper_2D": ("hopper_2D", 5, 10, 2.0e-4, [0.1, 3.0, 1.0, 3.0],
                  [1e-3, 1e0]),
    "hopper_3D": ("hopper_3D", 10, 20, 1.0e-4,
                  [3, 3, 0.1, 50, 50, 50, 10.0], [1e-1, 1e-1, 1e1]),
}


def run_case(model_name, sim_env_name, steps, dtype, device,
             fixed_ip_iters=8, q1=None, v1=None):
    """The sine.jl / piecewise.jl / 3D_sine.jl recipe: the controller on
    flat ground with altitude updates, the physics on ``sim_env_name``,
    from the gait's initial condition (or the lanes ``q1``, ``v1``);
    returns (model, trajectory, sim step)."""
    import numpy as np

    import contactimplicitmpc_tpu_torch as pt
    from contactimplicitmpc_tpu_torch.control.implicit_dynamics import (
        CONFIGURATION, default_mpc_ip_options)
    from contactimplicitmpc_tpu_torch.control.newton import NewtonOptions
    from contactimplicitmpc_tpu_torch.control.objective import \
        tracking_objective
    from contactimplicitmpc_tpu_torch.control.trajectory import (
        from_gait, initial_conditions)
    from contactimplicitmpc_tpu_torch.models import MODELS
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    gait, n_sample, h_mpc, kappa, q_w, u_w = RECIPES[model_name]
    model = MODELS[model_name]
    env = pt.flat_2d_lc if model_name == "hopper_2D" else pt.flat_3d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait(gait, "gait_forward"),
                    dtype=dtype, device=device)
    obj = tracking_objective(
        dims, h_mpc, q=np.tile(1e-1 * np.array(q_w), (h_mpc, 1)),
        u=np.tile(u_w, (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype, device=device)
    policy = pt.ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5,
                             fixed_ip_iters=fixed_ip_iters),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30),
        mpc_opts=pt.CIMPCOptions(altitude_update=True,
                                 altitude_impact_threshold=0.05))
    if q1 is None:
        q1, v1 = (x[None] for x in initial_conditions(ref))
    h_sim = float(ref.h) / n_sample
    traj = pt.simulate(model, pt.ENVIRONMENTS[sim_env_name], steps, h_sim,
                       q1, v1, policy=policy, opts=sim_options(dtype))
    return model, traj, h_sim


def sim_options(dtype):
    """The JAX example's sim options: its float32 ones, or the simulator's
    defaults in float64."""
    import torch

    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions

    if dtype == torch.float64:
        return None
    return IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                     undercut=float("inf"), max_ls=6)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", type=str, default="all")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--gif", type=str, default=None)
    args = ap.parse_args(argv)

    import torch

    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if args.f64 else torch.float32
    cases = {
        "sine": ("hopper_2D", "sine2_2D_lc"),
        "piecewise": ("hopper_2D", "piecewise1_2D_lc"),
        "sine3d": ("hopper_3D", "sine2_3D_lc"),
    }
    names = list(cases) if args.case == "all" else [args.case]
    last = None
    for name in names:
        (model, traj, h_sim), dt = timed(lambda: run_case(
            *cases[name], args.steps, dtype, device),
            device)
        q = traj.q[0].cpu().numpy()
        conv = traj.converged[0].float().mean()
        fwd = q[-1, 0] - q[1, 0]
        print(f"{name}: steps={args.steps} convergence={float(conv):.4f} "
              f"forward={fwd:+.2f} m ({dt:.1f}s first run) {tag}")
        last = (model, q)

    if args.gif and last is not None:
        model, q = last
        if q.shape[1] >= 7:
            from contactimplicitmpc_tpu_torch.utils.visuals import animate_3d
            animate_3d(model, q[::10], path=args.gif)
        else:
            from contactimplicitmpc_tpu_torch.utils.visuals import animate_2d
            animate_2d(model, q[::10], path=args.gif)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
