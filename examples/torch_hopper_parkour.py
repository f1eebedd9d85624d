"""Hopper parkour on the PyTorch port: climb a staircase by tracking a
stair-hopping reference, with the MPC linearized about a *flat-ground*
model and online altitude updates discovering each step height at impact
— the counterpart of examples/hopper_parkour.py.

Mirror of the reference's ``examples/hopper/parkour.jl`` (stairs phase):
hopper_stair_ref gait, N_sample=10, H_mpc=10, κ=2e-4, altitude_update=true with
threshold 0.1 (parkour.jl:33-41), and the custom x+z stride (parkour.jl:11-15).
``--steps`` (default the JAX example's fixed 2400) cuts the run. The knot
solves run eight fixed iterations, the card kernel's form (the JAX example's
are adaptive).

Run: python examples/torch_hopper_parkour.py [--cpu] [--f64] [--steps 2400]
     [--gif out.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=240 * 10)
    ap.add_argument("--gif", type=str, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import contactimplicitmpc_tpu_torch as pt
    from contactimplicitmpc_tpu_torch.control.implicit_dynamics import (
        CONFIGURATION_FORCE, default_mpc_ip_options)
    from contactimplicitmpc_tpu_torch.control.newton import NewtonOptions
    from contactimplicitmpc_tpu_torch.control.objective import \
        tracking_velocity_objective
    from contactimplicitmpc_tpu_torch.control.trajectory import (
        from_gait, initial_conditions)
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models import hopper_2d as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if args.f64 else torch.float32
    env = pt.flat_2d_lc          # MPC model: flat ground + altitude offsets
    sim_env = pt.ENVIRONMENTS["stairs3_2D_lc"]  # hard 4-step staircase
    dims = pt.dims_of(model, env)

    ref = from_gait(model, env, load_gait("hopper_2D", "hopper_stair_ref"),
                    dtype=dtype, device=device)
    n_sample, h_mpc, kappa = 10, 10, 2.0e-4
    h = float(ref.h)

    # parkour.jl:43-48: front-loaded q weights, light tail
    q_w = np.concatenate([
        np.tile(1e-0 * np.array([1e1, 1e-1, 1.0, 1.0]), (h_mpc - 5, 1)),
        np.tile(1e-1 * np.array([1.0, 1e-1, 1e1, 0.1]), (5, 1))])
    obj = tracking_velocity_objective(
        dims, h_mpc,
        v=np.tile(1e-3 * np.array([1e-2, 1, 1, 10]), (h_mpc, 1)),
        q=q_w, u=np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype, device=device)

    policy = pt.ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION_FORCE,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5,
                             fixed_ip_iters=8),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30),
        mpc_opts=pt.CIMPCOptions(altitude_update=True,
                                 altitude_impact_threshold=0.1),
        stride_idx=(0, 1))  # stride x AND z up the stairs (parkour.jl:11-15)

    sim_opts = None
    if not args.f64:
        sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                             undercut=float("inf"), max_ls=6)

    q1, v1 = initial_conditions(ref)
    traj, dt = timed(lambda: pt.simulate(
        model, sim_env, args.steps, h / n_sample, q1[None], v1[None],
        policy=policy, opts=sim_opts), device)
    print(f"first run: {dt:.1f}s {tag}")

    ok = float(traj.converged.float().mean())
    x_final, z_final = float(traj.q[0, -1, 0]), float(traj.q[0, -1, 1])
    print(f"sim converged: {ok:.3f}")
    print(f"hopper reached x={x_final:.2f} m, z={z_final:.2f} m "
          f"(staircase top: z=0.75 at x in [0.625, 0.875])")

    if args.gif:
        from contactimplicitmpc_tpu_torch.utils.visuals import animate_2d
        animate_2d(model, traj.q[0], path=args.gif, every=20)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
