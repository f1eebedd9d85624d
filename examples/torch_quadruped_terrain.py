"""Quadruped trotting over non-flat terrain with online terrain-height
discovery (altitude updates) on the PyTorch port — the counterpart of
examples/quadruped_terrain.py.

Mirror of the reference's ``examples/quadruped/piecewise.jl`` and ``sine.jl``:
the controller plans with the flat-ground gait while the simulation runs on the
piecewise slope / sine terrain; the altitude update injects the discovered
contact heights into the impact rows (mpc_utils.jl:109-135). The knot solves
run eight fixed iterations, the card kernel's form (the JAX example's are
adaptive).

Run: python examples/torch_quadruped_terrain.py [--terrain piecewise|sine]
     [--steps 1000] [--f64] [--cpu] [--gif out.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--terrain", choices=["piecewise", "sine"],
                    default="piecewise")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--f64", action="store_true")
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
        tracking_objective
    from contactimplicitmpc_tpu_torch.control.policy import CIMPCOptions
    from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
    from contactimplicitmpc_tpu_torch.control.trajectory import (
        from_gait, initial_conditions)
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models import quadruped as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if args.f64 else torch.float32
    env = (pt.piecewise1_2d_lc if args.terrain == "piecewise"
           else pt.sine2_2d_lc)
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=dtype, device=device)
    n_sample, h_mpc, kappa = 5, 10, 1.0e-4
    h = float(ref.h)

    # piecewise.jl:32-35
    qw = 1e-2 * np.array([5.0, 0.02, 0.10] + [0.25] * 8)
    obj = tracking_objective(
        dims, h_mpc, q=np.tile(qw, (h_mpc, 1)),
        u=3e-2 * np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype, device=device)

    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=100,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    sim_opts = IPOptions(r_tol=(1e-8 if args.f64 else 1e-3),
                         kappa_tol=(1e-8 if args.f64 else 1e-5),
                         max_iter=(100 if args.f64 else 40),
                         undercut=float("inf"),
                         max_ls=(25 if args.f64 else 6))

    q1, v1 = initial_conditions(ref)

    def run():
        return mpc_rollout(
            model, env, ref, obj, args.steps, h_mpc, n_sample, kappa,
            CONFIGURATION, q1[None], v1[None],
            n_opts=NewtonOptions(r_tol=3e-4, max_iter=5,
                                 fixed_ip_iters=8),
            ip_opts=mpc_ip, sim_opts=sim_opts, warm_start_floor=1e-2,
            mpc_opts=CIMPCOptions(altitude_update=True,
                                  altitude_impact_threshold=0.05))

    out, first = timed(run, device)
    print(f"first run: {first:.1f}s {tag}")
    out, wall = timed(run, device)

    q = out.q[0]
    print(f"sim converged: {float(out.sim_converged.float().mean()):.3f}")
    print(f"forward progress on {args.terrain}: "
          f"{float(q[-1, 0] - q[1, 0]):.3f} m over {args.steps} steps")
    print(f"speed ratio: {args.steps * h / n_sample / wall:.2f}x real time "
          f"{tag}")

    if args.gif:
        from contactimplicitmpc_tpu_torch.utils.visuals import animate_2d
        animate_2d(model, q, env=env, path=args.gif, every=10)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
