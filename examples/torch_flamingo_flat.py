"""Flamingo 9-DoF biped walking on flat ground under contact-implicit MPC on
the PyTorch port — the counterpart of examples/flamingo_flat.py.

Mirror of the reference's ``examples/flamingo/flat.jl``: gait_forward_36_4,
N_sample=5, H_mpc=15, κ=2e-4, velocity-tracking objective (flat.jl:31-36),
through ``mpc_rollout`` with every lane's knot solves batched. The knot solves
run eight fixed iterations, the card kernel's form (the JAX example's are
adaptive).

Run: python examples/torch_flamingo_flat.py [--steps 1000] [--cpu] [--f64]
     [--gif out.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
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
        tracking_velocity_objective
    from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
    from contactimplicitmpc_tpu_torch.control.trajectory import (
        from_gait, initial_conditions, tracking_error)
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models import flamingo as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if args.f64 else torch.float32
    env = pt.flat_2d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("flamingo", "gait_forward_36_4"),
                    dtype=dtype, device=device)
    n_sample, h_mpc, kappa = 5, 15, 2.0e-4
    h = float(ref.h)

    # flat.jl:31-36
    obj = tracking_velocity_objective(
        dims, h_mpc,
        v=np.tile(1e-3 * np.array([1e0, 1, 1e4, 1, 1, 1, 1, 1e4, 1e4]),
                  (h_mpc, 1)),
        q=np.tile(1e-1 * np.array([3e2, 1e-6, 3e2, 1, 1, 1, 1, 0.1, 0.1]),
                  (h_mpc, 1)),
        u=np.tile(3e-1 * np.array([0.1, 0.1, 0.3, 0.3, 1.0, 1.0]),
                  (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype, device=device)

    sim_opts = None
    if not args.f64:
        sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                             undercut=float("inf"), max_ls=6)

    q1, v1 = initial_conditions(ref)

    def run():
        return mpc_rollout(
            model, env, ref, obj, args.steps, h_mpc, n_sample, kappa,
            CONFIGURATION, q1[None], v1[None],
            n_opts=NewtonOptions(r_tol=3e-4, max_iter=5,
                                 fixed_ip_iters=8),
            sim_opts=sim_opts)

    out, first = timed(run, device)
    print(f"first run: {first:.1f}s {tag}")
    out, wall = timed(run, device)

    h_sim = h / n_sample
    q = out.q[0]
    qe, ue, ge, be = tracking_error(ref, q, out.u[0], out.gamma[0], out.b[0],
                                    n_sample, idx_shift=(0,))
    print(f"sim converged: {float(out.sim_converged.float().mean()):.3f}")
    print(f"tracking: q={qe:.4f} u={ue:.4f} γ={ge:.4f} b={be:.4f}")
    print(f"walked {float(q[-1, 0] - q[1, 0]):.2f} m in "
          f"{args.steps * h_sim:.1f} s")
    print(f"speed ratio: {args.steps * h_sim / wall:.2f}x real time {tag}")

    if args.gif:
        from contactimplicitmpc_tpu_torch.utils.visuals import animate_2d
        animate_2d(model, q, path=args.gif, every=10)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
