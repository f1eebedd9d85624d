"""Monte-Carlo robustness study on the PyTorch port: hopper MPC from randomized
initial offsets, every run a lane of one batched rollout — the counterpart of
examples/hopper_monte_carlo.py (the reference's
``examples/hopper/monte_carlo.jl``, 100 serial runs of 1000+ steps). The knot
solves run eight fixed iterations, the card kernel's form (the JAX example's
are adaptive).

Run: python examples/torch_hopper_monte_carlo.py [--runs 100]
     [--steps 1000] [--offset 0.05] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=100)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--offset", type=float, default=0.05)
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
        from_gait, initial_conditions)
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models.hopper_2d import \
        hopper_2d as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float32
    env = pt.flat_2d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("hopper_2D", "gait_in_place"),
                    kappa=1e-4, dtype=dtype, device=device)
    n_sample, h_mpc, kappa = 5, 10, 1.0e-4

    # monte_carlo.jl:33-38 weights
    qw = np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    qw[-2:] = 1e-1 * np.array([0.1, 3, 1, 3])
    vw = np.tile(1e-3 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    vw[:2] = 1e1 * np.array([0.1, 3, 1, 3])
    obj = tracking_velocity_objective(
        dims, h_mpc, q=qw, v=vw,
        u=np.tile([3e-3, 1e0], (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, 1)),
        b=1e-100 * np.ones((h_mpc, 2)), dtype=dtype, device=device)

    sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                         undercut=float("inf"), max_ls=6)

    q1, v1 = initial_conditions(ref)
    gen = torch.Generator(device=device).manual_seed(100)  # monte_carlo.jl:80
    offsets = args.offset * (2.0 * torch.rand(
        (args.runs, dims.nq), generator=gen, dtype=dtype, device=device) - 1.0)
    q1s = q1[None, :] + offsets
    v1s = v1.expand(args.runs, dims.nq).contiguous()

    def run():
        return mpc_rollout(
            model, env, ref, obj, args.steps, h_mpc, n_sample, kappa,
            CONFIGURATION, q1s, v1s,
            n_opts=NewtonOptions(r_tol=3e-4, max_iter=5,
                                 fixed_ip_iters=8),
            sim_opts=sim_opts)

    out, first = timed(run, device)
    print(f"first run: {first:.1f}s {tag}")
    out, wall = timed(run, device)

    ok = out.sim_converged.all(dim=1).float()
    alive = ((out.q[:, -1, 1] - 0.5).abs() < 0.5).float()
    print(f"{args.runs} runs x {args.steps} steps in {wall:.1f}s "
          f"({args.runs * args.steps / wall:.0f} sim steps/s) {tag}")
    print(f"solver success rate: {float(ok.mean()):.2f}   "
          f"hopping at end: {float(alive.mean()):.2f}")


if __name__ == "__main__":
    main()
