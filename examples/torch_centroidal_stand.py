"""Centroidal quadruped standing under a lateral body push, on the PyTorch
port — the counterpart of examples/centroidal_stand.py.

Mirror of the reference's ``examples/centroidal_quadruped/
continuous_stand.jl`` (stand gait, H_mpc=10, N_sample=5, κ=2e-4; the open-loop
disturbance pushes the body sideways at one control period,
continuous_stand.jl:70-72). The knot solves run eight fixed iterations, the
card kernel's form (the JAX example's are adaptive).

Run: python examples/torch_centroidal_stand.py [--steps 320] [--f64]
     [--cpu] [--gif out.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=320)
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
        from_gait, initial_conditions)
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models import \
        centroidal_quadruped as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if args.f64 else torch.float32
    env = pt.flat_3d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("centroidal_quadruped", "stand_v0"),
                    update_friction=True, dtype=dtype, device=device)
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4
    h = float(ref.h)

    v_w = 1e-3 * np.concatenate([np.ones(3), 1e3 * np.ones(3), np.ones(12)])
    q_body = np.array([1e-2, 1e-2, 1.0]) + 4.0 * np.array([0.2, 0.2, 1.0])
    q_w = np.concatenate([q_body, 0.3 * np.ones(3),
                          np.tile([0.2, 0.2, 1.0], 4)])
    obj = tracking_velocity_objective(
        dims, h_mpc, q=q_w, v=v_w, u=3e-3 * np.ones(dims.nu), dtype=dtype,
        device=device)

    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=30,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    sim_opts = IPOptions(r_tol=(1e-8 if args.f64 else 1e-3),
                         kappa_tol=(1e-8 if args.f64 else 1e-5),
                         max_iter=(100 if args.f64 else 40),
                         undercut=float("inf"),
                         max_ls=(25 if args.f64 else 6))

    # continuous_stand.jl:70-72: [0, 5, 1] push at control period 10
    w = np.zeros((args.steps, 3))
    i0 = 10 * n_sample
    w[i0:i0 + n_sample] = np.array([0.0, 5.0, 1.0]) / n_sample

    q1, v1 = initial_conditions(ref)

    def run():
        return mpc_rollout(
            model, env, ref, obj, args.steps, h_mpc, n_sample, kappa,
            CONFIGURATION, q1[None], v1[None],
            n_opts=NewtonOptions(r_tol=3e-5, max_iter=5,
                                 fixed_ip_iters=8),
            ip_opts=mpc_ip, sim_opts=sim_opts, warm_start_floor=1e-2, w=w)

    out, first = timed(run, device)
    print(f"first run: {first:.1f}s {tag}")
    out, wall = timed(run, device)

    q = out.q[0]
    print(f"sim converged: {float(out.sim_converged.float().mean()):.3f}")
    print(f"body drift after push: y={float(q[-1, 1] - q[1, 1]):+.4f} m  "
          f"z={float(q[-1, 2] - q[1, 2]):+.4f} m")
    print(f"speed ratio: {args.steps * h / n_sample / wall:.2f}x real time "
          f"{tag}")

    if args.gif:
        from contactimplicitmpc_tpu_torch.utils.visuals import animate_3d
        animate_3d(model, q, env=env, path=args.gif)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
