"""Quadruped trot with an unmodeled 3 kg payload on the PyTorch port: the
simulator runs the loaded model while the controller plans with the nominal
one — the counterpart of examples/quadruped_payload.py.

Mirror of the reference's ``examples/quadruped/payload.jl`` (controller from
``s_no_load``, simulator from the payload simulation; N_sample=5, H_mpc=10,
κ=1e-4, altitude updates on). The knot solves run eight fixed iterations, the
card kernel's form (the JAX example's are adaptive).

Run: python examples/torch_quadruped_payload.py [--steps 2100] [--f64]
     [--cpu] [--gif out.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2100)
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
        from_gait, initial_conditions, tracking_error)
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models import (quadruped,
                                                     quadruped_payload)
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if args.f64 else torch.float32
    env = pt.flat_2d_lc
    dims = pt.dims_of(quadruped, env)
    ref = from_gait(quadruped, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=dtype, device=device)
    n_sample, h_mpc, kappa = 5, 10, 1.0e-4
    h = float(ref.h)

    # payload.jl:36-40
    qw = 1e-2 * np.array([10.0, 0.02, 0.25] + [0.5] * 8)
    obj = tracking_objective(
        dims, h_mpc, q=np.tile(qw, (h_mpc, 1)),
        u=3e-2 * np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype, device=device)

    sim_opts = None
    if not args.f64:
        sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                             undercut=float("inf"), max_ls=6)

    q1, v1 = initial_conditions(ref)

    def run():
        return mpc_rollout(
            quadruped, env, ref, obj, args.steps, h_mpc, n_sample, kappa,
            CONFIGURATION, q1[None], v1[None],
            n_opts=NewtonOptions(r_tol=3e-4, max_iter=5,
                                 fixed_ip_iters=8),
            sim_opts=sim_opts, warm_start_floor=1e-2,
            mpc_opts=CIMPCOptions(altitude_update=True,
                                  altitude_impact_threshold=0.05),
            sim_model=quadruped_payload)

    out, first = timed(run, device)
    print(f"first run: {first:.1f}s {tag}")
    out, wall = timed(run, device)

    qe, ue, ge, be = tracking_error(ref, out.q[0], out.u[0], out.gamma[0],
                                    out.b[0], n_sample, idx_shift=(0,))
    print(f"sim converged: {float(out.sim_converged.float().mean()):.3f}")
    print(f"tracking under 3 kg payload: q={qe:.4f} u={ue:.4f}")
    print(f"speed ratio: {args.steps * h / n_sample / wall:.2f}x real time "
          f"{tag}")

    if args.gif:
        from contactimplicitmpc_tpu_torch.utils.visuals import animate_2d
        animate_2d(quadruped, out.q[0], path=args.gif, every=10)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
