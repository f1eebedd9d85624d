"""Quadruped trotting on flat ground under contact-implicit MPC on the
PyTorch port — the counterpart of examples/quadruped_flat.py.

Mirror of the reference's ``examples/quadruped/flat.jl``: N_sample=5, H_mpc=10,
κ=2e-4, velocity-tracking objective, through the general ``mpc_rollout``
(direct-mode Newton). Reports the policy speed ratio (≥1 ⇒ faster than real
time) after a warm re-run (flat.jl:77-79). The knot solves run eight fixed
iterations, the card kernel's form (the JAX example's are adaptive).

Run: python examples/torch_quadruped_flat.py [--steps 1500] [--f64] [--cpu]
     [--gif out.gif] [--mesh-gif mesh.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--gif", type=str, default=None)
    ap.add_argument("--mesh-gif", type=str, default=None,
                    help="mesh-style (filled body geometry) animation")
    ap.add_argument("--cpu", action="store_true")
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
    from contactimplicitmpc_tpu_torch.models import quadruped as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if args.f64 else torch.float32
    env = pt.flat_2d_lc
    dims = pt.dims_of(model, env)

    # the shipped regression gait (gait2), so results compare with the CI
    # thresholds
    ref = from_gait(model, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=dtype, device=device)
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4
    h = float(ref.h)

    obj = tracking_velocity_objective(
        dims, h_mpc,
        q=np.tile(1e-2 * np.array([1.0, 0.02, 0.25] + [0.25] * 8),
                  (h_mpc, 1)),
        u=3e-3 * np.ones((h_mpc, dims.nu)),
        v=1e-5 * np.ones((h_mpc, dims.nq)),
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
    speed_ratio = args.steps * h_sim / wall
    qe, ue, ge, be = tracking_error(ref, out.q[0], out.u[0], out.gamma[0],
                                    out.b[0], n_sample, idx_shift=(0,))
    print(f"sim converged: {float(out.sim_converged.float().mean()):.3f}")
    print(f"tracking: q={qe:.4f} u={ue:.4f} γ={ge:.4f} b={be:.4f}")
    print(f"speed ratio: {speed_ratio:.2f}x real time "
          f"({args.steps / wall:.0f} sim steps/s) {tag}")

    if args.gif:
        from contactimplicitmpc_tpu_torch.utils.visuals import animate_2d
        animate_2d(model, out.q[0], path=args.gif, every=10)
        print(f"wrote {args.gif}")

    if args.mesh_gif:
        from contactimplicitmpc_tpu_torch.utils.meshes import animate_mesh_2d
        animate_mesh_2d(model, out.q[0], path=args.mesh_gif, every=10)
        print(f"wrote {args.mesh_gif}")


if __name__ == "__main__":
    main()
