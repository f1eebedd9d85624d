"""Centroidal quadruped (18-DoF, 3D) under contact-implicit MPC on the
PyTorch port: in-place trot or stand on flat ground — the counterpart of
examples/centroidal_trot.py.

Mirror of the reference's ``examples/centroidal_quadruped/flat_trot.jl``
(N_sample=5, H_mpc=10, κ=2e-4, velocity-tracking objective with the relative
body/feet weights of flat_trot.jl:38-42, diagonalized) and
``continuous_stand.jl`` (--gait stand_v0). The knot solves run eight fixed
iterations, the card kernel's form (the JAX example's are adaptive).

Run: python examples/torch_centroidal_trot.py [--steps 500]
     [--gait inplace_trot_v2] [--f64] [--cpu]
     [--gif out.gif] [--mesh-gif mesh.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--gait", type=str, default="inplace_trot_v2")
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
    from contactimplicitmpc_tpu_torch.models import \
        centroidal_quadruped as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if args.f64 else torch.float32
    env = pt.flat_3d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("centroidal_quadruped", args.gait),
                    update_friction=True, dtype=dtype, device=device)
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4
    h = float(ref.h)

    # flat_trot.jl:38-42, diagonal form of relative_state_cost
    v_w = 1e-3 * np.concatenate([np.ones(3), 1e3 * np.ones(3), np.ones(12)])
    q_body = np.array([1e-2, 1e-2, 1.0]) + 4.0 * np.array([0.2, 0.2, 1.0])
    q_w = np.concatenate([q_body, 0.3 * np.ones(3),
                          np.tile([0.2, 0.2, 1.0], 4)])
    obj = tracking_velocity_objective(
        dims, h_mpc, q=q_w, v=v_w, u=3e-3 * np.ones(dims.nu), dtype=dtype,
        device=device)

    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=30,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3,
                       refine=0 if args.f64 else 1)
    sim_opts = IPOptions(r_tol=(1e-8 if args.f64 else 1e-3),
                         kappa_tol=(1e-8 if args.f64 else 1e-5),
                         max_iter=(100 if args.f64 else 40),
                         undercut=float("inf"),
                         max_ls=(25 if args.f64 else 6),
                         refine=0 if args.f64 else 1)

    q1, v1 = initial_conditions(ref)

    def run():
        return mpc_rollout(
            model, env, ref, obj, args.steps, h_mpc, n_sample, kappa,
            CONFIGURATION, q1[None], v1[None],
            n_opts=NewtonOptions(r_tol=3e-5, max_iter=5,
                                 fixed_ip_iters=8),
            ip_opts=mpc_ip, sim_opts=sim_opts, warm_start_floor=1e-2)

    out, first = timed(run, device)
    print(f"first run: {first:.1f}s {tag}")
    out, wall = timed(run, device)

    speed_ratio = args.steps * (h / n_sample) / wall
    qe, ue, ge, be = tracking_error(ref, out.q[0], out.u[0], out.gamma[0],
                                    out.b[0], n_sample)
    print(f"sim converged: {float(out.sim_converged.float().mean()):.3f}")
    print(f"tracking: q={qe:.4f} u={ue:.4f} γ={ge:.4f} b={be:.4f}")
    print(f"newton iters/ctrl: "
          f"{float(out.newton_iterations.float().mean()):.2f}  "
          f"ip iters/step: {float(out.sim_iterations.float().mean()):.2f}")
    print(f"speed ratio: {speed_ratio:.2f}x real time {tag}")

    if args.gif:
        from contactimplicitmpc_tpu_torch.utils.visuals import animate_3d
        animate_3d(model, out.q[0], env=env, path=args.gif, every=10)
        print(f"wrote {args.gif}")

    if args.mesh_gif:
        from contactimplicitmpc_tpu_torch.utils.meshes import animate_mesh_3d
        animate_mesh_3d(model, out.q[0], path=args.mesh_gif, every=10)
        print(f"wrote {args.mesh_gif}")


if __name__ == "__main__":
    main()
