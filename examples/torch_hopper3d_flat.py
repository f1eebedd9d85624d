"""3D hopper (MRP orientation) hopping forward under CIMPC on flat ground,
on the PyTorch port — the counterpart of examples/hopper3d_flat.py.

Mirror of the reference's ``examples/hopper/3D_flat.jl``: gait_forward,
N_sample=10, H_mpc=20, κ=1e-4, configuration mode, altitude updates,
``simulate`` driven by ``ci_mpc_policy``. Float64 on the CPU, as the JAX
example; float32 on the card (the knot kernel's type), with float32 sim
tolerances (r_tol 1e-3, κ_tol 1e-5, 40 iterations). The knot solves run eight
fixed iterations, the card kernel's form (the JAX example's are adaptive).

Run: python examples/torch_hopper3d_flat.py [--steps 1200] [--cpu]
     [--gif out.gif]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
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
    from contactimplicitmpc_tpu_torch.control.trajectory import (
        from_gait, initial_conditions, tracking_error)
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models import hopper_3d as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    tk = dict(dtype=dtype, device=device)
    env = pt.flat_3d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("hopper_3D", "gait_forward"),
                    kappa=1e-4, **tk)
    n_sample, h_mpc, kappa_mpc = 10, 20, 1.0e-4
    h = float(ref.h)

    # 3D_flat.jl:38-42
    obj = tracking_objective(
        dims, h_mpc,
        q=np.tile(1e-1 * np.array([3, 3, 0.1, 50, 50, 50, 10]),
                  (h_mpc, 1)),
        u=np.tile(np.array([0.1, 0.1, 10.0]), (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), **tk)

    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa_mpc, max_iter=100,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True)
    policy = pt.ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa_mpc, mode=CONFIGURATION,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5,
                             fixed_ip_iters=8),
        ip_opts=mpc_ip,
        mpc_opts=pt.CIMPCOptions(altitude_update=True,
                                 altitude_impact_threshold=0.05))

    q1, v1 = initial_conditions(ref)
    # the sim path needs RoboDojo's ϵ_min=0.25 floor (simulator.jl:30) or
    # the IP stalls just above κ_tol at liftoff
    sim_opts = dataclasses.replace(pt.default_sim_options(), eps_min=0.25)
    if dtype == torch.float32:
        sim_opts = dataclasses.replace(sim_opts, r_tol=1e-3, kappa_tol=1e-5,
                                       max_iter=40)

    def run():
        return pt.simulate(model, env, args.steps, h / n_sample, q1[None],
                           v1[None], policy=policy, opts=sim_opts)

    traj, dt = timed(run, device)
    traj, warm = timed(run, device)

    qerr, uerr, gerr, berr = tracking_error(
        ref, traj.q[0], traj.u[0], traj.gamma[0], traj.b[0], n_sample,
        idx_shift=(0,))
    q = traj.q[0]
    print(f"status={bool(pt.status(traj)[0])} "
          f"tracking: q={qerr:.4f} u={uerr:.4f} γ={gerr:.4f} b={berr:.4f}")
    print(f"x: {float(q[1, 0]):+.3f} -> {float(q[-1, 0]):+.3f} m")
    print(f"first run {dt:.1f}s, warm {warm:.1f}s, "
          f"speed ratio {args.steps * h / n_sample / warm:.3f}x realtime, "
          f"{str(dtype).removeprefix('torch.')} {tag}")

    if args.gif:
        from contactimplicitmpc_tpu_torch.utils.visuals import animate_3d
        animate_3d(model, q[::10], env=env, path=args.gif)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
