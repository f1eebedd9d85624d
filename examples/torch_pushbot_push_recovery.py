"""Pushbot push recovery on the PyTorch port: a pole between two walls,
batted by impulses, recovering upright under contact-implicit MPC (wall
contacts brace it) — the counterpart of examples/pushbot_push_recovery.py.

Mirror of the reference's ``examples/pushbot/push_recovery.jl``: N_sample=2,
H_mpc=40, κ=1e-4, zero reference (stay upright), the "fast recovery"
time-ramped velocity-tracking objective (push_recovery.jl:60-66), and the five
scripted impulses (push_recovery.jl:78-86). The knot solves run eight fixed
iterations, the card kernel's form (the JAX example's are adaptive).

Run: python examples/torch_pushbot_push_recovery.py [--steps 1000] [--cpu]
     [--f64]
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
        contact_trajectory, update_theta, update_z)
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models import pushbot as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if args.f64 else torch.float32
    env = pt.flat_2d_lc
    dims = pt.dims_of(model, env)

    # zero reference at the upright (push_recovery.jl:15-32)
    h = 0.04
    h_mpc, n_sample, kappa = 40, 2, 1.0e-4
    ref = contact_trajectory(dims, 100, h, dtype=dtype, device=device)
    ref.theta[:, dims.imu] = model.mu_world
    ref = update_theta(dims, update_z(dims, ref))

    # "fast recovery" weights, time-ramped toward the horizon end
    # (push_recovery.jl:60-66)
    t_ramp = np.arange(1, h_mpc + 1) / h_mpc
    obj = tracking_velocity_objective(
        dims, h_mpc,
        q=np.stack([12 * t_ramp ** 2, 12 * t_ramp ** 2], axis=1),
        v=np.tile(np.array([1.0, 0.01]) / h ** 2, (h_mpc, 1)),
        u=np.tile([100.0, 1.0], (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype, device=device)

    # hard real time in the reference: max_time = h/2 (push_recovery.jl:76);
    # the deterministic analog is the fixed iteration budget below
    policy = pt.ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION_FORCE,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=10,
                             fixed_ip_iters=8),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30))

    # scripted pushes (push_recovery.jl:78-86)
    idx = np.array([20, 220, 300, 500, 530])
    impulses = np.array([[-5.5, 0.0], [5.5, 0.0], [5.5, 0.0],
                         [-1.5, 0.0], [-6.5, 0.0]])
    dist = pt.impulse_disturbances(impulses.astype(
        np.float64 if args.f64 else np.float32), idx, device=device)

    sim_opts = None
    if not args.f64:
        sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                             undercut=float("inf"), max_ls=6)

    q1 = torch.zeros((1, 2), dtype=dtype, device=device)
    v1 = torch.zeros((1, 2), dtype=dtype, device=device)
    h_sim = h / n_sample

    def run():
        return pt.simulate(model, env, args.steps, h_sim, q1, v1,
                           policy=policy, disturbances=dist, opts=sim_opts)

    traj, first = timed(run, device)
    print(f"first run: {first:.1f}s {tag}")
    traj, wall = timed(run, device)

    ok = bool(pt.status(traj)[0])
    ang = traj.q[0, :, 0].cpu().numpy()
    print(f"sim converged: {ok}")
    print(f"max |angle|: {np.abs(ang).max():.3f} rad "
          f"(walls at ±0.35 reach); final |angle|: {abs(ang[-1]):.4f}")
    print(f"speed ratio: {args.steps * h_sim / wall:.2f}x real time {tag}")
    assert ok and abs(ang[-1]) < 0.05, "push recovery failed"


if __name__ == "__main__":
    main()
