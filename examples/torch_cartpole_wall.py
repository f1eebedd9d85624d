"""Walled cartpole on the PyTorch port: stabilization where the pole tip can
brace against compliant walls; scripted cart impulses perturb it — the
counterpart of examples/cartpole_wall.py.

Mirror of the reference's ``examples/cartpole/cartpole.jl``: zero upright
reference, N_sample=2, H_mpc=10, κ=2e-4, terminal-weighted velocity objective
(cartpole.jl:45-50), five cart impulses (cartpole.jl:63-70), ``simulate``
driven by ``ci_mpc_policy`` in configuration-force mode. The knot solves run
eight fixed iterations, the card kernel's form (the JAX example's are
adaptive).

Run: python examples/torch_cartpole_wall.py [--steps 1000] [--cpu] [--f64]
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
    from contactimplicitmpc_tpu_torch.models import walledcartpole as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dtype = torch.float64 if args.f64 else torch.float32
    env = pt.flat_2d_lc
    dims = pt.dims_of(model, env)

    h = 0.04  # cartpole.jl:20
    h_mpc, n_sample, kappa = 10, 2, 2.0e-4
    ref = contact_trajectory(dims, 100, h, dtype=dtype, device=device)
    ref.theta[:, dims.imu] = model.mu_world
    ref = update_theta(dims, update_z(dims, ref))

    # cartpole.jl:45-50 — running weights with a 10× terminal knot
    q_w = np.tile([1e-1, 1e-3, 1e-8, 1e-8], (h_mpc, 1))
    q_w[-1] = [1e-0, 1e-1, 1e-8, 1e-8]
    v_w = np.tile([1e-0, 3e+1, 1e-8, 1e-8], (h_mpc, 1))
    v_w[-1] = [3e-1, 1e-1, 1e-8, 1e-8]
    obj = tracking_velocity_objective(
        dims, h_mpc, q=q_w, v=v_w, u=3e-2 * np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype, device=device)

    policy = pt.ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION_FORCE,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=10,
                             fixed_ip_iters=8),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30))

    # cartpole.jl:63-70 — cart impulses
    idx = np.array([20, 220, 370, 570, 720])
    impulses = np.zeros((5, dims.nw))
    impulses[:, 0] = [0.2, 0.2, -0.2, 0.2, 0.2]
    dist = pt.impulse_disturbances(impulses.astype(
        np.float64 if args.f64 else np.float32), idx, device=device)

    sim_opts = None
    if not args.f64:
        sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                             undercut=float("inf"), max_ls=6)

    q1 = torch.zeros((1, 4), dtype=dtype, device=device)
    v1 = torch.zeros((1, 4), dtype=dtype, device=device)
    h_sim = h / n_sample

    def run():
        return pt.simulate(model, env, args.steps, h_sim, q1, v1,
                           policy=policy, disturbances=dist, opts=sim_opts)

    traj, first = timed(run, device)
    print(f"first run: {first:.1f}s {tag}")
    traj, wall = timed(run, device)

    ok = bool(pt.status(traj)[0])
    q = traj.q[0].cpu().numpy()
    print(f"sim converged: {ok}")
    print(f"max |cart x|: {np.abs(q[:, 0]).max():.3f} m; "
          f"max |pole angle|: {np.abs(q[:, 1]).max():.3f} rad; "
          f"final state: {q[-1].round(4)}")
    print(f"speed ratio: {args.steps * h_sim / wall:.2f}x real time {tag}")
    assert ok and abs(q[-1][1]) < 0.1, "cartpole stabilization failed"


if __name__ == "__main__":
    main()
