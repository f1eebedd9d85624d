"""Monte-Carlo robustness sweep of the flat-ground quadruped CIMPC on the
PyTorch port — the counterpart of examples/quadruped_monte_carlo.py (the
reference's serial loop, ``examples/quadruped/monte_carlo.jl`` /
``examples/hopper/monte_carlo.jl:78-91``): the lanes, uniformly offset
standing poses, are split over the ranks of a mesh (one process a GPU);
each rank rolls its lanes as one batch and the sweep statistics sum across
the ranks with one all-reduce. The knot solves are fixed-iteration ones:
8, the card kernel's form (the JAX example's are adaptive).

Run: python examples/torch_quadruped_monte_carlo.py [--n 128] [--steps 500]
     [--png runs.png] [--f64] [--cpu]
     torchrun --nproc-per-node N examples/torch_quadruped_monte_carlo.py
     --lanes 128 ...  (N GPUs; --cpu runs on the CPU, a single process or
     gloo ranks; --png needs matplotlib)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    # --lanes: torchrun takes a leading --n for one of its own options
    ap.add_argument("--n", "--lanes", type=int, default=128)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--png", type=str, default=None,
                    help="write a visualize_runs!-style overlay figure")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    import contactimplicitmpc_tpu_torch as pt
    from contactimplicitmpc_tpu_torch.control.implicit_dynamics import \
        CONFIGURATION
    from contactimplicitmpc_tpu_torch.control.newton import NewtonOptions
    from contactimplicitmpc_tpu_torch.control.objective import \
        tracking_objective
    from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
    from contactimplicitmpc_tpu_torch.control.trajectory import (
        from_gait, initial_conditions)
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models.quadruped import (
        initial_configuration, quadruped as model)
    from contactimplicitmpc_tpu_torch.parallel import (
        distributed, make_mesh, make_sharded_mpc_rollouts)
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if args.cpu else None)
    distributed.initialize(device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        mesh = make_mesh(device=device)
        lead = dist.get_rank() == 0   # every rank holds the statistics
        tag = f"[{describe(device)}]"
        dtype = torch.float64 if args.f64 else torch.float32
        env = pt.flat_2d_lc
        dims = pt.dims_of(model, env)
        ref = from_gait(model, env, load_gait("quadruped", "gait2"),
                        update_friction=True, dtype=dtype, device=device)
        n_sample, h_mpc, kappa = 5, 10, 2.0e-4

        qw = 1e-2 * np.array([1.0, 0.02, 0.25] + [0.25] * 8)
        obj = tracking_objective(
            dims, h_mpc, q=np.tile(qw, (h_mpc, 1)),
            u=3e-2 * np.ones((h_mpc, dims.nu)),
            gamma=1e-100 * np.ones((h_mpc, dims.nc)),
            b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype, device=device)
        sim_opts = IPOptions(r_tol=(1e-8 if args.f64 else 1e-3),
                             kappa_tol=(1e-8 if args.f64 else 1e-5),
                             max_iter=(100 if args.f64 else 40),
                             undercut=float("inf"),
                             max_ls=(25 if args.f64 else 6))

        def rollout(q, v):
            return mpc_rollout(model, env, ref, obj, args.steps, h_mpc,
                               n_sample, kappa, CONFIGURATION, q, v,
                               n_opts=NewtonOptions(r_tol=3e-4, max_iter=5,
                                                    fixed_ip_iters=8),
                               sim_opts=sim_opts, warm_start_floor=1e-2,
                               newton_mode="structure",
                               structure_full_warm=False)

        ranks = mesh.size()
        n = (args.n // ranks) * ranks
        run = make_sharded_mpc_rollouts(mesh, rollout, ref, n_sample)

        # the reference study's distribution: kinematically-consistent
        # standing poses from leg-angle/pose ranges (monte_carlo.jl:80-89
        # via initial_configuration :94-116), the gait's velocity; every
        # rank draws the same batch from one seed
        q1, v1 = initial_conditions(ref)
        gen = torch.Generator(device=device).manual_seed(0)
        cmin = torch.tensor([0.0, 0.6, 0.6, 0.6, -0.2, -0.3], dtype=dtype,
                            device=device)
        cmax = torch.tensor([0.05, 0.8, 0.8, 0.8, 0.2, 0.1], dtype=dtype,
                            device=device)
        conf = cmin + (cmax - cmin) * torch.rand(
            (n, 6), generator=gen, dtype=dtype, device=device)
        conf[:, 5] = torch.clamp(conf[:, 5], min=0.0)
        q1s = initial_configuration(model, *conf.T)
        q1s[0] = q1
        v1s = v1.expand(n, dims.nq).contiguous()

        (traj, stats), first = timed(lambda: run(q1s, v1s), device)
        say = print if lead else (lambda *_: None)
        say(f"first run: {first:.1f}s ({ranks} device(s), mesh "
              f"{tuple(mesh.shape)}) {tag}")
        (traj, stats), wall = timed(lambda: run(q1s, v1s), device)

        solves = n * (args.steps // n_sample)
        say(f"runs: {int(float(stats.n_rollouts))}  "
              f"success rate: {float(stats.success_rate):.3f}")
        say(f"tracking over successful runs: q={float(stats.q_err):.4f} "
              f"u={float(stats.u_err):.4f}")
        say(f"throughput: {solves / wall:.1f} MPC solves/s "
              f"({solves / wall / ranks:.1f} per device) {tag}")

        if args.png and lead:
            from contactimplicitmpc_tpu_torch.utils.visuals import \
                plot_runs_2d
            plot_runs_2d(model, traj.q[:16], env=env, path=args.png,
                         stride=max(1, args.steps // 8))
            print(f"wrote {args.png}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
