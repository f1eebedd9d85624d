"""Scaling report of the PyTorch port's Monte-Carlo sweep: MPC solves/s and
solves/s a GPU at 1 and N GPUs — the counterpart of tools/scaling_report.py.

The program is the JAX tool's: ``mpc_rollout`` of the flat-ground quadruped
(gait2, structure-mode Newton, H 10, N_sample 5, κ 2e-4, float32 adaptive
sim solves) split over the ranks of a mesh through
``parallel.make_sharded_mpc_rollouts`` (one process a GPU, the statistics
summed by one all-reduce), with fixed 8-iteration knot solves (the card
kernel's form). The lanes are the gait's initial state plus 0.01 · N(0, 1)
offsets (the joint ones scaled by 0.1) from ``numpy.random.default_rng(0)``,
the same batch at every leg.

Each leg runs this script under ``torchrun`` with ``--leg``: N processes,
one a GPU (``--cpu``: gloo ranks on the CPU), a warm run and ``--reps``
timed runs; rank 0 prints one JSON line. The report prints a markdown
table with the card's name and power limit and writes no file.

Run: python tools/torch_scaling_report.py [--n 4] [--batch 64] [--steps 100]
     [--reps 2] [--cpu]
"""

import argparse
import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_leg(batch, steps, reps, cpu):
    """This process's rank of one leg: (solves/s, success rate, ranks) on
    rank 0, None elsewhere."""
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
    from contactimplicitmpc_tpu_torch.device import resolve_device, timed
    from contactimplicitmpc_tpu_torch.models import quadruped as model
    from contactimplicitmpc_tpu_torch.parallel import (
        distributed, make_mesh, make_sharded_mpc_rollouts)
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    device = resolve_device("cpu" if cpu else None)
    distributed.initialize(device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        mesh = make_mesh(device=device)
        dtype = torch.float32
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
        sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                             undercut=float("inf"), max_ls=6)
        mpc_ip = IPOptions(r_tol=1e-5, kappa_tol=kappa, max_iter=30,
                           undercut=5.0, gamma_reg=0.1, diff_sol=True,
                           max_ls=3)

        def rollout(q, v):
            return mpc_rollout(model, env, ref, obj, steps, h_mpc, n_sample,
                               kappa, CONFIGURATION, q, v,
                               n_opts=NewtonOptions(r_tol=3e-4, max_iter=5,
                                                    fixed_ip_iters=8),
                               ip_opts=mpc_ip, sim_opts=sim_opts,
                               warm_start_floor=1e-2, newton_mode="structure",
                               structure_full_warm=False)

        run = make_sharded_mpc_rollouts(mesh, rollout, ref, n_sample)
        q1, v1 = initial_conditions(ref)
        off = 0.01 * np.random.default_rng(0).standard_normal(
            (batch, dims.nq))
        off[:, 2:] *= 0.1
        q1s = q1[None, :] + torch.as_tensor(off, dtype=dtype, device=device)
        v1s = v1.expand(batch, dims.nq).contiguous()

        timed(lambda: run(q1s, v1s), device)
        dt = 0.0
        for _ in range(reps):
            (_, stats), wall = timed(lambda: run(q1s, v1s), device)
            dt += wall / reps
        solves = batch * (steps // n_sample)
        if dist.get_rank() == 0:
            return solves / dt, float(stats.success_rate), mesh.size()
        return None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def leg(n, args):
    """Run one leg of ``n`` processes under torchrun on a free local port;
    its rank 0's JSON."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", str(n), "--master-addr", "127.0.0.1",
           "--master-port", str(port),
           os.path.abspath(__file__), "--leg", "--batch", str(args.batch),
           "--steps", str(args.steps), "--reps", str(args.reps)]
    if args.cpu:
        cmd.append("--cpu")
    env = {k: v for k, v in os.environ.items() if k not in (
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    # torchrun gives each of several processes one host thread; the leg of
    # one gets the same, so the legs compare like for like
    env.setdefault("OMP_NUM_THREADS", "1")
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=args.timeout)
    if out.returncode != 0:
        raise RuntimeError(f"the {n}-process leg failed:\n{out.stdout}\n"
                           f"{out.stderr[-4000:]}")
    return json.loads(next(line for line in out.stdout.splitlines()
                           if line.startswith('{"leg"')))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--timeout", type=float, default=3000.0)
    ap.add_argument("--leg", action="store_true",
                    help="run as one rank of a leg (under torchrun)")
    args = ap.parse_args(argv)

    if args.leg:
        got = run_leg(args.batch, args.steps, args.reps, args.cpu)
        if got is not None:
            sps, ok, ranks = got
            print(json.dumps({"leg": ranks, "solves_per_s": sps,
                              "success": ok}), flush=True)
        return None

    from contactimplicitmpc_tpu_torch.device import describe, resolve_device

    tag = describe(resolve_device("cpu" if args.cpu else None))
    legs = {}
    for n in sorted({1, args.n}):
        legs[n] = leg(n, args)
        print(f"devices={n}: {legs[n]['solves_per_s']:.2f} solves/s "
              f"({legs[n]['solves_per_s'] / n:.2f}/device), success="
              f"{legs[n]['success']:.3f} [{tag}]", flush=True)
    one = legs[1]["solves_per_s"]
    kind = "CPU processes (gloo)" if args.cpu else "GPUs"
    lines = [
        f"Scaling of `make_sharded_mpc_rollouts` (quadruped, structure "
        f"mode, fixed 8-iteration knot solves, batch {args.batch}, "
        f"{args.steps} sim steps, float32) on {kind}, {tag}:",
        "",
        "| devices | solves/s | solves/s/device | parallel efficiency | "
        "success |",
        "|---|---|---|---|---|"]
    for n, r in legs.items():
        sps = r["solves_per_s"]
        lines.append(f"| {n} | {sps:.2f} | {sps / n:.2f} | "
                     f"{sps / (one * n):.2f} | {r['success']:.3f} |")
    print("\n".join(lines))
    return legs


if __name__ == "__main__":
    main()
