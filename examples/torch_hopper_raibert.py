"""Raibert heuristic hopping baseline on the 2D hopper, on the PyTorch port —
the classical policy the CIMPC paper compares against; the counterpart of
examples/hopper_raibert.py.

Mirror of the reference's ``examples/raibert/flat_raibert.jl``: flat
ground, h_sim = 0.02, start at q_ref = [0, 0.5, 0, 0.5], commanded forward
velocity v0. A batched variant sweeps several v0 commands as the lanes of
one rollout (the requested v0 rides along as lane 0), each lane under its
own command. Float64, the reference's tolerances.

Run: python examples/torch_hopper_raibert.py [--steps 1000] [--v0 0.2]
     [--cpu] [--gif out.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def lane_policies(policies):
    """One ``(init_state, apply)`` policy whose lane i is ``policies[i]``'s
    (stateless policies, as the Raibert ones are)."""
    import torch

    def init_state(batch):
        return ()

    def apply(state, obs):
        rows = [p_apply((), obs._replace(q0=obs.q0[i:i + 1],
                                         q1=obs.q1[i:i + 1],
                                         gamma=obs.gamma[i:i + 1]))[0]
                for i, (_, p_apply) in enumerate(policies)]
        return torch.cat(rows), state

    return init_state, apply


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--v0", type=float, default=0.2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--gif", type=str, default=None)
    args = ap.parse_args(argv)

    import torch

    import contactimplicitmpc_tpu_torch as pt
    from contactimplicitmpc_tpu_torch.control.raibert import raibert_policy
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models import hopper_2d as model
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    h_sim = 0.02  # gait h 0.1 / N_sample 5 (flat_raibert.jl:24-25)
    opts = IPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=100,
                     undercut=float("inf"), max_ls=25)
    v0s = [args.v0, 0.0, 0.1, 0.3, 0.4]
    f64 = dict(dtype=torch.float64, device=device)
    q1 = torch.tensor([[0.0, 0.5, 0.0, 0.5]] * len(v0s), **f64)
    v1 = torch.zeros((len(v0s), 4), **f64)
    policy = lane_policies([raibert_policy(model, h=h_sim, v0=v0)
                            for v0 in v0s])

    trajs, dt = timed(lambda: pt.simulate(
        model, pt.flat_2d_lc, args.steps, h_sim, q1, v1, policy=policy,
        opts=opts), device)
    for i, v0 in enumerate(v0s):
        ok = bool(trajs.converged[i].all())
        x = float(trajs.q[i, -1, 0])
        v_avg = x / (args.steps * h_sim)
        print(f"v0={v0:+.2f}: status={ok} x_final={x:+.2f} "
              f"v_avg={v_avg:+.3f} m/s")
    print(f"{len(v0s)} rollouts x {args.steps} steps in {dt:.1f}s "
          f"(first run) {tag}")

    if args.gif:
        from contactimplicitmpc_tpu_torch.utils.visuals import animate_2d
        animate_2d(model, trajs.q[0][::5], path=args.gif)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
