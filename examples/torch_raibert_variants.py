"""Raibert heuristic baseline — 3D and terrain variants, on the PyTorch
port; the counterpart of examples/raibert_variants.py.

Mirrors of the reference's ``examples/raibert/``:

* ``flat_raibert_3D.jl`` — 3D hopper, flat ground, v0 = [0, 0.2]
* ``sine_raibert.jl`` — 2D hopper on the sinusoidal terrain
  (``sine2_2D_lc``), v0 = 0.2
* ``sine_raibert_3D.jl`` — 3D hopper on the 3D sinusoidal terrain
* ``piecewise_raibert.jl`` — 2D hopper on the piecewise slope terrain

``--case`` selects one, the default runs all. Float64, the reference's
tolerances.

Run: python examples/torch_raibert_variants.py
     [--case flat3d|sine2d|sine3d|piecewise] [--steps 2500] [--cpu]
     [--gif out.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", type=str, default="all")
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--gif", type=str, default=None)
    args = ap.parse_args(argv)

    import torch

    import contactimplicitmpc_tpu_torch as pt
    from contactimplicitmpc_tpu_torch.control.raibert import (
        raibert_policy, raibert_policy_3d)
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models import hopper_2d, hopper_3d
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    f64 = dict(dtype=torch.float64, device=device)
    opts = IPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=150,
                     undercut=float("inf"), max_ls=25, retries=2)

    def run_2d(env, v0, steps):
        """2D hopper cases (sine_raibert.jl / piecewise_raibert.jl:
        h = 0.1 gait, N_sample 5 → h_sim 0.02, start at [0, 0.5, 0, 0.5])."""
        h_sim = 0.02
        q1 = torch.tensor([[0.0, 0.5, 0.0, 0.5]], **f64)
        v1 = torch.tensor([[v0, 0.0, 0.0, 0.0]], **f64)
        return pt.simulate(hopper_2d, env, steps, h_sim, q1, v1,
                           policy=raibert_policy(hopper_2d, h=h_sim, v0=v0),
                           opts=opts), h_sim

    def run_3d(env, v0, steps):
        """3D hopper cases (flat_raibert_3D.jl: h = 0.01, N_sample 5 →
        h_sim 0.002; drop from z = 1.0 with the commanded velocity)."""
        h_sim = 0.002
        q1 = torch.tensor([[0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.5]], **f64)
        v1 = torch.tensor([[v0[0], v0[1], 0.0, 0.0, 0.0, 0.0, 0.0]], **f64)
        return pt.simulate(hopper_3d, env, steps, h_sim, q1, v1,
                           policy=raibert_policy_3d(hopper_3d, h=h_sim,
                                                    v0=v0),
                           opts=opts), h_sim

    cases = {
        "flat3d": lambda s: run_3d(pt.flat_3d_lc, (0.0, 0.2), s),
        "sine2d": lambda s: run_2d(pt.ENVIRONMENTS["sine2_2D_lc"], 0.2, s),
        "sine3d": lambda s: run_3d(pt.ENVIRONMENTS["sine2_3D_lc"],
                                   (0.0, 0.2), s),
        "piecewise": lambda s: run_2d(pt.ENVIRONMENTS["piecewise1_2D_lc"],
                                      0.2, s),
    }
    names = list(cases) if args.case == "all" else [args.case]
    last = None
    for name in names:
        (traj, h_sim), dt = timed(lambda: cases[name](args.steps), device)
        q = traj.q[0].cpu().numpy()
        conv = float(traj.converged[0].float().mean())
        fwd_axis = 1 if q.shape[1] >= 7 else 0   # 3D hops along y
        progress = q[-1, fwd_axis] - q[1, fwd_axis]
        print(f"{name}: steps={args.steps} convergence={conv:.4f} "
              f"forward={progress:+.2f} m "
              f"avg v={progress / (args.steps * h_sim):+.3f} m/s "
              f"({dt:.1f}s first run) {tag}")
        last = q

    if args.gif and last is not None:
        if last.shape[1] >= 7:
            from contactimplicitmpc_tpu_torch.utils.visuals import animate_3d
            animate_3d(hopper_3d, last[::10], path=args.gif)
        else:
            from contactimplicitmpc_tpu_torch.utils.visuals import animate_2d
            animate_2d(hopper_2d, last[::10], path=args.gif)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
