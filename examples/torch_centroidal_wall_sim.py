"""Centroidal quadruped sliding into a wall (8-contact variant) on the
PyTorch port — the counterpart of examples/centroidal_wall_sim.py.

Mirror of the reference's ``examples/centroidal_quadruped/wall_sim.jl``:
the wall model (nc=8: 4 foot-ground + 4 foot-wall contacts) stops the feet
exactly at ``x_wall`` under the full NCP physics. ``--slanted`` switches to
the slanted-wall instance (wall at x=1.0). ``simulate`` only, float64, no
MPC.

Run: python examples/torch_centroidal_wall_sim.py [--steps 60] [--slanted]
     [--cpu] [--gif out.gif]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--slanted", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--gif", type=str, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import contactimplicitmpc_tpu_torch as pt
    from contactimplicitmpc_tpu_torch.device import (describe, resolve_device,
                                                     timed)
    from contactimplicitmpc_tpu_torch.models import (
        centroidal_quadruped_wall, centroidal_quadruped_wall_slanted)

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    model = (centroidal_quadruped_wall_slanted if args.slanted
             else centroidal_quadruped_wall)
    env = pt.flat_3d_lc

    # stance: body at 0.3 m, feet in the standard square, sliding +x
    foot_xy = np.array([[0.1, 0.1], [0.1, -0.1], [-0.1, 0.1],
                        [-0.1, -0.1]])
    q1 = np.zeros(18)
    q1[2] = 0.3
    for i, (fx, fy) in enumerate(foot_xy):
        q1[6 + 3 * i:9 + 3 * i] = [fx, fy, 0.05]
    v1 = np.zeros(18)
    v1[6::3] = 10.0  # all feet launched toward the wall
    f64 = dict(dtype=torch.float64, device=device)

    traj, wall = timed(lambda: pt.simulate(
        model, env, args.steps, 0.01, torch.tensor(q1[None], **f64),
        torch.tensor(v1[None], **f64)), device)
    print(f"first run: {wall:.1f}s {tag}")

    q = traj.q[0].cpu().numpy()
    feet_x = q[:, 6::3]
    print(f"sim status: {bool(pt.status(traj)[0])}")
    print(f"wall at x = {model.x_wall}; max foot x = {feet_x.max():.4f} "
          f"(penetration {max(0.0, feet_x.max() - model.x_wall):.1e} m)")
    print(f"feet at rest: max |v_x| last step = "
          f"{np.abs(feet_x[-1] - feet_x[-2]).max() / 0.01:.3f} m/s")

    if args.gif:
        from contactimplicitmpc_tpu_torch.utils.visuals import animate_3d
        animate_3d(model, q, env=env, path=args.gif)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
