"""The knots of chip_smoke.py's kernel phases for the instantiations that no
path runs, committed as numpy.

    python tools/knot_states.py [--write]

For each row of ``chip_smoke.PATHLESS`` (pushbot, walled cartpole, 2D and 3D
particle, centroidal quadruped at the wall) runs the port's ``simulate`` of
one lane from the example's or the test's initial state, float64 on the
CPU with the default sim options, and keeps its last K steps (q, u, w, γ,
b, z and θ a knot; ``chip_smoke.simulate_states``). With ``--write`` they
are stored as ``contactimplicitmpc_tpu_torch/assets/knot_states.npz``
(keys ``<model>/<field>``); without, the file is checked against a fresh
run. The simulates take minutes on a CPU (the pushbot's and the cartpole's
mass matrix and bias are ``torch.func`` derivatives of their Lagrangians),
so chip_smoke.py reads the file instead of running them. Prints, for each
model, the largest contact impulse of each knot.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import KNOT_STATES, PATHLESS, simulate_states  # noqa: E402
from contactimplicitmpc_tpu_torch.models import MODELS  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()
    out = {}
    for name, env, q1, v1, h, steps, knots, *_ in PATHLESS:
        states = simulate_states(MODELS[name], env, q1, v1, h, steps, knots)
        print(name, "largest impulse a knot:",
              np.round(states["gamma"].amax(-1).numpy(), 4).tolist(),
              flush=True)
        out.update({f"{name}/{k}": v.numpy() for k, v in states.items()})
    if args.write:
        np.savez(KNOT_STATES, **out)
    with np.load(KNOT_STATES) as f:
        assert sorted(f.files) == sorted(out)
        for k, v in out.items():
            np.testing.assert_allclose(f[k], v, rtol=0, atol=1e-12,
                                       err_msg=k)
    print("knot states match", KNOT_STATES)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
