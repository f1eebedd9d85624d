"""Why the quadruped's sim kernel computes float32 problems in float64.

Phase L of chip_smoke.py (tests/test_mpc_quadruped.py's 1000 steps in
float32, through tests/test_torch_contracts_cuda.py's
``CONTRACTS["quadruped"]``) wants every sim step converged. With the sim
kernel computing float32 problems in float32 (``ops.sim_ip.sim_ip(...,
arithmetic="float32")``, a build of csrc/sim_ip.cu with
``-DSIM_IP_FLOAT32_ARITHMETIC``) the closed loop reaches a state where
float32 solves stall: they end their trips with kvio just above κ_tol,
where a float64 solve of the same float32 problem converges.

    python3 tools/sim_ip_f32_stall.py --write [--file PATH]   # on the card
    python3 tools/sim_ip_f32_stall.py [--file PATH]           # on the card
    python3 tools/sim_ip_f32_stall.py --cpu [--file PATH]     # anywhere

``--write`` runs the contract with every sim step through the float32-
arithmetic kernel, prints its reading (steps converged, tracking errors)
and writes the first step that did not converge (its z0 and θ, its index
and the sim options) to ``--file`` (by default
``contactimplicitmpc_tpu_torch/assets/sim_ip_f32_stall.npz``); it exits 1
if every step converged. Without it the tool replays that step and
prints, for each solver, whether it converged, its trips, rvio and kvio:
the kernel as the sim steps run it (float64 inside) and in float32
arithmetic, the plain version's replayed graphs in float32 and on the
problem cast to float64, and ``ip_solve`` on the CPU in float32 and
float64. ``--cpu`` prints the CPU rows alone. One JSON line a solver, after
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import contactimplicitmpc_tpu_torch as pt  # noqa: E402
from contactimplicitmpc_tpu_torch.device import describe  # noqa: E402
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped  # noqa: E402
from contactimplicitmpc_tpu_torch.ops import sim_ip  # noqa: E402
from contactimplicitmpc_tpu_torch.sim.graphs import SimSolve  # noqa: E402
from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions  # noqa: E402

FILE = os.path.join(os.path.dirname(os.path.abspath(pt.__file__)),
                    "assets", "sim_ip_f32_stall.npz")


def write(path: str) -> int:
    """Run phase L's contract through the float32-arithmetic kernel and
    write its first unconverged sim step to ``path``."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_contracts_cuda as contracts

    steps = []

    def f32_kernel(self, z0, theta):
        out = sim_ip.sim_ip(self.model, self.env, z0, theta, self.opts,
                            arithmetic="float32")
        steps.append((z0.clone(), theta.clone(), out.converged.clone(),
                      self.opts))
        return out

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with mock.patch.object(SimSolve, "_kernel", f32_kernel):
        reading = contracts.CONTRACTS["quadruped"](torch.device("cuda"))
    print(json.dumps({"contract": "quadruped", "arithmetic": "float32",
                      "sim_steps": len(steps), **reading}), flush=True)
    bad = [i for i, s in enumerate(steps) if not bool(s[2].all())]
    print(json.dumps({"unconverged_steps": bad}), flush=True)
    if not bad:
        return 1
    z0, theta, _, opts = steps[bad[0]]
    np.savez(path, z0=z0.cpu().numpy(), theta=theta.cpu().numpy(),
             step=bad[0], options=json.dumps(dataclasses.asdict(opts)),
             reading=json.dumps(reading))
    print(f"wrote step {bad[0]} to {path}", flush=True)
    return 0


def row(name: str, out, opts: IPOptions) -> None:
    print(json.dumps({"solver": name, "converged": bool(out.converged[0]),
                      "trips": int(out.iterations[0]),
                      "rvio": float(out.rvio[0]), "kvio": float(out.kvio[0]),
                      "r_tol": opts.r_tol, "kappa_tol": opts.kappa_tol}),
          flush=True)


def replay(path: str, cpu_only: bool) -> int:
    data = np.load(path)
    opts = IPOptions(**json.loads(str(data["options"])))
    z0 = torch.as_tensor(data["z0"])
    theta = torch.as_tensor(data["theta"])
    print(json.dumps({"step": int(data["step"]),
                      "options": dataclasses.asdict(opts)}), flush=True)
    solve = SimSolve(quadruped, pt.flat_2d_lc, opts)
    if not cpu_only:
        dev = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        z, th = z0.to(dev), theta.to(dev)
        assert solve.route(z) == "kernel"
        row("kernel, float32 tensors (float64 inside)", solve(z, th), opts)
        row("kernel, float32 arithmetic",
            sim_ip.sim_ip(quadruped, pt.flat_2d_lc, z, th, opts,
                          arithmetic="float32"), opts)
        row("kernel, float64 tensors", solve(z.double(), th.double()), opts)
        row("graphs, float32", solve._graphed(z, th), opts)
        row("graphs, float64", solve._graphed(z.double(), th.double()), opts)
    row("ip_solve on the CPU, float32", solve(z0, theta), opts)
    row("ip_solve on the CPU, float64", solve(z0.double(), theta.double()),
        opts)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--write", action="store_true")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--file", default=FILE)
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    print(describe("cpu" if args.cpu else "cuda"), flush=True)
    if args.write:
        return write(args.file)
    return replay(args.file, args.cpu)


if __name__ == "__main__":
    sys.exit(main())
