"""How far two correct sim solves of the quadruped's float32 problems
part: the JAX package's float32 ``ip_solve`` against the port's plain
version (``sim.interior_point.ip_solve``) in float32, and the port's in
float32 against the port's in float64 (the sim kernel computes in float64
and rounds to float32), all on the CPU, on the sim steps of a run of path
A.

    JAX_PLATFORMS=cpu python tools/sim_ip_spread.py [--steps 10]

The problems are every sim step of a float32 run of path A on the CPU (the
hot path's 16 lanes, ``--steps`` steps; the sim steps there are the port's
eager ``ip_solve``), recorded as (z0, θ) and handed to both solvers with
the hot path's sim options (24 masked trips) and phase L's (adaptive, 40
trips, 6 halvings). Prints one JSON line an option set and a pair: the
share of problems whose converged flags agree, among the problems both flag
converged the share whose z agree within 1e-3 and the largest |Δz|, and
the problems each flags converged. tests/test_torch_sim_ip_cuda.py's
``F32_LIMITS`` for the kernel against the plain version on the card are
set from these (PERF.md records them).
"""

import argparse
import dataclasses
import json
import os
import sys
from unittest import mock

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

import contactimplicitmpc_tpu as ci  # noqa: E402
from contactimplicitmpc_tpu.models import quadruped as jquadruped  # noqa: E402

import contactimplicitmpc_tpu_torch as pt  # noqa: E402
from contactimplicitmpc_tpu_torch.hotpath import (  # noqa: E402
    HotPathConfig, conf_initial_states, make_quadruped_rollout)
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped  # noqa: E402
from contactimplicitmpc_tpu_torch.sim.graphs import SimSolve  # noqa: E402
from contactimplicitmpc_tpu_torch.sim.interior_point import ip_solve  # noqa: E402
from test_torch_sim_ip_cuda import (F32_LIMITS, OPTIONS,  # noqa: E402
                                    f32_spread)


def cpu_states(steps):
    """(z0, θ) float32 of every sim step of path A on the CPU."""
    rollout, ref, model, _, _ = make_quadruped_rollout(
        HotPathConfig(), steps, torch.float32, device="cpu")
    q1s, v1s = conf_initial_states(model, ref)
    seen = []
    eager = SimSolve._eager

    def recording(self, z0, theta):
        seen.append((z0.clone(), theta.clone()))
        return eager(self, z0, theta)

    with mock.patch.object(SimSolve, "_eager", recording):
        rollout(q1s, v1s)
    return (torch.cat([z for z, _ in seen]), torch.cat([t for _, t in seen]))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    torch.set_num_threads(1)
    z0, theta = cpu_states(args.steps)
    dims = pt.dims_of(quadruped, pt.flat_2d_lc)
    jd = ci.dims_of(jquadruped, ci.flat_2d_lc)
    r_j = jax.jit(lambda z, th, k: ci.residual(jquadruped, ci.flat_2d_lc, z,
                                                 th, k))
    for name in ("hot_path", "phase_L"):
        opts = OPTIONS[name]
        r_fn = SimSolve(quadruped, pt.flat_2d_lc, opts).residual_fn
        port = ip_solve(dims, r_fn, z0, theta, opts)
        port64 = ip_solve(dims, r_fn, z0.double(), theta.double(), opts)
        jopts = ci.IPOptions(**dataclasses.asdict(opts))
        one = jax.jit(lambda z, th: ci.ip_solve(jd, r_j, z, th, jopts))
        outs = [one(jnp.asarray(a), jnp.asarray(b))
                for a, b in zip(z0.numpy(), theta.numpy())]
        want = type(port)(
            z=torch.as_tensor(np.stack([np.asarray(o.z) for o in outs])),
            converged=torch.as_tensor([bool(o.converged) for o in outs]),
            iterations=None, rvio=None, kvio=None, dz=None)
        for pair, (a, b) in (("port f32 / JAX f32", (port, want)),
                             ("port f64 / port f32", (port64, port))):
            spread = f32_spread(type(a)(a.z.float(), *a[1:]), b,
                                F32_LIMITS["z_tol"])
            print(json.dumps({"options": name, "pair": pair,
                              "problems": int(z0.shape[0]),
                              "z_tol": F32_LIMITS["z_tol"], **spread,
                              "converged": [int(a.converged.sum()),
                                            int(b.converged.sum())]}),
                  flush=True)


if __name__ == "__main__":
    main()
