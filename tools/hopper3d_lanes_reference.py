"""The 16 3D-hopper lanes of chip_smoke.py's path F, and what the JAX
package does on them.

    JAX_PLATFORMS=cpu python tools/hopper3d_lanes_reference.py [--write]
        [--fixed-iters 8] [--steps 100]

Draws the initial offsets with numpy (``default_rng(6)``): lane 0 is the
nominal lane (no offset); lanes 1-15 move the body by 0.02 · uniform(−1, 1)
in x and y and turn it by 0.01 · uniform(−1, 1) in each MRP coordinate
(about 0.04 rad; a turn lifts the foot, which starts on the ground); height
and leg length stay. With ``--write`` they are stored as
``contactimplicitmpc_tpu_torch/assets/hopper3d_offsets16.npz``. Then runs
the JAX package on those lanes on the CPU in float32: ``simulate`` driven by
``ci_mpc_policy`` in tests/test_mpc_hopper_3d.py's configuration
(gait_forward on flat_3d_lc, configuration mode, h_mpc 20, N_sample 10,
κ 1e-4, the test's knot options, altitude update at 0.05) with
``--fixed-iters`` fixed knot iterations (8, the form the card's kernel
runs; 0 gives the adaptive knot solves of the test) and float32 adaptive
sim solves (the test's options with r_tol 1e-3, κ_tol 1e-5, 40 iterations
and its line-search floor eps_min 0.25), and prints one JSON line: which
lanes converged every sim step, each lane's forward travel against half
the reference's stride over the same knots (test_mpc_hopper_3d.py's
check), and the nominal lane's tracking errors.
"""

import argparse
import dataclasses
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import contactimplicitmpc_tpu as ci  # noqa: E402
from contactimplicitmpc_tpu.control import (CONFIGURATION,  # noqa: E402
                                            CIMPCOptions, NewtonOptions,
                                            ci_mpc_policy, from_gait,
                                            initial_conditions,
                                            tracking_error,
                                            tracking_objective)
from contactimplicitmpc_tpu.models import hopper_3d as model  # noqa: E402
from contactimplicitmpc_tpu.sim.interior_point import IPOptions  # noqa: E402
from contactimplicitmpc_tpu.utils.gaits import load_gait  # noqa: E402

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "contactimplicitmpc_tpu_torch", "assets",
    "hopper3d_offsets16.npz")
LANES = 16


def offsets(nq: int) -> np.ndarray:
    rng = np.random.default_rng(6)
    out = np.zeros((LANES, nq), np.float32)
    out[1:, :2] = 0.02 * rng.uniform(-1.0, 1.0, (LANES - 1, 2))
    out[1:, 3:6] = 0.01 * rng.uniform(-1.0, 1.0, (LANES - 1, 3))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--fixed-iters", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()

    dtype = jnp.float32
    env = ci.flat_3d_lc
    dims = ci.dims_of(model, env)
    off = offsets(dims.nq)
    if args.write:
        np.savez(ASSET, offsets=off)
    with np.load(ASSET) as f:
        np.testing.assert_array_equal(f["offsets"], off)

    n_sample, h_mpc, kappa = 10, 20, 1.0e-4
    ref = from_gait(model, env, load_gait("hopper_3D", "gait_forward"),
                    kappa=kappa, dtype=dtype)
    # 3D_flat.jl:38-42
    obj = tracking_objective(
        dims, h_mpc,
        q=np.tile(1e-1 * np.array([3, 3, 0.1, 50, 50, 50, 10]), (h_mpc, 1)),
        u=np.tile(np.array([0.1, 0.1, 10.0]), (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype)
    # 3D_flat.jl:73-80
    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=100,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True)
    policy = ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5,
                             fixed_ip_iters=args.fixed_iters),
        ip_opts=mpc_ip,
        mpc_opts=CIMPCOptions(altitude_update=True,
                              altitude_impact_threshold=0.05))
    sim_opts = dataclasses.replace(ci.default_sim_options(), r_tol=1e-3,
                                   kappa_tol=1e-5, max_iter=40, eps_min=0.25)
    q1, v1 = initial_conditions(ref)
    q1s = (q1[None, :] + jnp.asarray(off)).astype(dtype)
    v1s = jnp.broadcast_to(v1, q1s.shape).astype(dtype)
    h_sim = float(ref.h) / n_sample
    roll = jax.jit(lambda q, v: ci.simulate(
        model, env, args.steps, h_sim, q, v, policy=policy, opts=sim_opts))
    outs = [roll(q1s[i], v1s[i]) for i in range(LANES)]
    q = np.stack([np.asarray(o.q) for o in outs])
    ok = np.array([bool(ci.status(o)) for o in outs])
    n_knots = args.steps // n_sample
    stride = float(ref.q[n_knots, 0] - ref.q[0, 0])
    travel = q[:, -1, 0] - q[:, 1, 0]
    errs = tracking_error(ref, outs[0].q, outs[0].u, outs[0].gamma,
                          outs[0].b, n_sample, idx_shift=(0,))
    print(json.dumps({
        "steps": args.steps, "fixed_ip_iters": args.fixed_iters,
        "lanes_converged_every_step": ok.tolist(),
        "n_converged_every_step": int(ok.sum()),
        "travel_x": travel.tolist(),
        "half_reference_stride": 0.5 * stride,
        "n_travel_past_half_stride": int((travel > 0.5 * stride).sum()),
        "nominal_errors_q_u_gamma_b": [float(e) for e in errs],
        "mean_sim_iterations": float(np.mean(
            [np.asarray(o.iterations) for o in outs]))}))


if __name__ == "__main__":
    main()
