"""The 16 flamingo lanes of chip_smoke.py's path E, and what the JAX package
does on them.

    JAX_PLATFORMS=cpu python tools/flamingo_lanes_reference.py [--write]

Draws the initial offsets with numpy (``default_rng(5)``): lane 0 is the
nominal lane (no offset); lanes 1-15 move the torso by 0.02 · uniform(−1, 1)
in x, lift it by 0.005 · uniform(0, 1) (the feet, which hang from the hip,
start on or above the ground) and tilt it by 0.02 · uniform(−1, 1) rad; the
leg angles stay. With ``--write`` they are stored as
``contactimplicitmpc_tpu_torch/assets/flamingo_offsets16.npz``. Then runs
the JAX package on those lanes on the CPU in float32, through
``mpc_rollout`` in examples/flamingo_slope.py's configuration (the
controller on flat_2d_lc about gait_forward_36_4, the physics on
slope_smooth_2d_lc, configuration mode, h_mpc 15, N_sample 5, κ 2e-4, the
example's knot options, altitude update at 0.02, a warm-start floor of
1e-2) with fixed 8-iteration knot solves (``NewtonOptions(r_tol=3e-4,
max_iter=5, fixed_ip_iters=8)``, the form the card's kernel runs) and
float32 adaptive sim solves (r_tol 1e-3, κ_tol 1e-5, 40 iterations: the
example's 1e-8 is out of float32's reach), ``--steps`` sim steps (50, path
E's), and prints one JSON line: which lanes converged every sim step, each
lane's progress up the slope, its least torso clearance above the terrain
and its largest torso angle, and the mean Newton iterations a period.
"""

import argparse
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
                                            NewtonOptions, from_gait,
                                            initial_conditions,
                                            tracking_velocity_objective)
from contactimplicitmpc_tpu.control.policy import CIMPCOptions  # noqa: E402
from contactimplicitmpc_tpu.control.rollout import mpc_rollout  # noqa: E402
from contactimplicitmpc_tpu.models import flamingo as model  # noqa: E402
from contactimplicitmpc_tpu.sim.interior_point import IPOptions  # noqa: E402
from contactimplicitmpc_tpu.utils.gaits import load_gait  # noqa: E402

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "contactimplicitmpc_tpu_torch", "assets",
    "flamingo_offsets16.npz")
LANES = 16


def offsets(nq: int) -> np.ndarray:
    rng = np.random.default_rng(5)
    out = np.zeros((LANES, nq), np.float32)
    out[1:, 0] = 0.02 * rng.uniform(-1.0, 1.0, LANES - 1)
    out[1:, 1] = 0.005 * rng.uniform(0.0, 1.0, LANES - 1)
    out[1:, 2] = 0.02 * rng.uniform(-1.0, 1.0, LANES - 1)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()

    dtype = jnp.float32
    env, sim_env = ci.flat_2d_lc, ci.slope_smooth_2d_lc
    dims = ci.dims_of(model, env)
    off = offsets(dims.nq)
    if args.write:
        np.savez(ASSET, offsets=off)
    with np.load(ASSET) as f:
        np.testing.assert_array_equal(f["offsets"], off)

    ref = from_gait(model, env, load_gait("flamingo", "gait_forward_36_4"),
                    dtype=dtype)
    n_sample, h_mpc, kappa = 5, 15, 2.0e-4
    # slope.jl:31-36
    obj = tracking_velocity_objective(
        dims, h_mpc,
        v=np.tile(1e-3 * np.array([1e0, 1, 1e4, 1, 1, 1, 1, 1e4, 1e4]),
                  (h_mpc, 1)),
        q=np.tile(1e-1 * np.array([3e2, 1e-6, 3e2, 1, 1, 1, 1, 0.1, 0.1]),
                  (h_mpc, 1)),
        u=np.tile(3e-1 * np.array([0.1, 0.1, 0.3, 0.3, 2.0, 2.0]),
                  (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype)
    mpc_ip = IPOptions(r_tol=1e-8, kappa_tol=kappa, max_iter=100,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                         undercut=float("inf"), max_ls=6, refine=1)
    n_opts = NewtonOptions(r_tol=3e-4, max_iter=5, fixed_ip_iters=8)
    q1, v1 = initial_conditions(ref)
    q1s = (q1[None, :] + jnp.asarray(off)).astype(dtype)
    v1s = jnp.broadcast_to(v1, q1s.shape).astype(dtype)
    roll = jax.jit(lambda q, v: mpc_rollout(
        model, env, ref, obj, args.steps, h_mpc, n_sample, kappa,
        CONFIGURATION, q, v, n_opts=n_opts, ip_opts=mpc_ip,
        sim_opts=sim_opts, warm_start_floor=1e-2,
        mpc_opts=CIMPCOptions(altitude_update=True,
                              altitude_impact_threshold=0.02),
        sim_env=sim_env))
    outs = [roll(q1s[i], v1s[i]) for i in range(LANES)]
    q = np.stack([np.asarray(o.q) for o in outs])
    ok = np.array([bool(jnp.all(o.sim_converged)) for o in outs])
    clearance = q[:, :, 1] - np.asarray(jax.vmap(jax.vmap(
        lambda x: sim_env.surf(x[:1])))(jnp.asarray(q)))
    print(json.dumps({
        "steps": args.steps,
        "lanes_converged_every_step": ok.tolist(),
        "n_converged_every_step": int(ok.sum()),
        "dx": (q[:, -1, 0] - q[:, 1, 0]).tolist(),
        "min_torso_clearance": clearance.min(axis=1).tolist(),
        "max_abs_torso_angle": np.abs(q[:, 2:, 2]).max(axis=1).tolist(),
        "mean_newton_iterations": float(np.mean(
            [np.asarray(o.newton_iterations) for o in outs])),
        "mean_sim_iterations": float(np.mean(
            [np.asarray(o.sim_iterations) for o in outs]))}))


if __name__ == "__main__":
    main()
