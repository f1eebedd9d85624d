"""The 16 hopper lanes of chip_smoke.py's general path, and what the JAX
package does on them.

    JAX_PLATFORMS=cpu python tools/hopper_lanes_reference.py [--write]

Draws the initial offsets as examples/hopper_monte_carlo.py does
(0.05 · uniform(−1, 1) from ``jax.random.PRNGKey(100)``, float32, 16 × nq),
zeroes lane 0 (the nominal lane), and with ``--write`` stores them as
``contactimplicitmpc_tpu_torch/assets/hopper_offsets16.npz``. Then runs the
JAX package on those lanes on the CPU in float32, through ``simulate`` +
``ci_mpc_policy`` (direct-mode Newton, 8 fixed knot iterations, the
example's weights and adaptive sim options), 100 sim steps, and prints one
JSON line: which lanes converged every step, the nominal lane's tracking
errors and final configuration.
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
                                            NewtonOptions, ci_mpc_policy,
                                            from_gait, initial_conditions,
                                            tracking_error,
                                            tracking_velocity_objective)
from contactimplicitmpc_tpu.control.implicit_dynamics import \
    default_mpc_ip_options  # noqa: E402
from contactimplicitmpc_tpu.models import hopper_2d as model  # noqa: E402
from contactimplicitmpc_tpu.models.base import dims_of  # noqa: E402
from contactimplicitmpc_tpu.sim.interior_point import IPOptions  # noqa: E402
from contactimplicitmpc_tpu.utils.gaits import load_gait  # noqa: E402

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "contactimplicitmpc_tpu_torch", "assets",
    "hopper_offsets16.npz")
LANES, STEPS = 16, 100


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()

    dtype = jnp.float32
    env = ci.flat_2d_lc
    dims = dims_of(model, env)
    offsets = 0.05 * jax.random.uniform(jax.random.PRNGKey(100),
                                        (LANES, dims.nq), dtype,
                                        minval=-1.0, maxval=1.0)
    offsets = np.asarray(offsets.at[0].set(0.0))
    if args.write:
        np.savez(ASSET, offsets=offsets)
    with np.load(ASSET) as f:
        np.testing.assert_array_equal(f["offsets"], offsets)

    ref = from_gait(model, env, load_gait("hopper_2D", "gait_in_place"),
                    kappa=1e-4, dtype=dtype)
    n_sample, h_mpc, kappa = 5, 10, 1.0e-4
    qw = np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    qw[-2:] = 1e-1 * np.array([0.1, 3, 1, 3])
    vw = np.tile(1e-3 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    vw[:2] = 1e1 * np.array([0.1, 3, 1, 3])
    obj = tracking_velocity_objective(
        dims, h_mpc, q=qw, v=vw, u=np.tile([3e-3, 1e0], (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, 1)),
        b=1e-100 * np.ones((h_mpc, 2)), dtype=dtype)
    policy = ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, fixed_ip_iters=8),
        ip_opts=default_mpc_ip_options(kappa))
    sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                         undercut=float("inf"), max_ls=6)
    q1, v1 = initial_conditions(ref)
    q1s = (q1[None, :] + jnp.asarray(offsets)).astype(dtype)
    v1s = jnp.broadcast_to(v1, q1s.shape).astype(dtype)
    h_sim = float(ref.h) / n_sample
    traj = jax.jit(jax.vmap(lambda q, v: ci.simulate(
        model, env, STEPS, h_sim, q, v, policy=policy, opts=sim_opts)))(
            q1s, v1s)
    ok = np.asarray(jnp.all(traj.converged, axis=1))
    errs = tracking_error(ref, traj.q[0], traj.u[0], traj.gamma[0],
                          traj.b[0], n_sample)
    print(json.dumps({
        "lanes_converged_every_step": ok.tolist(),
        "success": float(ok.mean()),
        "hopping_at_end": np.asarray(
            jnp.abs(traj.q[:, -1, 1] - 0.5) < 0.5).tolist(),
        "nominal_errors_q_u_gamma_b": list(errs),
        "nominal_final_q": np.asarray(traj.q[0, -1]).tolist(),
        "mean_sim_iterations": float(jnp.mean(traj.iterations))}))


if __name__ == "__main__":
    main()
