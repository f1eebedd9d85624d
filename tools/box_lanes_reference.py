"""The 16 centroidal-quadruped-box lanes of chip_smoke.py's path K (the stand
beside the box step, pushed toward it), and what the JAX package does on
them.

    JAX_PLATFORMS=cpu python tools/box_lanes_reference.py [--write]

Draws the initial offsets with numpy (``default_rng(10)``): lane 0 is the
nominal lane (no offset); lanes 1-15 move the body by 0.02 · uniform(−1, 1)
in position and 0.05 · uniform(−1, 1) in its three attitude coordinates,
the feet stay. With ``--write`` they are stored as
``contactimplicitmpc_tpu_torch/assets/box_offsets16.npz``. Then runs the
JAX package on those lanes on the CPU in float32, through ``mpc_rollout``
in tests/test_mpc_box.py's configuration (model centroidal_quadruped_box on
flat_3d_lc, gait centroidal_quadruped/stand_v0 with the friction update,
direct-mode Newton in configuration mode, H 10, N_sample 5, κ 2e-4, the
test's knot options, a warm-start floor of 1e-2, the push w[40:45] =
(3, 0, 0) / 5 toward the step, 80 sim steps) with fixed 8-iteration knot
solves (``NewtonOptions(fixed_ip_iters=8)``, the form the card's kernel
runs). The sim solves are path D's float32 adaptive ones (r_tol 1e-3,
κ_tol 1e-5, 40 iterations, 6 halvings, one refinement pass): the test's
1e-8 is out of float32's reach. Prints one JSON line: which lanes converged
every sim step, each lane's q tracking error, and each lane's lowest foot
gap to the box surface ``model.elevation`` (the test's bounds: q < 0.05,
gap > −1e-4).
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
                                            tracking_errors,
                                            tracking_velocity_objective)
from contactimplicitmpc_tpu.control.rollout import mpc_rollout  # noqa: E402
from contactimplicitmpc_tpu.models import \
    centroidal_quadruped_box as model  # noqa: E402
from contactimplicitmpc_tpu.sim.interior_point import IPOptions  # noqa: E402
from contactimplicitmpc_tpu.utils.gaits import load_gait  # noqa: E402

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "contactimplicitmpc_tpu_torch", "assets", "box_offsets16.npz")
LANES, STEPS = 16, 80


def offsets(nq: int) -> np.ndarray:
    rng = np.random.default_rng(10)
    out = np.zeros((LANES, nq), np.float32)
    out[1:, :3] = 0.02 * rng.uniform(-1.0, 1.0, (LANES - 1, 3))
    out[1:, 3:6] = 0.05 * rng.uniform(-1.0, 1.0, (LANES - 1, 3))
    return out


def push(steps: int = STEPS) -> np.ndarray:
    """tests/test_mpc_box.py's push toward the step, (steps, nw)."""
    w = np.zeros((steps, 3))
    w[40:45] = np.array([3.0, 0.0, 0.0]) / 5.0
    return w


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()

    dtype = jnp.float32
    env = ci.flat_3d_lc
    dims = ci.dims_of(model, env)
    off = offsets(dims.nq)
    if args.write:
        np.savez(ASSET, offsets=off)
    with np.load(ASSET) as f:
        np.testing.assert_array_equal(f["offsets"], off)

    ref = from_gait(model, env, load_gait("centroidal_quadruped", "stand_v0"),
                    update_friction=True, dtype=dtype)
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4
    v_w = 1e-3 * np.concatenate([np.ones(3), 1e3 * np.ones(3), np.ones(12)])
    q_body = np.array([1e-2, 1e-2, 1.0]) + 4.0 * np.array([0.2, 0.2, 1.0])
    q_w = np.concatenate([q_body, 0.3 * np.ones(3),
                          np.tile([0.2, 0.2, 1.0], 4)])
    obj = tracking_velocity_objective(dims, h_mpc, q=q_w, v=v_w,
                                      u=3e-3 * np.ones(dims.nu), dtype=dtype)
    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=30,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                         undercut=float("inf"), max_ls=6, refine=1)
    n_opts = NewtonOptions(r_tol=3e-5, max_iter=5, fixed_ip_iters=8)
    q1, v1 = initial_conditions(ref)
    q1s = (q1[None, :] + jnp.asarray(off)).astype(dtype)
    v1s = jnp.broadcast_to(v1, q1s.shape).astype(dtype)
    w = jnp.asarray(push(), dtype)
    out = jax.jit(jax.vmap(lambda q, v: mpc_rollout(
        model, env, ref, obj, STEPS, h_mpc, n_sample, kappa, CONFIGURATION,
        q, v, n_opts=n_opts, ip_opts=mpc_ip, sim_opts=sim_opts,
        warm_start_floor=1e-2, w=w)))(q1s, v1s)
    ok = np.asarray(jnp.all(out.sim_converged, axis=1))
    q_err = jax.vmap(lambda q, u, g, b: tracking_errors(
        ref, q, u, g, b, n_sample)[0])(out.q, out.u, out.gamma, out.b)
    feet = np.asarray(out.q)[:, :, 6:].reshape(LANES, -1, 4, 3)
    elev = np.asarray(jax.vmap(model.elevation)(
        jnp.asarray(feet[..., 0].ravel(), dtype))).reshape(feet.shape[:-1])
    gaps = (feet[..., 2] - elev).reshape(LANES, -1).min(axis=1)
    print(json.dumps({
        "lanes_converged_every_step": ok.tolist(),
        "n_converged_every_step": int(ok.sum()),
        "q_error": np.asarray(q_err).tolist(),
        "lowest_foot_gap": gaps.tolist(),
        "all_finite": bool(np.isfinite(np.asarray(out.q)).all()),
        "mean_newton_iterations": float(jnp.mean(out.newton_iterations)),
        "mean_sim_iterations": float(jnp.mean(out.sim_iterations))}))


if __name__ == "__main__":
    main()
