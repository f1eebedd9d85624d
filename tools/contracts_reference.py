"""What the JAX package does on the eleven full-length closed-loop contracts
of its MPC tests, in the form the port runs them on the card.

    JAX_PLATFORMS=cpu python tools/contracts_reference.py [--only NAME,...]

The runs, one a contract test's rollout (the test named in brackets):

- ``quadruped``: ``simulate`` + ``ci_mpc_policy``, gait2, H 10, N_sample 5,
  1000 steps (tests/test_mpc_quadruped.py, both tests);
- ``flamingo``: gait_forward_36_4, CONFIGURATION_FORCE, H 15, 1000 steps
  (tests/test_mpc_flamingo.py, both);
- ``terrain``: ``mpc_rollout`` direct onto the piecewise slope, 250 steps
  (tests/test_mpc_terrain.py::test_quadruped_piecewise_mpc);
- ``altitude``: ``mpc_rollout`` structure mode with altitude updates on
  flat ground, 50 steps (tests/test_mpc_terrain.py::
  test_altitude_update_discovers_height);
- ``hopper``: the 2D hopper in place, 500 steps (tests/test_mpc_hopper.py);
- ``structure``: the same with structure-mode Newton, 500 steps
  (tests/test_mpc_structure_mode.py);
- ``hopper_sine``, ``hopper_piecewise``: the terrain-blind forward hop of
  examples/hopper_terrain.py, 500 steps (tests/test_hopper_terrain.py);
- ``parkour``: the hard stairs in structure mode, N_sample 10, 2400 steps
  (tests/test_mpc_parkour_structure.py);
- ``centroidal_stand`` (50 steps), ``centroidal_trot`` (100 steps)
  (tests/test_mpc_centroidal.py).

The form is the port's on the card: float32, fixed 8-iteration knot solves
(``NewtonOptions(fixed_ip_iters=8)``, the kernel's form), the tests' knot
options, and the float32 sim options of the chip paths (r_tol 1e-3,
κ_tol 1e-5, 40 iterations, 6 halvings; one refinement pass for the
flamingo and the centroidal quadruped, as chip_smoke's paths E and D),
where the tests' 1e-8 lies under float32's floor. The initial states are
``initial_conditions(ref)`` (the centroidal stand's raised by 0.01, as its
test's): no random draw. Prints one JSON line a contract: the sim steps
and how many converged, and each quantity its test bounds.
tests/test_torch_contracts_cuda.py holds the port to these.
"""

import argparse
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import contactimplicitmpc_tpu as ci  # noqa: E402
from contactimplicitmpc_tpu.control import (CONFIGURATION,  # noqa: E402
                                            CONFIGURATION_FORCE,
                                            NewtonOptions, ci_mpc_policy,
                                            from_gait, initial_conditions,
                                            tracking_error,
                                            tracking_objective,
                                            tracking_velocity_objective)
from contactimplicitmpc_tpu.control.implicit_dynamics import \
    default_mpc_ip_options  # noqa: E402
from contactimplicitmpc_tpu.control.policy import CIMPCOptions  # noqa: E402
from contactimplicitmpc_tpu.control.rollout import mpc_rollout  # noqa: E402
from contactimplicitmpc_tpu.models import (centroidal_quadruped,  # noqa: E402
                                           flamingo, hopper_2d, quadruped)
from contactimplicitmpc_tpu.models.base import dims_of  # noqa: E402
from contactimplicitmpc_tpu.sim.interior_point import IPOptions  # noqa: E402
from contactimplicitmpc_tpu.utils.gaits import load_gait  # noqa: E402

F32 = jnp.float32
FIXED = dict(fixed_ip_iters=8)


def sim_options(refine=0):
    return IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                     undercut=float("inf"), max_ls=6, refine=refine)


def run_simulate(model, env, ref, policy, steps, n_sample, sim_env=None,
                 opts=None):
    q1, v1 = initial_conditions(ref)
    h = float(ref.h) / n_sample
    return jax.jit(lambda q, v: ci.simulate(
        model, sim_env or env, steps, h, q, v, policy=policy,
        opts=opts or sim_options()))(q1.astype(F32), v1.astype(F32))


def errors(ref, traj, n_sample, idx_shift=()):
    return dict(zip(("q_err", "u_err", "gamma_err", "b_err"), tracking_error(
        ref, traj.q, traj.u, traj.gamma, traj.b, n_sample, idx_shift)))


def steps_of(converged):
    c = np.asarray(converged)
    return {"steps": int(c.size), "converged_steps": int(c.sum())}


def quadruped_mpc():
    model, env = quadruped, ci.flat_2d_lc
    dims = dims_of(model, env)
    ref = from_gait(model, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=F32)
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4
    qw = 1e-2 * np.array([1.0, 0.02, 0.25] + [0.25] * (dims.nq - 3))
    obj = tracking_objective(
        dims, h_mpc, q=np.tile(qw, (h_mpc, 1)),
        u=3e-2 * np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=F32)
    policy = ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30))
    traj = run_simulate(model, env, ref, policy, 1000, n_sample)
    return {**steps_of(traj.converged),
            **errors(ref, traj, n_sample, (0,))}


def flamingo_mpc():
    model, env = flamingo, ci.flat_2d_lc
    dims = dims_of(model, env)
    ref = from_gait(model, env, load_gait("flamingo", "gait_forward_36_4"),
                    dtype=F32)
    n_sample, h_mpc, kappa = 5, 15, 2.0e-4
    obj = tracking_velocity_objective(
        dims, h_mpc,
        v=np.tile(1e-3 * np.array([1e0, 1, 1e4, 1, 1, 1, 1, 1e4, 1e4]),
                  (h_mpc, 1)),
        q=np.tile(1e-1 * np.array([3e2, 1e-6, 3e2, 1, 1, 1, 1, 0.1, 0.1]),
                  (h_mpc, 1)),
        u=np.tile(3e-1 * np.array([0.1, 0.1, 0.3, 0.3, 1.0, 1.0]),
                  (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=F32)
    policy = ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION_FORCE,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30))
    traj = run_simulate(model, env, ref, policy, 1000, n_sample,
                        opts=sim_options(refine=1))
    return {**steps_of(traj.converged),
            **errors(ref, traj, n_sample, (0,))}


def terrain_mpc():
    model, env = quadruped, ci.piecewise1_2d_lc
    dims = dims_of(model, env)
    ref = from_gait(model, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=F32)
    n_sample, h_mpc, kappa = 5, 10, 1.0e-4
    qw = 1e-2 * np.array([5.0, 0.02, 0.10] + [0.25] * 8)
    obj = tracking_objective(
        dims, h_mpc, q=np.tile(qw, (h_mpc, 1)),
        u=3e-2 * np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=F32)
    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=100,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    q1, v1 = initial_conditions(ref)
    steps = 250
    traj = jax.jit(lambda q, v: mpc_rollout(
        model, env, ref, obj, steps, h_mpc, n_sample, kappa, CONFIGURATION,
        q, v, n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        ip_opts=mpc_ip, sim_opts=sim_options(), warm_start_floor=1e-2,
        mpc_opts=CIMPCOptions(altitude_update=True,
                              altitude_impact_threshold=0.05)))(
        q1.astype(F32), v1.astype(F32))
    heights = jax.vmap(lambda q: q[1] - env.surf(q[:1]))(traj.q)
    return {**steps_of(traj.sim_converged),
            "forward": float(traj.q[-1, 0] - traj.q[1, 0]),
            "min_height": float(jnp.min(heights)),
            **errors(ref, traj, n_sample, (0,))}


def altitude_mpc():
    model, env = quadruped, ci.flat_2d_lc
    dims = dims_of(model, env)
    ref = from_gait(model, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=F32)
    qw = 1e-2 * np.array([1.0, 0.02, 0.25] + [0.25] * 8)
    obj = tracking_objective(
        dims, 10, q=np.tile(qw, (10, 1)), u=3e-2 * np.ones((10, dims.nu)),
        gamma=1e-100 * np.ones((10, dims.nc)),
        b=1e-100 * np.ones((10, dims.nb)), dtype=F32)
    q1, v1 = initial_conditions(ref)
    traj = jax.jit(lambda q, v: mpc_rollout(
        model, env, ref, obj, 50, 10, 5, 2e-4, CONFIGURATION, q, v,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        sim_opts=sim_options(), warm_start_floor=1e-2,
        newton_mode="structure",
        mpc_opts=CIMPCOptions(altitude_update=True,
                              altitude_impact_threshold=0.05)))(
        q1.astype(F32), v1.astype(F32))
    return steps_of(traj.sim_converged)


def hopper_objective(dims, h_mpc):
    qw = np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    qw[-2:] = 1e-1 * np.array([0.1, 3, 1, 3])
    vw = np.tile(1e-3 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    vw[:2] = 1e1 * np.array([0.1, 3, 1, 3])
    return tracking_velocity_objective(
        dims, h_mpc, q=qw, v=vw,
        u=np.tile(np.array([3e-3, 1e0]), (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=F32)


def hopper_mpc(newton_mode):
    model, env = hopper_2d, ci.flat_2d_lc
    dims = dims_of(model, env)
    ref = from_gait(model, env, load_gait("hopper_2D", "gait_in_place"),
                    kappa=1.0e-4, dtype=F32)
    n_sample, h_mpc, kappa = 5, 10, 1.0e-4
    policy = ci_mpc_policy(
        model, env, ref, hopper_objective(dims, h_mpc), h_mpc=h_mpc,
        n_sample=n_sample, kappa_mpc=kappa, mode=CONFIGURATION,
        newton_mode=newton_mode,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30))
    traj = run_simulate(model, env, ref, policy, 500, n_sample)
    e = errors(ref, traj, n_sample)
    return {**steps_of(traj.converged), "q_err": e["q_err"],
            "u_err": e["u_err"], "x_final": float(traj.q[-1, 0]),
            "z_final": float(traj.q[-1, 1])}


def hopper_terrain(sim_env_name):
    """examples/hopper_terrain.py's 2D recipe (sine.jl, piecewise.jl)."""
    model, env = hopper_2d, ci.flat_2d_lc
    dims = dims_of(model, env)
    ref = from_gait(model, env, load_gait("hopper_2D", "gait_forward"),
                    dtype=F32)
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4
    obj = tracking_objective(
        dims, h_mpc,
        q=np.tile(1e-1 * np.array([0.1, 3.0, 1.0, 3.0]), (h_mpc, 1)),
        u=np.tile([1e-3, 1e0], (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=F32)
    policy = ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30),
        mpc_opts=CIMPCOptions(altitude_update=True,
                              altitude_impact_threshold=0.05))
    traj = run_simulate(model, env, ref, policy, 500, n_sample,
                        sim_env=ci.ENVIRONMENTS[sim_env_name])
    return {**steps_of(traj.converged),
            "convergence": float(jnp.mean(traj.converged.astype(F32))),
            "forward": float(traj.q[-1, 0] - traj.q[1, 0])}


def parkour_mpc():
    model, env, sim_env = hopper_2d, ci.flat_2d_lc, ci.stairs3_2d_lc
    dims = dims_of(model, env)
    ref = from_gait(model, env, load_gait("hopper_2D", "hopper_stair_ref"),
                    dtype=F32)
    n_sample, h_mpc, kappa = 10, 10, 2.0e-4
    steps = 240 * n_sample
    q_w = np.concatenate([
        np.tile(1e-0 * np.array([1e1, 1e-1, 1.0, 1.0]), (h_mpc - 5, 1)),
        np.tile(1e-1 * np.array([1.0, 1e-1, 1e1, 0.1]), (5, 1))])
    obj = tracking_velocity_objective(
        dims, h_mpc, v=np.tile(1e-3 * np.array([1e-2, 1, 1, 10]), (h_mpc, 1)),
        q=q_w, u=np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=F32)
    q1, v1 = initial_conditions(ref)
    traj = jax.jit(lambda q, v: mpc_rollout(
        model, env, ref, obj, steps, h_mpc, n_sample, kappa, CONFIGURATION,
        q, v, n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30),
        sim_opts=sim_options(), warm_start_floor=1e-2,
        newton_mode="structure",
        mpc_opts=CIMPCOptions(altitude_update=True,
                              altitude_impact_threshold=0.1),
        stride_idx=(0, 1), sim_env=sim_env))(q1.astype(F32), v1.astype(F32))
    return {**steps_of(traj.sim_converged), "x_final": float(traj.q[-1, 0]),
            "z_final": float(traj.q[-1, 1])}


def centroidal_mpc(gait, steps, q_offset=0.0):
    model, env = centroidal_quadruped, ci.flat_3d_lc
    dims = dims_of(model, env)
    ref = from_gait(model, env, load_gait("centroidal_quadruped", gait),
                    update_friction=True, dtype=F32)
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4
    v_w = 1e-3 * np.concatenate([np.ones(3), 1e3 * np.ones(3), np.ones(12)])
    q_body = np.array([1e-2, 1e-2, 1.0]) + 4.0 * np.array([0.2, 0.2, 1.0])
    q_w = np.concatenate([q_body, 0.3 * np.ones(3),
                          np.tile([0.2, 0.2, 1.0], 4)])
    obj = tracking_velocity_objective(dims, h_mpc, q=q_w, v=v_w,
                                      u=3e-3 * np.ones(dims.nu), dtype=F32)
    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=30,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    q1, v1 = initial_conditions(ref)
    q1 = q1.at[2].add(q_offset)
    traj = jax.jit(lambda q, v: mpc_rollout(
        model, env, ref, obj, steps, h_mpc, n_sample, kappa, CONFIGURATION,
        q, v, n_opts=NewtonOptions(r_tol=3e-5, max_iter=5, **FIXED),
        ip_opts=mpc_ip, sim_opts=sim_options(refine=1),
        warm_start_floor=1e-2))(q1.astype(F32), v1.astype(F32))
    e = errors(ref, traj, n_sample)
    return {**steps_of(traj.sim_converged), "q_err": e["q_err"],
            "height_error": abs(float(traj.q[-1, 2] - ref.q[1, 2])),
            "min_foot_z": float(jnp.min(traj.q[:, 8::3])),
            "min_body_z": float(jnp.min(traj.q[:, 2])),
            "ref_body_z": float(ref.q[1, 2])}


CONTRACTS = {
    "quadruped": quadruped_mpc,
    "flamingo": flamingo_mpc,
    "terrain": terrain_mpc,
    "altitude": altitude_mpc,
    "hopper": lambda: hopper_mpc("direct"),
    "structure": lambda: hopper_mpc("structure"),
    "hopper_sine": lambda: hopper_terrain("sine2_2D_lc"),
    "hopper_piecewise": lambda: hopper_terrain("piecewise1_2D_lc"),
    "parkour": parkour_mpc,
    "centroidal_stand": lambda: centroidal_mpc("stand_v0", 50, 0.01),
    "centroidal_trot": lambda: centroidal_mpc("inplace_trot_v2", 100),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=str, default=",".join(CONTRACTS),
                    help="comma-separated contract names")
    args = ap.parse_args()
    for name in args.only.split(","):
        t0 = time.time()
        out = CONTRACTS[name]()
        print(json.dumps({"contract": name, **out,
                          "seconds": round(time.time() - t0, 1)}),
              flush=True)


if __name__ == "__main__":
    main()
