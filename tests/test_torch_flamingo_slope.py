"""The flamingo up the smooth slope (chip_smoke.py's path E) in the port
against the JAX package, float64 on the CPU: ``mpc_rollout`` in
examples/flamingo_slope.py's configuration as
tests/test_mpc_flamingo_slope.py runs it (the controller on flat_2d_lc, the
physics on slope_smooth_2d_lc, configuration mode, h_mpc 15, N_sample 5,
κ 2e-4, altitude update at 0.02, a warm-start floor of 1e-2), with fixed
8-iteration knot solves (the knot kernel's plain version on the CPU), 2
lanes × 10 sim steps: the nominal lane and one with the torso moved by a
seeded offset of path E's kind.

The flamingo's mass matrix, bias and contact Jacobian are written out in
the port (the JAX package's are ``jax`` derivatives;
tests/test_torch_closed_form.py holds the two forms to each other). The
rollout runs 10 steps (the JAX package's own test runs 500). Tolerances:
q, u, γ and b 1e-7; flags and iteration counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu import models as jmodels
from contactimplicitmpc_tpu.control import (CONFIGURATION, CIMPCOptions,
                                            NewtonOptions as JNewtonOptions,
                                            from_gait as jfrom_gait,
                                            initial_conditions as jinitial,
                                            tracking_velocity_objective as
                                            jtracking_velocity)
from contactimplicitmpc_tpu.control.rollout import mpc_rollout as jmpc_rollout
from contactimplicitmpc_tpu.sim.interior_point import IPOptions as JIPOptions
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch import models as tmodels
from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout

H_MPC, N_SAMPLE, KAPPA, STEPS = 15, 5, 2.0e-4, 10
MPC_IP = JIPOptions(r_tol=1e-8, kappa_tol=KAPPA, max_iter=100, undercut=5.0,
                    gamma_reg=0.1, diff_sol=True, max_ls=3)
SIM_OPTS = JIPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=100,
                      undercut=float("inf"), max_ls=6)
N_OPTS = JNewtonOptions(r_tol=3e-4, max_iter=5, fixed_ip_iters=8)
MPC_OPTS = CIMPCOptions(altitude_update=True, altitude_impact_threshold=0.02)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every test here, and the module's fixtures, run PyTorch on one
    thread: a batched LAPACK factorization (the pivoted-LU KKT backend) does
    not return on some CPU builds under a thread count between 2 and the
    core count, and one thread a test process keeps the processes from
    competing for the cores. Set here, not at import: a test process
    imports every test file, and the last import would win."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def rollouts():
    jm = jmodels.flamingo
    jd = ci.dims_of(jm, ci.flat_2d_lc)
    ref = jfrom_gait(jm, ci.flat_2d_lc,
                     load_gait("flamingo", "gait_forward_36_4"))
    # slope.jl:31-36
    obj = jtracking_velocity(
        jd, H_MPC,
        v=np.tile(1e-3 * np.array([1e0, 1, 1e4, 1, 1, 1, 1, 1e4, 1e4]),
                  (H_MPC, 1)),
        q=np.tile(1e-1 * np.array([3e2, 1e-6, 3e2, 1, 1, 1, 1, 0.1, 0.1]),
                  (H_MPC, 1)),
        u=np.tile(3e-1 * np.array([0.1, 0.1, 0.3, 0.3, 2.0, 2.0]),
                  (H_MPC, 1)),
        gamma=1e-100 * np.ones((H_MPC, jd.nc)),
        b=1e-100 * np.ones((H_MPC, jd.nb)))
    q1, v1 = (np.asarray(x) for x in jinitial(ref))
    rng = np.random.default_rng(5)
    off = np.zeros((2, jd.nq))
    off[1, :3] = [0.02 * rng.uniform(-1, 1), 0.005 * rng.uniform(0, 1),
                  0.02 * rng.uniform(-1, 1)]
    q1s, v1s = q1[None] + off, np.repeat(v1[None], 2, axis=0)
    kw = dict(warm_start_floor=1e-2)
    roll = jax.jit(lambda q, v: jmpc_rollout(
        jm, ci.flat_2d_lc, ref, obj, STEPS, H_MPC, N_SAMPLE, KAPPA,
        CONFIGURATION, q, v, n_opts=N_OPTS, ip_opts=MPC_IP,
        sim_opts=SIM_OPTS, mpc_opts=MPC_OPTS, sim_env=ci.slope_smooth_2d_lc,
        **kw))
    lanes = [roll(jnp.asarray(q1s[i]), jnp.asarray(v1s[i])) for i in range(2)]
    want = {name: np.stack([np.asarray(getattr(o, name)) for o in lanes])
            for name in ("q", "u", "gamma", "b", "sim_converged",
                         "newton_iterations", "sim_iterations")}
    got = mpc_rollout(
        tmodels.flamingo, pt.flat_2d_lc,
        interop.contact_traj(ref, device="cpu"),
        interop.objective(obj, device="cpu"), STEPS, H_MPC, N_SAMPLE, KAPPA,
        CONFIGURATION, torch.as_tensor(q1s), torch.as_tensor(v1s),
        n_opts=interop.newton_options(N_OPTS),
        ip_opts=interop.ip_options(MPC_IP),
        sim_opts=interop.ip_options(SIM_OPTS),
        mpc_opts=interop.cimpc_options(MPC_OPTS),
        sim_env=pt.slope_smooth_2d_lc, **kw)
    return got, want


def test_flags_and_counts_match(rollouts):
    got, want = rollouts
    assert bool(want["sim_converged"].all())
    assert int(want["newton_iterations"].max()) > 0
    for name in ("sim_converged", "newton_iterations", "sim_iterations"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name],
                                      err_msg=name)


@pytest.mark.parametrize("name", ["q", "u", "gamma", "b"])
def test_trajectories_match(rollouts, name):
    got, want = rollouts
    np.testing.assert_allclose(getattr(got, name).numpy(), want[name],
                               rtol=0, atol=1e-7)


def test_climbs_the_slope(rollouts):
    """Both lanes move up the slope with the torso above the terrain, as
    tests/test_mpc_flamingo_slope.py checks over its 500 steps."""
    got, _ = rollouts
    assert bool((got.q[:, -1, 0] > got.q[:, 1, 0]).all())
    clearance = got.q[:, :, 1] - pt.slope_smooth_2d_lc.surf(got.q[:, :, :1])
    assert float(clearance.min()) > 0.4
    assert float(got.q[:, 2:, 2].abs().max()) < 0.5
