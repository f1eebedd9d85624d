"""The general path end to end against the JAX package, float64 on the
CPU, on the 2D hopper: ``simulate`` driven by ``ci_mpc_policy`` in direct
and in structure mode (3 lanes × 20 sim steps, 4 control updates, with the
altitude update on so that ``update_altitude`` and the shifted full warm
start run), ``mpc_rollout`` in direct mode under a disturbance, and the
trajectory helpers the policy uses.

Lane 0 starts from the gait's initial condition, lanes 1-2 from offsets of
examples/hopper_monte_carlo.py's distribution (0.05 · uniform(−1, 1), from
a numpy seed). Tolerance: configurations, controls and impulses to 1e-7
(20 closed-loop steps of two float64 implementations), flags and iteration
counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.control import (CONFIGURATION,
                                            NewtonOptions as JNewtonOptions,
                                            ci_mpc_policy as jci_mpc_policy,
                                            from_gait as jfrom_gait,
                                            initial_conditions as jinitial,
                                            tracking_error as jtracking_error,
                                            tracking_objective as jtracking,
                                            tracking_velocity_objective as
                                            jtracking_velocity)
from contactimplicitmpc_tpu.control.implicit_dynamics import \
    default_mpc_ip_options as jdefault_opts
from contactimplicitmpc_tpu.control.policy import CIMPCOptions as JCIMPCOptions
from contactimplicitmpc_tpu.control.rollout import mpc_rollout as jmpc_rollout
from contactimplicitmpc_tpu.control.trajectory import (
    contact_trajectory as jcontact_trajectory, rot_n_stride as jrot_n_stride)
from contactimplicitmpc_tpu.models import hopper_2d as jhopper
from contactimplicitmpc_tpu.sim.interior_point import IPOptions as JIPOptions
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
from contactimplicitmpc_tpu_torch.control.trajectory import (
    contact_trajectory, get_stride, rot_n_stride, tracking_error)
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d

H_MPC, N_SAMPLE, KAPPA, STEPS, LANES = 10, 5, 1.0e-4, 20, 3
MPC_OPTS = JCIMPCOptions(altitude_update=True, altitude_impact_threshold=0.05)
SIM_OPTS = JIPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=100,
                      undercut=float("inf"), max_ls=6)


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
def hopper():
    jd = ci.dims_of(jhopper, ci.flat_2d_lc)
    ref = jfrom_gait(jhopper, ci.flat_2d_lc,
                     load_gait("hopper_2D", "gait_in_place"), kappa=KAPPA)
    qw = np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (H_MPC, 1))
    qw[-2:] = 1e-1 * np.array([0.1, 3, 1, 3])
    vw = np.tile(1e-3 * np.array([0.1, 3, 1, 3]), (H_MPC, 1))
    vw[:2] = 1e1 * np.array([0.1, 3, 1, 3])
    common = dict(q=qw, u=np.tile(np.array([3e-3, 1e0]), (H_MPC, 1)),
                  gamma=1e-100 * np.ones((H_MPC, jd.nc)),
                  b=1e-100 * np.ones((H_MPC, jd.nb)))
    objs = {"direct": jtracking_velocity(jd, H_MPC, v=vw, **common),
            "structure": jtracking(jd, H_MPC, **common)}
    q1, v1 = jinitial(ref)
    rng = np.random.default_rng(0)
    offsets = np.concatenate([np.zeros((1, jd.nq)),
                              0.05 * rng.uniform(-1, 1, (LANES - 1, jd.nq))])
    q1s = np.asarray(q1)[None] + offsets
    v1s = np.broadcast_to(np.asarray(v1), q1s.shape).copy()
    return jd, ref, objs, q1s, v1s


@pytest.fixture(scope="module", params=["direct", "structure"])
def policy_runs(request, hopper):
    newton_mode = request.param
    jd, ref, objs, q1s, v1s = hopper
    obj = objs[newton_mode]
    n_opts = JNewtonOptions(r_tol=3e-4, max_iter=5, fixed_ip_iters=8)
    ip_opts = jdefault_opts(KAPPA, max_iter=30)
    h_sim = float(ref.h) / N_SAMPLE
    jpolicy = jci_mpc_policy(
        jhopper, ci.flat_2d_lc, ref, obj, h_mpc=H_MPC, n_sample=N_SAMPLE,
        kappa_mpc=KAPPA, mode=CONFIGURATION, newton_mode=newton_mode,
        n_opts=n_opts, ip_opts=ip_opts, mpc_opts=MPC_OPTS)
    want = jax.jit(jax.vmap(lambda q, v: ci.simulate(
        jhopper, ci.flat_2d_lc, STEPS, h_sim, q, v, policy=jpolicy,
        opts=SIM_OPTS)))(jnp.asarray(q1s), jnp.asarray(v1s))

    tref = interop.contact_traj(ref, device="cpu")
    policy = pt.ci_mpc_policy(
        hopper_2d, pt.flat_2d_lc, tref, interop.objective(obj, device="cpu"),
        h_mpc=H_MPC, n_sample=N_SAMPLE, kappa_mpc=KAPPA, mode=CONFIGURATION,
        newton_mode=newton_mode, n_opts=interop.newton_options(n_opts),
        ip_opts=interop.ip_options(ip_opts),
        mpc_opts=interop.cimpc_options(MPC_OPTS))
    got = pt.simulate(hopper_2d, pt.flat_2d_lc, STEPS, h_sim,
                      torch.as_tensor(q1s), torch.as_tensor(v1s),
                      policy=policy, opts=interop.ip_options(SIM_OPTS))
    return tref, got, want


def test_policy_flags_and_counts_match(policy_runs):
    _, got, want = policy_runs
    assert bool(pt.status(got).all()) and bool(want.converged.all())
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)


@pytest.mark.parametrize("name", ["q", "u", "gamma", "b"])
def test_policy_trajectories_match(policy_runs, name):
    _, got, want = policy_runs
    np.testing.assert_allclose(getattr(got, name).numpy(),
                               getattr(want, name), rtol=0, atol=1e-7)


def test_policy_controls_are_held_and_differ_by_lane(policy_runs):
    """A control is held for N_sample steps and renewed after; the offset
    lanes get other controls than the nominal one."""
    _, got, _ = policy_runs
    u = got.u.numpy().reshape(LANES, STEPS // N_SAMPLE, N_SAMPLE, -1)
    assert (u == u[:, :, :1]).all()
    assert np.abs(u[:, 1:] - u[:, :-1]).max() > 0
    assert float((got.u[1] - got.u[0]).abs().max()) > 1e-4


def test_policy_nominal_lane_tracks(policy_runs):
    tref, got, want = policy_runs
    errs = tracking_error(tref, got.q[0], got.u[0], got.gamma[0], got.b[0],
                          N_SAMPLE)
    assert all(isinstance(e, float) for e in errs)
    assert errs[0] < 0.05 and errs[1] < 0.5


def test_mpc_rollout_direct_matches(hopper):
    """``mpc_rollout`` in its direct branch (adaptive sim solves, a warm
    start floor, an external force on every step) against JAX's."""
    jd, ref, objs, q1s, v1s = hopper
    n_opts = JNewtonOptions(r_tol=3e-4, max_iter=5, fixed_ip_iters=8)
    w = 0.2 * np.random.default_rng(1).standard_normal((STEPS, jd.nw))
    kw = dict(warm_start_floor=1e-2, newton_mode="direct", stride_idx=(0, 1))
    want = jax.jit(jax.vmap(lambda q, v: jmpc_rollout(
        jhopper, ci.flat_2d_lc, ref, objs["direct"], STEPS, H_MPC, N_SAMPLE,
        KAPPA, CONFIGURATION, q, v, n_opts=n_opts, sim_opts=SIM_OPTS,
        w=jnp.asarray(w), **kw)))(jnp.asarray(q1s), jnp.asarray(v1s))
    got = mpc_rollout(
        hopper_2d, pt.flat_2d_lc, interop.contact_traj(ref, device="cpu"),
        interop.objective(objs["direct"], device="cpu"), STEPS, H_MPC,
        N_SAMPLE, KAPPA, CONFIGURATION, torch.as_tensor(q1s),
        torch.as_tensor(v1s), n_opts=interop.newton_options(n_opts),
        sim_opts=interop.ip_options(SIM_OPTS), w=w, **kw)
    for name in ("sim_converged", "newton_iterations", "sim_iterations"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    assert int(np.asarray(want.newton_iterations).max()) > 0
    for name in ("q", "u", "gamma", "b"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), rtol=0, atol=1e-7,
                                   err_msg=name)
    np.testing.assert_allclose(got.mpc_r_norm.numpy(), want.mpc_r_norm,
                               rtol=1e-5, atol=1e-10)


def test_trajectory_helpers_match(hopper):
    """``rot_n_stride`` (three shifts), ``contact_trajectory``,
    ``get_stride`` over two coordinates and ``tracking_error``."""
    jd, ref, _, _, _ = hopper
    dims = pt.dims_of(hopper_2d, pt.flat_2d_lc)
    tref = interop.contact_traj(ref, device="cpu")
    stride = np.zeros(jd.nq)
    stride[[0, 1]] = np.asarray(ref.q[-2, :2] - ref.q[0, :2]) + [0.3, 0.1]
    want, got = ref, tref
    for _ in range(3):
        want = jrot_n_stride(jd, want, jnp.asarray(stride))
        got = rot_n_stride(dims, got, torch.as_tensor(stride))
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), rtol=0, atol=1e-14,
                                   err_msg=name)
    np.testing.assert_allclose(
        get_stride(hopper_2d, tref, (0, 1)).numpy()[:2],
        np.asarray(ref.q[-2, :2] - ref.q[0, :2]), atol=1e-15)

    zero_j = jcontact_trajectory(jd, 4, 0.01, 1e-4)
    zero_t = contact_trajectory(dims, 4, 0.01, 1e-4, device="cpu")
    for name in zero_j._fields:
        np.testing.assert_array_equal(getattr(zero_t, name).numpy(),
                                      getattr(zero_j, name), err_msg=name)

    rng = np.random.default_rng(2)
    sim = [np.asarray(x)[:n] + 0.01 * rng.standard_normal(x[:n].shape)
           for x, n in ((ref.q, 14), (ref.u, 12), (ref.gamma, 12),
                        (ref.b, 12))]
    want = jtracking_error(ref, *map(jnp.asarray, sim), 1)
    got = tracking_error(tref, *map(torch.as_tensor, sim), 1)
    np.testing.assert_allclose(got, want, rtol=1e-12)
