"""The centroidal quadruped's control path in the port against the JAX
package, float64 on the CPU: the trot's reference and objective carried
over by ``interop``, one direct-mode
``newton_solve`` (a 480 × 480 KKT) and a short closed-loop ``mpc_rollout``
with fixed-iteration knot solves (the knot kernel's plain version on the
CPU), in examples/centroidal_trot.py's configuration.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances: Newton's trajectory and duals 1e-8, the
rollout's q, u, γ and b 1e-7; iteration counts and flags exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu import models as jmodels
from contactimplicitmpc_tpu.control import (CONFIGURATION,
                                            NewtonOptions as JNewtonOptions,
                                            from_gait as jfrom_gait,
                                            initial_conditions as jinitial,
                                            tracking_velocity_objective as
                                            jtracking_velocity)
from contactimplicitmpc_tpu.control.linearized import \
    LinearizedData as JLinearizedData
from contactimplicitmpc_tpu.control.newton import \
    NewtonAssembler as JNewtonAssembler
from contactimplicitmpc_tpu.control.newton import newton_solve as jnewton
from contactimplicitmpc_tpu.control.policy import _slice_horizon
from contactimplicitmpc_tpu.control.rollout import mpc_rollout as jmpc_rollout
from contactimplicitmpc_tpu.sim.interior_point import IPOptions as JIPOptions
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch import models as tmodels
from contactimplicitmpc_tpu_torch.control.implicit_dynamics import nd_of
from contactimplicitmpc_tpu_torch.control.linearized import \
    linearize_trajectory
from contactimplicitmpc_tpu_torch.control.newton import (NewtonAssembler,
                                                         newton_solve)
from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
from contactimplicitmpc_tpu_torch.control.trajectory import expand_traj

H_MPC, N_SAMPLE, KAPPA = 10, 5, 2.0e-4
# examples/centroidal_trot.py's knot options (its float32 form, refine 1:
# the configuration the card's kernel runs) and sim options (float64)
MPC_IP = JIPOptions(r_tol=1e-4, kappa_tol=KAPPA, max_iter=30, undercut=5.0,
                    gamma_reg=0.1, diff_sol=True, max_ls=3, refine=1)
SIM_OPTS = JIPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=100,
                      undercut=float("inf"), max_ls=6)
N_OPTS = JNewtonOptions(r_tol=3e-5, max_iter=5, fixed_ip_iters=8)


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


# ---- the trot: Newton and the rollout ---------------------------------------

def _trot_objective(jd):
    """examples/centroidal_trot.py's weights (flat_trot.jl:38-42,
    diagonalized)."""
    v_w = 1e-3 * np.concatenate([np.ones(3), 1e3 * np.ones(3), np.ones(12)])
    q_body = np.array([1e-2, 1e-2, 1.0]) + 4.0 * np.array([0.2, 0.2, 1.0])
    q_w = np.concatenate([q_body, 0.3 * np.ones(3),
                          np.tile([0.2, 0.2, 1.0], 4)])
    return jtracking_velocity(jd, H_MPC, q=q_w, v=v_w,
                              u=3e-3 * np.ones(jd.nu))


@pytest.fixture(scope="module")
def trot():
    jm = jmodels.centroidal_quadruped
    jd = ci.dims_of(jm, ci.flat_3d_lc)
    ref = jfrom_gait(jm, ci.flat_3d_lc,
                     load_gait("centroidal_quadruped", "inplace_trot_v2"),
                     update_friction=True)
    return jm, jd, ref, _trot_objective(jd)


def test_objective_carried_over(trot):
    """The example's velocity-tracking objective and the trot's reference
    carried over by ``interop``, unchanged."""
    jm, jd, ref, obj = trot
    tobj = interop.objective(obj, device="cpu")
    for name in tobj._fields:
        np.testing.assert_array_equal(getattr(tobj, name).numpy(),
                                      np.asarray(getattr(obj, name)))
    tref = interop.contact_traj(ref, device="cpu")
    for name in tref._fields:
        np.testing.assert_array_equal(getattr(tref, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_newton_solve_matches(trot):
    """One direct-mode solve (a 480 × 480 KKT a lane) with fixed
    8-iteration knot solves, from the reference warm start, for two lanes
    whose measured (q0, q1) differ by 0.01 · N(0, 1). Both packages take
    the port's linearization of the window (the rollout below holds the
    two linearizations together)."""
    jm, jd, ref, obj = trot
    tref = interop.contact_traj(ref, device="cpu")
    lin = linearize_trajectory(tmodels.centroidal_quadruped, pt.flat_3d_lc,
                               tref, KAPPA)
    lin_w = type(lin)(*(x[:H_MPC] for x in lin))
    jlin_w = JLinearizedData(*(jnp.asarray(x.numpy()) for x in lin_w))
    window = _slice_horizon(ref, H_MPC)
    rng = np.random.default_rng(4)
    scale = np.array([[0.0], [0.01]])
    q0 = np.asarray(ref.q[0]) + scale * rng.standard_normal((2, jd.nq))
    q1 = np.asarray(ref.q[1]) + scale * rng.standard_normal((2, jd.nq))
    alt = np.zeros((2, jd.nc))
    nu = np.zeros((2, H_MPC, nd_of(jd, CONFIGURATION)))
    asm = JNewtonAssembler(jd, H_MPC, CONFIGURATION)
    assert asm.ind.ntot == 480
    want = jax.jit(jax.vmap(lambda a, b, c, d: jnewton(
        jd, CONFIGURATION, asm, obj, jlin_w, window, window, d, a, b, c,
        MPC_IP, N_OPTS)))(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(alt),
                          jnp.asarray(nu))
    dims = pt.Dims(nq=jd.nq, nu=jd.nu, nw=jd.nw, nc=jd.nc, nf=jd.nf, ne=jd.ne)
    twin = interop.contact_traj(window, device="cpu")
    got = newton_solve(
        dims, CONFIGURATION, NewtonAssembler(dims, H_MPC, CONFIGURATION),
        interop.objective(obj, device="cpu"),
        lin_w, twin,
        expand_traj(twin, (2,)), torch.as_tensor(nu), torch.as_tensor(q0),
        torch.as_tensor(q1), torch.as_tensor(alt),
        interop.ip_options(MPC_IP), interop.newton_options(N_OPTS))
    assert int(np.asarray(want.iterations).max()) > 0
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    for name in ("q", "u", "gamma", "b", "z", "theta"):
        np.testing.assert_allclose(getattr(got.traj, name).numpy(),
                                   getattr(want.traj, name), rtol=0,
                                   atol=1e-8, err_msg=name)
    np.testing.assert_allclose(got.nu.numpy(), want.nu, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.r_norm.numpy(), want.r_norm, rtol=1e-6,
                               atol=1e-10)


def test_mpc_rollout_direct_matches(trot):
    """``mpc_rollout`` in direct configuration mode with the example's
    settings (warm-start floor 1e-2, fixed 8-iteration knot solves), 2 lanes
    × 10 sim steps: the nominal lane and one with the body moved by a seeded
    0.02 · uniform(−1, 1) in position and 0.05 in Euler angles."""
    jm, jd, ref, obj = trot
    q1, v1 = (np.asarray(x) for x in jinitial(ref))
    off = np.zeros((2, jd.nq))
    rng = np.random.default_rng(4)
    off[1, :3] = 0.02 * rng.uniform(-1.0, 1.0, 3)
    off[1, 3:6] = 0.05 * rng.uniform(-1.0, 1.0, 3)
    q1s, v1s = q1[None] + off, np.repeat(v1[None], 2, axis=0)
    steps = 10
    kw = dict(warm_start_floor=1e-2)
    want = jax.jit(jax.vmap(lambda q, v: jmpc_rollout(
        jm, ci.flat_3d_lc, ref, obj, steps, H_MPC, N_SAMPLE, KAPPA,
        CONFIGURATION, q, v, n_opts=N_OPTS, ip_opts=MPC_IP,
        sim_opts=SIM_OPTS, **kw)))(jnp.asarray(q1s), jnp.asarray(v1s))
    got = mpc_rollout(
        tmodels.centroidal_quadruped, pt.flat_3d_lc,
        interop.contact_traj(ref, device="cpu"),
        interop.objective(obj, device="cpu"), steps, H_MPC, N_SAMPLE, KAPPA,
        CONFIGURATION, torch.as_tensor(q1s), torch.as_tensor(v1s),
        n_opts=interop.newton_options(N_OPTS),
        ip_opts=interop.ip_options(MPC_IP),
        sim_opts=interop.ip_options(SIM_OPTS), **kw)
    for name in ("sim_converged", "newton_iterations", "sim_iterations"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    assert bool(np.asarray(want.sim_converged).all())
    assert int(np.asarray(want.newton_iterations).max()) > 0
    for name in ("q", "u", "gamma", "b"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), rtol=0, atol=1e-7,
                                   err_msg=name)
