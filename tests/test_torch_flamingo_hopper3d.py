"""The flamingo's and the 3D hopper's control path in the port against the
JAX package, float64 on the CPU: ``from_gait`` on their gaits, one
direct-mode ``newton_solve`` of each with fixed 8-iteration knot solves (the
form the card's kernel runs), and the 3D hopper's closed loop, ``simulate``
driven by ``ci_mpc_policy`` in tests/test_mpc_hopper_3d.py's configuration
(chip_smoke.py's path F), one lane × 20 sim steps
(tests/test_torch_flamingo_slope.py holds the flamingo's closed loop).

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances: ``from_gait`` 1e-12; Newton's trajectory, duals and the
closed loop's q, u, γ and b 1e-7; iteration counts and flags exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu import models as jmodels
from contactimplicitmpc_tpu.control import (CONFIGURATION, CIMPCOptions,
                                            NewtonOptions as JNewtonOptions,
                                            ci_mpc_policy as jci_mpc_policy,
                                            from_gait as jfrom_gait,
                                            initial_conditions as jinitial,
                                            tracking_objective as jtracking,
                                            tracking_velocity_objective as
                                            jtracking_velocity)
from contactimplicitmpc_tpu.control.linearized import \
    LinearizedData as JLinearizedData
from contactimplicitmpc_tpu.control.newton import \
    NewtonAssembler as JNewtonAssembler
from contactimplicitmpc_tpu.control.newton import newton_solve as jnewton
from contactimplicitmpc_tpu.control.policy import _slice_horizon
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
from contactimplicitmpc_tpu_torch.control.trajectory import (expand_traj,
                                                             from_gait)

N_OPTS = JNewtonOptions(r_tol=3e-4, max_iter=5, fixed_ip_iters=8)


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


def flamingo_case():
    """examples/flamingo_slope.py's controller: (model, env, gait, h_mpc,
    κ, objective, knot options), the weights of slope.jl:31-36."""
    jm = jmodels.flamingo
    jd = ci.dims_of(jm, ci.flat_2d_lc)
    h_mpc, kappa = 15, 2.0e-4
    obj = jtracking_velocity(
        jd, h_mpc,
        v=np.tile(1e-3 * np.array([1e0, 1, 1e4, 1, 1, 1, 1, 1e4, 1e4]),
                  (h_mpc, 1)),
        q=np.tile(1e-1 * np.array([3e2, 1e-6, 3e2, 1, 1, 1, 1, 0.1, 0.1]),
                  (h_mpc, 1)),
        u=np.tile(3e-1 * np.array([0.1, 0.1, 0.3, 0.3, 2.0, 2.0]),
                  (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, jd.nc)),
        b=1e-100 * np.ones((h_mpc, jd.nb)))
    ip = JIPOptions(r_tol=1e-8, kappa_tol=kappa, max_iter=100, undercut=5.0,
                    gamma_reg=0.1, diff_sol=True, max_ls=3)
    return ("flamingo", ci.flat_2d_lc, pt.flat_2d_lc,
            ("flamingo", "gait_forward_36_4"), 0.0, h_mpc, kappa, obj, ip)


def hopper3d_case():
    """tests/test_mpc_hopper_3d.py's controller (3D_flat.jl:38-42, :73-80)."""
    jm = jmodels.hopper_3d
    jd = ci.dims_of(jm, ci.flat_3d_lc)
    h_mpc, kappa = 20, 1.0e-4
    obj = jtracking(
        jd, h_mpc,
        q=np.tile(1e-1 * np.array([3, 3, 0.1, 50, 50, 50, 10]), (h_mpc, 1)),
        u=np.tile(np.array([0.1, 0.1, 10.0]), (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, jd.nc)),
        b=1e-100 * np.ones((h_mpc, jd.nb)))
    ip = JIPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=100, undercut=5.0,
                    gamma_reg=0.1, diff_sol=True)
    return ("hopper_3D", ci.flat_3d_lc, pt.flat_3d_lc,
            ("hopper_3D", "gait_forward"), kappa, h_mpc, kappa, obj, ip)


CASES = {"flamingo": flamingo_case, "hopper_3D": hopper3d_case}


@pytest.mark.parametrize("name", list(CASES))
def test_from_gait_matches(name):
    """``from_gait`` on the path's gait (the slacks from ϕ on the flat
    terrain, the gait's own μ), to 1e-12."""
    _, jenv, env, gait, kappa, *_ = CASES[name]()
    g = load_gait(*gait)
    want = jfrom_gait(jmodels.MODELS[name], jenv, g, kappa=kappa)
    got = from_gait(tmodels.MODELS[name], env, g, kappa=kappa, device="cpu")
    for field in got._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), rtol=0,
                                   atol=1e-12, err_msg=field)


@pytest.mark.parametrize("name", list(CASES))
def test_newton_solve_matches(name):
    """One direct-mode solve in configuration mode with fixed 8-iteration
    knot solves, from the reference warm start, for two lanes whose
    measured (q0, q1) differ by 0.02 · N(0, 1). Both packages take the
    port's linearization of the window (tests/test_torch_models_more.py
    holds the residual and its Jacobians to JAX's)."""
    _, jenv, env, gait, kappa_ref, h_mpc, kappa, obj, ip = CASES[name]()
    jm, model = jmodels.MODELS[name], tmodels.MODELS[name]
    jd = ci.dims_of(jm, jenv)
    ref = jfrom_gait(jm, jenv, load_gait(*gait), kappa=kappa_ref)
    tref = interop.contact_traj(ref, device="cpu")
    lin = linearize_trajectory(model, env, tref, kappa)
    lin_w = type(lin)(*(x[:h_mpc] for x in lin))
    jlin_w = JLinearizedData(*(jnp.asarray(x.numpy()) for x in lin_w))
    window = _slice_horizon(ref, h_mpc)
    rng = np.random.default_rng(8)
    scale = np.array([[0.0], [0.02]])
    q0 = np.asarray(ref.q[0]) + scale * rng.standard_normal((2, jd.nq))
    q1 = np.asarray(ref.q[1]) + scale * rng.standard_normal((2, jd.nq))
    alt = np.zeros((2, jd.nc))
    nu = np.zeros((2, h_mpc, nd_of(jd, CONFIGURATION)))
    asm = JNewtonAssembler(jd, h_mpc, CONFIGURATION)
    want = jax.jit(jax.vmap(lambda a, b, c, d: jnewton(
        jd, CONFIGURATION, asm, obj, jlin_w, window, window, d, a, b, c,
        ip, N_OPTS)))(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(alt),
                      jnp.asarray(nu))
    dims = pt.Dims(nq=jd.nq, nu=jd.nu, nw=jd.nw, nc=jd.nc, nf=jd.nf, ne=jd.ne)
    twin = interop.contact_traj(window, device="cpu")
    got = newton_solve(
        dims, CONFIGURATION, NewtonAssembler(dims, h_mpc, CONFIGURATION),
        interop.objective(obj, device="cpu"), lin_w, twin,
        expand_traj(twin, (2,)), torch.as_tensor(nu), torch.as_tensor(q0),
        torch.as_tensor(q1), torch.as_tensor(alt), interop.ip_options(ip),
        interop.newton_options(N_OPTS))
    assert int(np.asarray(want.iterations).max()) > 0
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    for field in ("q", "u", "gamma", "b", "z", "theta"):
        np.testing.assert_allclose(getattr(got.traj, field).numpy(),
                                   getattr(want.traj, field), rtol=0,
                                   atol=1e-7, err_msg=field)
    np.testing.assert_allclose(got.nu.numpy(), want.nu, rtol=0, atol=1e-7)


def test_hopper3d_policy_matches():
    """Path F's closed loop in float64: ``simulate`` driven by
    ``ci_mpc_policy`` (direct-mode Newton in configuration mode, fixed
    8-iteration knot solves, altitude update at 0.05) with the test's sim
    options (the line-search floor eps_min 0.25), one lane from the gait's
    initial state, 20 sim steps (2 control updates)."""
    _, jenv, env, gait, kappa_ref, h_mpc, kappa, obj, ip = hopper3d_case()
    jm, model = jmodels.hopper_3d, tmodels.hopper_3d
    ref = jfrom_gait(jm, jenv, load_gait(*gait), kappa=kappa_ref)
    n_sample, steps = 10, 20
    mpc_opts = CIMPCOptions(altitude_update=True,
                            altitude_impact_threshold=0.05)
    sim_opts = dataclasses.replace(ci.default_sim_options(), eps_min=0.25)
    h_sim = float(ref.h) / n_sample
    q1, v1 = (np.asarray(x) for x in jinitial(ref))
    jpolicy = jci_mpc_policy(jm, jenv, ref, obj, h_mpc=h_mpc,
                             n_sample=n_sample, kappa_mpc=kappa,
                             mode=CONFIGURATION, n_opts=N_OPTS, ip_opts=ip,
                             mpc_opts=mpc_opts)
    want = jax.jit(lambda q, v: ci.simulate(
        jm, jenv, steps, h_sim, q, v, policy=jpolicy, opts=sim_opts))(
            jnp.asarray(q1), jnp.asarray(v1))
    policy = pt.ci_mpc_policy(
        model, env, interop.contact_traj(ref, device="cpu"),
        interop.objective(obj, device="cpu"), h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION,
        n_opts=interop.newton_options(N_OPTS), ip_opts=interop.ip_options(ip),
        mpc_opts=interop.cimpc_options(mpc_opts))
    got = pt.simulate(model, env, steps, h_sim, torch.as_tensor(q1)[None],
                      torch.as_tensor(v1)[None], policy=policy,
                      opts=interop.ip_options(sim_opts))
    assert bool(pt.status(got).all()) and bool(ci.status(want))
    np.testing.assert_array_equal(got.converged[0].numpy(), want.converged)
    np.testing.assert_array_equal(got.iterations[0].numpy(), want.iterations)
    for field in ("q", "u", "gamma", "b"):
        np.testing.assert_allclose(getattr(got, field)[0].numpy(),
                                   np.asarray(getattr(want, field)), rtol=0,
                                   atol=1e-7, err_msg=field)
    assert float(np.abs(np.asarray(want.u)).max()) > 0
