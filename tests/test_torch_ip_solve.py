"""The port's full ``ip_solve`` against the JAX package's, float64 on the
CPU, on batches of ``particle_2d`` and ``hopper_2d`` contact problems made
from a numpy seed: the adaptive loop (per-problem iteration counts), cold
restarts, refinement, sensitivities, the dense LU backend and the warm
start; and the two models' residuals and Jacobians.

The JAX solver acts on one problem and is vmapped; under ``vmap`` each
problem stops on its own flag, which the port's done-mask loop reproduces.
Tolerances: z to 1e-9 and dz to 1e-7 absolute plus 1e-6 relative (two
orders of summation of the same float64 arithmetic; some entries of dz
are ~1e2), iteration counts and flags exactly. The sensitivities are
compared at the MPC's central-path target κ = 1e-4, where they are used:
at the simulator's κ = 1e-8 the cone variables are ~1e-8 and the system
behind dz is too ill-conditioned for two summation orders to agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.models import hopper_2d as jhopper
from contactimplicitmpc_tpu.models import particle_2d as jparticle
from contactimplicitmpc_tpu.sim.interior_point import \
    make_dense_solver as jmake_dense
from contactimplicitmpc_tpu.sim.interior_point import \
    z_warmstart as jz_warmstart

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d
from contactimplicitmpc_tpu_torch.models.particle_2d import particle_2d
from contactimplicitmpc_tpu_torch.sim.interior_point import make_dense_solver

MODELS = {"particle_2d": (jparticle, particle_2d),
          "hopper_2d": (jhopper, hopper_2d)}
H = 0.01


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


def problems(name, batch=6, seed=0):
    """(z0, θ) of ``batch`` physics steps near the ground: heights drawn
    in and above contact, small velocities and controls."""
    jmodel, _ = MODELS[name]
    dims = ci.dims_of(jmodel, ci.flat_2d_lc)
    rng = np.random.default_rng(seed)
    if name == "particle_2d":
        q1 = np.stack([rng.uniform(-1, 1, batch),
                       rng.uniform(0.0, 0.3, batch)], axis=1)
    else:
        q1 = np.stack([rng.uniform(-0.2, 0.2, batch),
                       rng.uniform(0.45, 0.7, batch),
                       rng.uniform(-0.2, 0.2, batch),
                       rng.uniform(0.4, 0.6, batch)], axis=1)
    v = rng.uniform(-1, 1, q1.shape)
    v[:, 1] = -np.abs(v[:, 1])
    u = 0.1 * rng.standard_normal((batch, dims.nu))
    theta = np.concatenate([q1 - H * v, q1, u, np.zeros((batch, dims.nw)),
                            np.full((batch, 1), jmodel.mu_world),
                            np.full((batch, 1), H)], axis=1)
    z0 = np.concatenate([q1, np.ones((batch, dims.nz - dims.nq))], axis=1)
    return dims, z0, theta


# the MPC's central-path target (implicit_dynamics.jl:25-32): the cone
# variables stay ~1e-2 and the sensitivities are well conditioned
SMOOTH = dict(kappa_tol=1.0e-4, undercut=5.0, gamma_reg=0.1, diff_sol=True)


def solve_both(name, opts, **kw):
    jmodel, model = MODELS[name]
    jd, z0, theta = problems(name, **kw)
    r_j = lambda z, th, k: ci.residual(jmodel, ci.flat_2d_lc, z, th, k)
    want = jax.jit(jax.vmap(lambda z, th: ci.ip_solve(jd, r_j, z, th, opts)))(
        jnp.asarray(z0), jnp.asarray(theta))
    dims = pt.dims_of(model, pt.flat_2d_lc)
    r_t = lambda z, th, k: pt.residual(model, pt.flat_2d_lc, z, th, k)
    got = pt.ip_solve(dims, r_t, torch.as_tensor(z0), torch.as_tensor(theta),
                      interop.ip_options(opts))
    return got, want


def assert_same(got, want, dz=False):
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    np.testing.assert_allclose(got.z.numpy(), want.z, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.rvio.numpy(), want.rvio, rtol=1e-6,
                               atol=1e-12)
    if dz:
        np.testing.assert_allclose(got.dz.numpy(), want.dz, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("name", list(MODELS))
def test_models_match(name):
    """Residual, rz and rθ of the two models at random points."""
    jmodel, model = MODELS[name]
    jd, z0, theta = problems(name, batch=3, seed=5)
    z = z0 + 0.1 * np.random.default_rng(6).uniform(0, 1, z0.shape)
    for fn_j, fn_t in (
            (lambda a, b: ci.residual(jmodel, ci.flat_2d_lc, a, b, 0.1),
             lambda a, b: pt.residual(model, pt.flat_2d_lc, a, b, 0.1)),
            (lambda a, b: ci.residual_z_jacobian(jmodel, ci.flat_2d_lc, a, b),
             lambda a, b: pt.residual_z_jacobian(model, pt.flat_2d_lc, a, b)),
            (lambda a, b: ci.residual_theta_jacobian(jmodel, ci.flat_2d_lc,
                                                     a, b),
             lambda a, b: pt.residual_theta_jacobian(model, pt.flat_2d_lc,
                                                     a, b))):
        want = jax.vmap(fn_j)(jnp.asarray(z), jnp.asarray(theta))
        got = torch.func.vmap(fn_t)(torch.as_tensor(z), torch.as_tensor(theta))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", list(MODELS))
def test_adaptive_matches(name):
    """The adaptive loop at the simulator's defaults: each problem stops on
    its own convergence, and the counts differ across the batch."""
    got, want = solve_both(name, ci.default_sim_options())
    assert bool(want.converged.all())
    assert len(set(np.asarray(want.iterations).tolist())) > 1
    assert_same(got, want)


def test_adaptive_budget_runs_out():
    """``max_iter`` below what the problems need: every live problem stops
    at the budget, unconverged, with the same iterate."""
    opts = dataclasses.replace(ci.default_sim_options(), max_iter=3)
    got, want = solve_both("hopper_2d", opts)
    assert not bool(want.converged.all())
    assert int(np.asarray(want.iterations).max()) == 3
    assert_same(got, want)


@pytest.mark.parametrize("name", list(MODELS))
def test_retries_match(name):
    """A budget that fails some problems, then two cold restarts: the
    converged problems pass through (their count restarts at 0)."""
    opts = dataclasses.replace(ci.default_sim_options(), max_iter=6,
                               retries=2)
    got, want = solve_both(name, opts)
    assert_same(got, want)


@pytest.mark.parametrize("name", list(MODELS))
def test_refine_and_diff_sol_match(name):
    """Two refinement passes a solve against the regularized operator (a
    JVP of the residual), and the sensitivities ∂z*/∂θ."""
    opts = dataclasses.replace(ci.default_sim_options(), refine=2, **SMOOTH)
    got, want = solve_both(name, opts)
    assert bool(want.converged.all())
    assert_same(got, want, dz=True)


def test_fixed_iterations_with_refine_match():
    """The masked fixed-iteration loop with refinement and sensitivities."""
    opts = dataclasses.replace(ci.default_sim_options(), fixed_iters=12,
                               refine=1, **SMOOTH)
    got, want = solve_both("hopper_2d", opts)
    assert_same(got, want, dz=True)


def test_dense_solver_matches():
    """``make_dense_solver`` (LU of the clamped Jacobian) as the backend."""
    jmodel, model = jhopper, hopper_2d
    jd, z0, theta = problems("hopper_2d")
    opts = dataclasses.replace(ci.default_sim_options(), **SMOOTH)
    r_j = lambda z, th, k: ci.residual(jmodel, ci.flat_2d_lc, z, th, k)
    rz_j = lambda z, th: ci.residual_z_jacobian(jmodel, ci.flat_2d_lc, z, th)
    want = jax.jit(jax.vmap(lambda z, th: ci.ip_solve(
        jd, r_j, z, th, opts, jacobian_fn=rz_j,
        linear_solver=jmake_dense(jd, rz_j, opts))))(
            jnp.asarray(z0), jnp.asarray(theta))
    dims = pt.dims_of(model, pt.flat_2d_lc)
    topts = interop.ip_options(opts)
    r_t = lambda z, th, k: pt.residual(model, pt.flat_2d_lc, z, th, k)
    rz_t = torch.func.vmap(lambda z, th: pt.residual_z_jacobian(
        model, pt.flat_2d_lc, z, th))
    got = pt.ip_solve(dims, r_t, torch.as_tensor(z0), torch.as_tensor(theta),
                      topts, linear_solver=make_dense_solver(dims, rz_t, topts))
    assert_same(got, want, dz=True)


def test_z_warmstart_matches():
    """The same uniform draw (made by JAX, handed over as numpy) gives the
    same warm start; a generator gives a draw inside the amplitude."""
    jd, z0, _ = problems("hopper_2d", batch=4)
    z_prev = z0 + 0.5
    q = z0[:, :jd.nq] + 0.01
    key = jax.random.PRNGKey(3)
    draw = np.asarray(jax.random.uniform(key, (jd.nz - jd.nq,), jnp.float64))
    want = jz_warmstart(jd, jnp.asarray(q[0]), jnp.asarray(z_prev[0]), key,
                        amplitude=1e-2)
    dims = pt.dims_of(hopper_2d, pt.flat_2d_lc)
    got = pt.z_warmstart(dims, torch.as_tensor(q), torch.as_tensor(z_prev),
                         amplitude=1e-2,
                         draw=torch.as_tensor(draw).expand(4, -1))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-15)
    gen = torch.Generator().manual_seed(0)
    z = pt.z_warmstart(dims, torch.as_tensor(q), torch.as_tensor(z_prev),
                       generator=gen, amplitude=1e-2)
    nudge = (z - torch.as_tensor(z_prev))[:, dims.nq:]
    assert bool((nudge >= 0).all()) and bool((nudge < 1e-2).all())
    assert bool((z[:, :dims.nq] == torch.as_tensor(q)).all())
