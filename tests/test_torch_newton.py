"""Direct-mode ``newton_solve`` of the port against the JAX package's,
float64 on the CPU: the 2D hopper over its in-place gait with both
objectives, both modes, fixed and adaptive knot solves and both Newton
loops, for a batch of lanes that need different numbers of iterations; one
quadruped solve at the full width (a 300 × 300 KKT a lane); and the
assembler's Jacobian and residual alone.

The measured configurations are the reference's, shifted per lane by
0.02·N(0, 1) from a numpy seed. Tolerances: trajectory and duals to 1e-8,
iteration counts and β exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.control import (NewtonOptions as JNewtonOptions,
                                            from_gait as jfrom_gait,
                                            tracking_objective as jtracking,
                                            tracking_velocity_objective as
                                            jtracking_velocity)
from contactimplicitmpc_tpu.control.implicit_dynamics import \
    default_mpc_ip_options as jdefault_opts
from contactimplicitmpc_tpu.control.implicit_dynamics import \
    implicit_dynamics as jimplicit
from contactimplicitmpc_tpu.control.linearized import \
    LinearizedData as JLinearizedData
from contactimplicitmpc_tpu.control.linearized import \
    linearize_trajectory as jlinearize
from contactimplicitmpc_tpu.control.newton import \
    NewtonAssembler as JNewtonAssembler
from contactimplicitmpc_tpu.control.newton import newton_solve as jnewton
from contactimplicitmpc_tpu.control.policy import _slice_horizon
from contactimplicitmpc_tpu.hotpath import (HotPathConfig as JHotPath,
                                            quadruped_tracking_weights as
                                            jquadruped_weights)
from contactimplicitmpc_tpu.models import hopper_2d as jhopper
from contactimplicitmpc_tpu.models import quadruped as jquadruped
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control.implicit_dynamics import (
    CONFIGURATION, CONFIGURATION_FORCE, implicit_dynamics, nd_of)
from contactimplicitmpc_tpu_torch.control.linearized import \
    linearize_trajectory
from contactimplicitmpc_tpu_torch.control.newton import (NewtonAssembler,
                                                         newton_solve)
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.control.trajectory import expand_traj


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


H_MPC = 10


def hopper_objective(jd, velocity):
    qw = np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (H_MPC, 1))
    qw[-2:] = 1e-1 * np.array([0.1, 3, 1, 3])
    common = dict(q=qw, u=np.tile(np.array([3e-3, 1e0]), (H_MPC, 1)),
                  gamma=1e-4 * np.ones((H_MPC, jd.nc)),
                  b=1e-4 * np.ones((H_MPC, jd.nb)))
    if not velocity:
        return jtracking(jd, H_MPC, **common)
    vw = np.tile(1e-3 * np.array([0.1, 3, 1, 3]), (H_MPC, 1))
    vw[:2] = 1e1 * np.array([0.1, 3, 1, 3])
    return jtracking_velocity(jd, H_MPC, v=vw,
                              v_target=np.array([0.01, 0.0, 0.0, 0.0]),
                              **common)


def solve_both(jmodel, ref, kappa, obj, mode, n_opts, ip_opts, lanes, seed,
               lin=None):
    """One Newton solve a lane in both packages, from the reference warm
    start, with the measured (q0, q1) of lane i the reference's plus
    0.02 · i / lanes · N(0, 1). Both take the linearization ``lin`` of the
    reference (JAX's own where it is not given)."""
    env = ci.flat_2d_lc
    jd = ci.dims_of(jmodel, env)
    lin = jlinearize(jmodel, env, ref, kappa) if lin is None else lin
    lin_w = type(lin)(*(x[:H_MPC] for x in lin))
    window = _slice_horizon(ref, H_MPC)
    rng = np.random.default_rng(seed)
    scale = 0.02 * np.arange(lanes)[:, None] / lanes
    q0 = np.asarray(ref.q[0]) + scale * rng.standard_normal((lanes, jd.nq))
    q1 = np.asarray(ref.q[1]) + scale * rng.standard_normal((lanes, jd.nq))
    alt = 0.001 * rng.standard_normal((lanes, jd.nc))
    nu = np.zeros((lanes, H_MPC, nd_of(jd, mode)))

    asm = JNewtonAssembler(jd, H_MPC, mode)
    want = jax.jit(jax.vmap(lambda a, b, c, d: jnewton(
        jd, mode, asm, obj, lin_w, window, window, d, a, b, c, ip_opts,
        n_opts)))(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(alt),
                  jnp.asarray(nu))

    dims = pt.Dims(nq=jd.nq, nu=jd.nu, nw=jd.nw, nc=jd.nc, nf=jd.nf, ne=jd.ne)
    twin = interop.contact_traj(window, device="cpu")
    got = newton_solve(
        dims, mode, NewtonAssembler(dims, H_MPC, mode),
        interop.objective(obj, device="cpu"),
        interop.linearized_data(lin_w, device="cpu"), twin,
        expand_traj(twin, (lanes,)), torch.as_tensor(nu),
        torch.as_tensor(q0), torch.as_tensor(q1), torch.as_tensor(alt),
        interop.ip_options(ip_opts), interop.newton_options(n_opts))
    return got, want


def assert_same(got, want):
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    np.testing.assert_allclose(got.beta.numpy(), want.beta, rtol=1e-14)
    for name in ("q", "u", "gamma", "b", "z", "theta"):
        np.testing.assert_allclose(getattr(got.traj, name).numpy(),
                                   getattr(want.traj, name), rtol=0,
                                   atol=1e-8, err_msg=name)
    np.testing.assert_allclose(got.nu.numpy(), want.nu, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.r_norm.numpy(), want.r_norm, rtol=1e-6,
                               atol=1e-10)


@pytest.fixture(scope="module")
def hopper_ref():
    return jfrom_gait(jhopper, ci.flat_2d_lc,
                      load_gait("hopper_2D", "gait_in_place"), kappa=1e-4)


@pytest.mark.parametrize("velocity,mode,fixed_ip,fixed_newton,solver", [
    (True, CONFIGURATION, 8, 0, "ldl"),
    (True, CONFIGURATION, 0, 0, "ldl"),
    (False, CONFIGURATION, 8, 3, "lu"),
    (True, CONFIGURATION_FORCE, 8, 0, "ldl"),
    (False, CONFIGURATION_FORCE, 0, 0, "lu"),
])
def test_hopper_newton_matches(hopper_ref, velocity, mode, fixed_ip,
                               fixed_newton, solver):
    jd = ci.dims_of(jhopper, ci.flat_2d_lc)
    n_opts = JNewtonOptions(r_tol=3e-4, max_iter=5, fixed_ip_iters=fixed_ip,
                            fixed_newton_iters=fixed_newton,
                            kkt_solver=solver)
    got, want = solve_both(jhopper, hopper_ref, 1e-4,
                           hopper_objective(jd, velocity), mode, n_opts,
                           jdefault_opts(1e-4, max_iter=30), lanes=4, seed=0)
    its = np.asarray(want.iterations)
    assert its.max() > 0
    if not fixed_newton:
        assert its.min() < its.max()      # lanes stop on their own
    assert_same(got, want)


def test_hopper_newton_bounded_growth_matches(hopper_ref):
    """A finite ``ls_growth_allow``: the least-bad finite trial is the
    fallback and steps past the bound are rejected."""
    jd = ci.dims_of(jhopper, ci.flat_2d_lc)
    n_opts = JNewtonOptions(r_tol=1e-7, max_iter=4, fixed_ip_iters=8,
                            ls_growth_allow=1.0)
    got, want = solve_both(jhopper, hopper_ref, 1e-4,
                           hopper_objective(jd, True), CONFIGURATION, n_opts,
                           jdefault_opts(1e-4), lanes=3, seed=1)
    assert_same(got, want)


def test_quadruped_newton_matches():
    """One direct-mode solve of the flat-ground quadruped at the hot path's
    options (two lanes): a 300 × 300 quasidefinite KKT, unpivoted LDLᵀ.
    Both packages take the port's linearization of the gait (held to JAX's
    in tests/test_torch_model.py), which the port forms in a fraction of
    the time JAX's nested forward-mode Jacobians take eagerly."""
    cfg = JHotPath(newton_mode="direct")
    env = ci.flat_2d_lc
    jd = ci.dims_of(jquadruped, env)
    ref = jfrom_gait(jquadruped, env, load_gait("quadruped", "gait2"),
                     update_friction=True)
    obj = jquadruped_weights(jd, H_MPC, jnp.float64)
    n_opts = dataclasses.replace(cfg.newton_options(), max_iter=2)
    tlin = linearize_trajectory(quadruped, pt.flat_2d_lc,
                                interop.contact_traj(ref, device="cpu"),
                                cfg.kappa_mpc)
    lin = JLinearizedData(*(jnp.asarray(x.numpy()) for x in tlin))
    got, want = solve_both(jquadruped, ref, cfg.kappa_mpc, obj, CONFIGURATION,
                           n_opts, cfg.mpc_ip_options(), lanes=2, seed=2,
                           lin=lin)
    assert int(np.asarray(want.iterations).max()) > 0
    assert_same(got, want)


@pytest.mark.parametrize("mode", [CONFIGURATION, CONFIGURATION_FORCE])
def test_assembler_matches(hopper_ref, mode):
    """The KKT matrix and the residual of one lane against JAX's, entry by
    entry, with the velocity objective (off-diagonal couplings) and every
    sensitivity block in place; the out-of-horizon blocks are dropped."""
    env = ci.flat_2d_lc
    jd = ci.dims_of(jhopper, env)
    ref = hopper_ref
    obj = hopper_objective(jd, True)
    lin = jlinearize(jhopper, env, ref, 1e-4)
    lin_w = type(lin)(*(x[:H_MPC] for x in lin))
    window = _slice_horizon(ref, H_MPC)
    opts = jdefault_opts(1e-4)
    rng = np.random.default_rng(3)
    nu = rng.standard_normal((H_MPC, nd_of(jd, mode)))
    imp = jimplicit(jd, mode, lin_w, window, jnp.zeros(jd.nc), opts,
                    fixed_iters=8)
    asm = JNewtonAssembler(jd, H_MPC, mode)
    want_j = asm.jacobian(obj, imp, 0.3, 1e-4, jnp.float64)
    want_r = asm.residual(obj, imp, window, window, jnp.asarray(nu))

    dims = pt.Dims(nq=jd.nq, nu=jd.nu, nw=jd.nw, nc=jd.nc, nf=jd.nf, ne=jd.ne)
    twin = interop.contact_traj(window, device="cpu")
    tobj = interop.objective(obj, device="cpu")
    timp = implicit_dynamics(dims, mode, interop.linearized_data(
        lin_w, device="cpu"), expand_traj(twin, (1,)), torch.zeros(1, jd.nc,
        dtype=torch.float64), interop.ip_options(opts), fixed_iters=8)
    tasm = NewtonAssembler(dims, H_MPC, mode)
    assert tasm.ind.ntot == asm.ind.ntot
    got_j = tasm.jacobian(tobj, timp, torch.tensor([0.3], dtype=torch.float64),
                          1e-4, torch.float64)
    got_r = tasm.residual(tobj, timp, expand_traj(twin, (1,)), twin,
                          torch.as_tensor(nu)[None])
    np.testing.assert_allclose(got_j[0].numpy(), want_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got_r[0].numpy(), want_r, rtol=0, atol=1e-9)


def _force_solve(dtype, jax_solve=True):
    """tests/test_newton_f32_force.py's solve in both packages: the 2D hopper,
    H = 10, configuration-force mode with the reference's 1e-100 γ/b weights
    (0 in float32), the shipped "ldl" KKT solver (which both packages leave
    for a pivoted LU in float32 force mode), one lane from the in-place
    gait moved by (0, 0.03, 0.01, 0). Every input is JAX's, in ``dtype``;
    without ``jax_solve`` the JAX package's solve is not run (None)."""
    env, h, mode = ci.flat_2d_lc, H_MPC, CONFIGURATION_FORCE
    jd = ci.dims_of(jhopper, env)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ref = jfrom_gait(jhopper, env, load_gait("hopper_2D", "gait_in_place"),
                     kappa=1e-4, dtype=jdt)
    lin = jlinearize(jhopper, env, ref, 1e-4)
    lin = type(lin)(*(x[:h] for x in lin))
    obj = jtracking(jd, h, q=np.tile(1e-1 * np.array([0.1, 3, 1, 3]), (h, 1)),
                    u=np.tile([1e-3, 1e0], (h, 1)),
                    gamma=1e-100 * np.ones((h, jd.nc)),
                    b=1e-100 * np.ones((h, jd.nb)), dtype=jdt)
    window = _slice_horizon(ref, h)
    nu0 = jnp.zeros((h, nd_of(jd, mode)), jdt)
    shift = jnp.asarray([0.0, 0.03, 0.01, 0.0], jdt)
    q0, q1 = ref.q[0] + shift, ref.q[1] + shift
    ip_opts = dataclasses.replace(jdefault_opts(1e-4, max_iter=30),
                                  refine=1 if dtype == torch.float32 else 0)
    n_opts = JNewtonOptions(r_tol=3e-4, max_iter=8, kkt_solver="ldl")
    want = jax.jit(lambda: jnewton(
        jd, mode, JNewtonAssembler(jd, h, mode), obj, lin, window, window,
        nu0, q0, q1, jnp.zeros((jd.nc,), jdt), ip_opts,
        n_opts))() if jax_solve else None

    dims = pt.Dims(nq=jd.nq, nu=jd.nu, nw=jd.nw, nc=jd.nc, nf=jd.nf, ne=jd.ne)
    conv = dict(dtype=dtype, device="cpu")
    twin = interop.contact_traj(window, **conv)
    t = lambda x: torch.as_tensor(np.array(x))[None]
    got = newton_solve(
        dims, mode, NewtonAssembler(dims, h, mode),
        interop.objective(obj, **conv), interop.linearized_data(lin, **conv),
        twin, expand_traj(twin, (1,)), t(nu0), t(q0), t(q1),
        torch.zeros((1, jd.nc), dtype=dtype), interop.ip_options(ip_opts),
        interop.newton_options(n_opts))
    n_total = h * (jd.nu + jd.nc + jd.nb + 2 * jd.nq + jd.nc + jd.nb)
    return got, want, n_total


# How far two float32 force-mode solves may part: the port's and JAX's pivoted
# LUs (LAPACK's getrf and XLA's) round apart. Measured on this solve (one
# Newton iteration in both, |u| ≤ 0.62): the two float32 u within 8.3e-7 of
# each other, each 1.7e-4 from its package's float64 u. The bound sits 12×
# over the spread of the two float32 solves and under their float32 error.
F32_FORCE_U_TOL = 1e-5


def test_hopper_newton_f32_force_mode():
    """Float32 configuration-force mode (tests/test_newton_f32_force.py), held
    as that file holds JAX: a finite step, at least one Newton iteration,
    within 0.2 of the float64 solve, the per-row residual under 2 r_tol;
    and within ``F32_FORCE_U_TOL`` of JAX's float32 solve."""
    got32, want32, n_total = _force_solve(torch.float32)
    got64, _, _ = _force_solve(torch.float64, jax_solve=False)
    assert got32.traj.u.dtype == torch.float32
    assert bool(torch.isfinite(got32.traj.u).all())
    assert np.isfinite(float(got32.r_norm[0]))
    assert int(got32.iterations[0]) >= 1
    du = (got32.traj.u[0].double() - got64.traj.u[0]).abs()
    assert float(du.max()) < 0.2, float(du.max())
    assert float(got32.r_norm[0]) / n_total < 2 * 3e-4
    np.testing.assert_allclose(got32.traj.u[0].numpy(),
                               np.asarray(want32.traj.u), rtol=0,
                               atol=F32_FORCE_U_TOL)
