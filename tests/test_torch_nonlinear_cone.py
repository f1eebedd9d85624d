"""The nonlinear (second-order) friction cone in the port against the JAX
package, float64 on the CPU on seeded numpy inputs:

* ``soc_product``, and ``soc_step_length`` on the three cases of
  tests/test_nonlinear_cone.py and on 64 seeded (u, du) pairs that reach
  every branch (the degenerate quadratic's linear root, the 1e20 sentinel,
  the scalar face, the step of 1), to 1e-12; ``NCConeLayout``'s index sets;
* r, ∂r/∂z and ∂r/∂θ of the 2D and 3D particle on flat_2d_nc and
  flat_3d_nc and of the 3D hopper on flat_3d_nc, to 1e-10; the ``alt``
  keyword of ``residual``;
* ``z_initialize``, ``z_warmstart`` and ``pack_z_consistent`` for both
  cones, to 1e-12;
* ``simulate`` for the runs of tests/test_nonlinear_cone.py cut to 70
  steps (that file runs 100 and 150; every run lands at step 45 and rests
  from step 46): the 3D drop and the 3D slide at v = (1, 2, 0) as two
  lanes, and the 2D drop; q, z and the impulses to 1e-8, flags and
  iteration counts exactly, and that file's own checks (at rest to 1e-6,
  the slide's x:y = 1:2 to 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu import models as jmodels
from contactimplicitmpc_tpu.ops import soc as jsoc
from contactimplicitmpc_tpu.sim.interior_point import \
    z_initialize as jz_initialize
from contactimplicitmpc_tpu.sim.interior_point import \
    z_warmstart as jz_warmstart
from contactimplicitmpc_tpu.sim.residual import \
    pack_z_consistent as jpack_z_consistent
from contactimplicitmpc_tpu.sim.residual import residual as jresidual

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import models as tmodels
from contactimplicitmpc_tpu_torch.ops import soc as tsoc
from contactimplicitmpc_tpu_torch.sim.residual import (
    residual_theta_jacobian, residual_z_jacobian)

TIGHT = dict(rtol=0, atol=1e-12)


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


def t(x):
    return torch.as_tensor(np.array(x))


def test_soc_step_length_basic():
    """tests/test_nonlinear_cone.py's three cases: a step of 1 along the
    axis, the apex at 0.5, the side at 0.5."""
    u = t([1.0, 0.0, 0.0])
    one = t(1.0)
    for du, want in (([0.5, 0.0, 0.0], 1.0), ([2.0, 0.0, 0.0], 0.5),
                     ([0.0, -2.0, 0.0], 0.5)):
        got = float(tsoc.soc_step_length(u, t(du), one))
        assert got == float(jsoc.soc_step_length(jnp.asarray(u.numpy()),
                                                 jnp.asarray(du), 1.0))
        assert abs(got - want) < 1e-6


def _soc_pairs(n=64, dim=3):
    """n seeded (u, du, τ): u inside the cone; du in four groups of 16 —
    random directions, directions on the cone's surface (a = 0 exactly,
    from Pythagorean triples times powers of two: the linear root; a
    surface direction whose a only rounds to 1e-16 leaves the root to
    cancellation in both packages), directions that leave the cone only
    through the scalar face (d0 > 0 with d̄ = 0), and directions into the
    cone (the sentinel: no positive root, a step of 1)."""
    rng = np.random.default_rng(60)
    u = rng.uniform(-0.5, 0.5, (n, dim))
    u[:, 0] = np.linalg.norm(u[:, 1:], axis=1) + rng.uniform(0.05, 1.0, n)
    du = rng.standard_normal((n, dim))
    q = n // 4
    triples = np.array([[5.0, 3.0, 4.0], [5.0, 4.0, 3.0], [13.0, 5.0, 12.0],
                        [1.0, 1.0, 0.0], [1.0, 0.0, -1.0], [5.0, -4.0, 3.0]])
    du[q:2 * q] = (triples[rng.integers(0, len(triples), q)]
                   * rng.choice([-1.0, 1.0], (q, 1))
                   * 2.0 ** rng.integers(-3, 2, (q, 1)))
    du[2 * q:3 * q, 1:] = 0.0
    du[2 * q:3 * q, 0] = rng.uniform(0.5, 3.0, q)
    du[3 * q:] = -u[3 * q:] * rng.uniform(0.1, 2.0, (q, 1))
    tau = rng.uniform(0.9, 1.0, n)
    return u, du, tau


def test_soc_product_and_step_length_match():
    """Both functions over a leading batch of 64 pairs, to 1e-12, with
    every branch taken by some pair."""
    u, du, tau = _soc_pairs()
    v = np.abs(np.random.default_rng(61).standard_normal(u.shape))
    np.testing.assert_allclose(
        tsoc.soc_product(t(u), t(v)).numpy(),
        jax.vmap(jsoc.soc_product)(jnp.asarray(u), jnp.asarray(v)), **TIGHT)
    want = np.asarray(jax.vmap(jsoc.soc_step_length)(
        jnp.asarray(u), jnp.asarray(du), jnp.asarray(tau)))
    got = tsoc.soc_step_length(t(u), t(du), t(tau)).numpy()
    np.testing.assert_allclose(got, want, **TIGHT)
    # the branches: a degenerate quadratic, a limiting scalar face, steps
    # cut short and steps of 1
    a = du[:, 0] ** 2 - np.sum(du[:, 1:] ** 2, axis=1)
    assert np.sum(np.abs(a) <= 1e-12) >= 8
    face = (du[:, 0] > 0) & np.all(du[:, 1:] == 0, axis=1)
    assert np.sum(face & (got < 1.0)) >= 4
    assert np.sum(got == 1.0) >= 8 and np.sum(got < 1.0) >= 16
    # and the per-contact form: lanes × contacts × (nf + 1), τ per lane
    got2 = tsoc.soc_step_length(t(u).reshape(8, 8, 3), t(du).reshape(8, 8, 3),
                                t(tau[:8])[:, None])
    want2 = jax.vmap(jsoc.soc_step_length)(
        jnp.asarray(u), jnp.asarray(du), jnp.asarray(np.repeat(tau[:8], 8)))
    np.testing.assert_allclose(got2.numpy().reshape(-1), want2, **TIGHT)


@pytest.mark.parametrize("name,env", [("particle_2D", "flat_2d_nc"),
                                      ("particle", "flat_3d_nc"),
                                      ("hopper_3D", "flat_3d_nc")])
def test_layout_matches(name, env):
    """``NCConeLayout``'s index sets equal JAX's, and its bilinear rows
    fill the residual's bilinear block (``dims.ibil``) in order."""
    jd = ci.dims_of(jmodels.MODELS[name], getattr(ci, env))
    got, want = tsoc.NCConeLayout(jd), jsoc.NCConeLayout(jd)
    for key in ("ort_a", "ort_b", "soc_u", "soc_v", "bil_ort_rows",
                "bil_soc_rows"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    rows = np.concatenate([got.bil_ort_rows, got.bil_soc_rows.reshape(-1)])
    np.testing.assert_array_equal(rows, np.arange(jd.ibil.start,
                                                  jd.ibil.stop))


def _points(jd, seed, knots=2):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.1, 1.0, (knots, jd.nz))
    theta = rng.uniform(-0.3, 0.3, (knots, jd.ntheta))
    z[:, jd.iq2] = theta[:, jd.iq1] + rng.uniform(-0.02, 0.02, (knots, jd.nq))
    theta[:, jd.imu] = 0.5
    theta[:, jd.ih] = 0.01
    return z, theta


@pytest.mark.parametrize("name,env", [("particle_2D", "flat_2d_nc"),
                                      ("particle", "flat_3d_nc"),
                                      ("hopper_3D", "flat_3d_nc")])
def test_residual_and_jacobians(name, env):
    """r (κ = 1e-4 and with an altitude offset), ∂r/∂z and ∂r/∂θ at two
    seeded points, to 1e-10."""
    jm, model = jmodels.MODELS[name], tmodels.MODELS[name]
    jenv, tenv = getattr(ci, env), getattr(pt, env)
    jd = ci.dims_of(jm, jenv)
    z, theta = _points(jd, 70 + jd.nq)
    alt = np.random.default_rng(71).uniform(-0.1, 0.1, jd.nc)

    def four(zz, tt):
        f = lambda a, b: jresidual(jm, jenv, a, b, 1e-4)
        return (f(zz, tt), jresidual(jm, jenv, zz, tt, 1e-4, jnp.asarray(alt)),
                jax.jacfwd(f, argnums=0)(zz, tt),
                jax.jacfwd(f, argnums=1)(zz, tt))

    want = jax.jit(four)
    for k in range(len(z)):
        w = want(jnp.asarray(z[k]), jnp.asarray(theta[k]))
        zt, tt = t(z[k]), t(theta[k])
        got = (pt.residual(model, tenv, zt, tt, 1e-4),
               pt.residual(model, tenv, zt, tt, 1e-4, alt=t(alt)),
               residual_z_jacobian(model, tenv, zt, tt),
               residual_theta_jacobian(model, tenv, zt, tt))
        for g, wk, what in zip(got, w, ("r", "r alt", "rz", "rtheta")):
            np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=0,
                                       atol=1e-10, err_msg=f"{name} {what}")


@pytest.mark.parametrize("env", ["flat_3d_lc", "flat_3d_nc"])
def test_initial_points_match(env):
    """``z_initialize`` and ``z_warmstart`` (the nonlinear cone falls back
    to the cold start; the linearized one with a given draw) over a batch,
    and ``pack_z_consistent`` a sample at a time, for the 3D hopper: to
    1e-12."""
    jm, model = jmodels.hopper_3d, tmodels.hopper_3d
    jenv, tenv = getattr(ci, env), getattr(pt, env)
    jd = ci.dims_of(jm, jenv)
    cone = jenv.cone
    rng = np.random.default_rng(80)
    q = rng.uniform(-0.3, 0.3, (3, jd.nq))
    z_prev = rng.uniform(0.1, 1.0, (3, jd.nz))
    want = jax.vmap(lambda qq: jz_initialize(jd, qq, cone=cone))(
        jnp.asarray(q))
    np.testing.assert_allclose(pt.z_initialize(jd, t(q), cone=cone).numpy(),
                               want, **TIGHT)
    key = jax.random.PRNGKey(3)
    want = jax.vmap(lambda qq, zz: jz_warmstart(jd, qq, zz, key, cone=cone))(
        jnp.asarray(q), jnp.asarray(z_prev))
    draw = jax.random.uniform(key, (jd.nz - jd.nq,), jnp.float64)
    got = pt.z_warmstart(jd, t(q), t(z_prev), cone=cone,
                         draw=t(np.asarray(draw)).expand(3, -1))
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    for k in range(3):
        parts = [rng.uniform(0.1, 1.0, n) for n in (jd.nc, jd.nb, jd.nc,
                                                      jd.nb)]
        want = jpack_z_consistent(jm, jenv, jnp.asarray(q[k]),
                                  *map(jnp.asarray, parts))
        got = pt.pack_z_consistent(model, tenv, t(q[k]), *map(t, parts))
        np.testing.assert_allclose(got.numpy(), want, **TIGHT)


def _compare(got, want, lane=0):
    np.testing.assert_array_equal(got.converged[lane].numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.iterations[lane].numpy(),
                                  np.asarray(want.iterations))
    for field in ("q", "z", "gamma", "b"):
        np.testing.assert_allclose(getattr(got, field)[lane].numpy(),
                                   np.asarray(getattr(want, field)), rtol=0,
                                   atol=1e-8, err_msg=field)


def test_particle_3d_drop_and_slide():
    """The 3D particle dropped at rest and thrown at v = (1, 2, 0) from
    height 1 onto flat_3d_nc, two lanes of 70 steps of 0.01 against the
    JAX package's runs with its default options; both come to rest on the
    ground (from step 46), and the isotropic cone keeps the slide's
    direction."""
    steps, h = 70, 0.01
    v1 = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 0.0]])
    q1 = np.array([[0.0, 0.0, 1.0]] * 2)
    run = jax.jit(lambda q, v: ci.simulate(jmodels.particle, ci.flat_3d_nc,
                                           steps, h, q, v))
    got = pt.simulate(tmodels.particle, pt.flat_3d_nc, steps, h, t(q1), t(v1))
    assert bool(pt.status(got).all())
    for lane in range(2):
        want = run(jnp.asarray(q1[lane]), jnp.asarray(v1[lane]))
        assert bool(ci.status(want))
        _compare(got, want, lane)
    q = got.q.numpy()
    np.testing.assert_allclose(q[0, -1], 0.0, atol=1e-6)
    assert abs(q[1, -1, 2]) < 1e-6
    np.testing.assert_allclose((q[1, -1] - q[1, -2]) / h, 0.0, atol=1e-5)
    assert abs(q[1, -1, 0] * 2.0 - q[1, -1, 1]) < 1e-3


def test_particle_2d_drop():
    """The 2D particle dropped at rest from height 1 onto flat_2d_nc, 70
    steps, against the JAX package's run; at rest on the ground (from step
    46)."""
    q1, v1 = np.array([0.0, 1.0]), np.zeros(2)
    want = jax.jit(lambda: ci.simulate(jmodels.particle_2d, ci.flat_2d_nc,
                                       70, 0.01, jnp.asarray(q1),
                                       jnp.asarray(v1)))()
    got = pt.simulate(tmodels.particle_2d, pt.flat_2d_nc, 70, 0.01,
                      t(q1[None]), t(v1[None]))
    assert bool(pt.status(got).all()) and bool(ci.status(want))
    _compare(got, want)
    np.testing.assert_allclose(got.q[0, -1].numpy(), 0.0, atol=1e-6)


def test_ip_solve_takes_the_nonlinear_cone():
    """``ip_solve(..., cone="nonlinear")`` on a batch of two 3D-particle
    steps (one sliding, one landing) with sensitivities: both converge, and
    dz is −rz⁻¹ rθ at the solution (the ``torch.func`` Jacobians and a
    dense solve), to 1e-10. The simulations above hold its iterates,
    flags and iteration counts to JAX's."""
    jd = ci.dims_of(jmodels.particle, ci.flat_3d_nc)
    q1 = np.array([[0.0, 0.0, 0.02], [0.1, 0.0, 0.005]])
    q0 = q1 - 0.01 * np.array([[0.5, 1.0, -0.5], [0.0, 0.0, -1.0]])
    theta = t(np.concatenate([q0, q1, np.zeros((2, jd.nu + jd.nw)),
                              np.full((2, 1), 0.5), np.full((2, 1), 0.01)],
                             1))
    model, env = tmodels.particle, pt.flat_3d_nc
    res = pt.ip_solve(
        jd, lambda a, b, k: pt.residual(model, env, a, b, k),
        pt.z_initialize(jd, t(q1), cone="nonlinear"), theta,
        pt.IPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=60, diff_sol=True),
        cone="nonlinear")
    assert bool(res.converged.all()), res.iterations.tolist()
    rz = torch.func.vmap(lambda z, th: residual_z_jacobian(
        model, env, z, th))(res.z, theta)
    rt = torch.func.vmap(lambda z, th: residual_theta_jacobian(
        model, env, z, th))(res.z, theta)
    np.testing.assert_allclose(res.dz.numpy(),
                               (-torch.linalg.solve(rz, rt)).numpy(),
                               rtol=0, atol=1e-10)
