"""The closed-form derivatives of the flamingo, the pushbot and the walled
cartpole (and the 3D hopper's contact Jacobian) against the ``torch.func``
derivatives of their own Lagrangians and kinematics, and their residuals
against the JAX package's, float64 on the CPU on seeded numpy inputs:

* ``mass_matrix``, ``bias`` and ``contact_jacobian`` against
  ``Model.mass_matrix``/``Model.bias`` (the Hessian and gradients of
  ``lagrangian``) and ``jacfwd`` of the contact points, to 1e-12;
* r, ∂r/∂z and ∂r/∂θ against JAX (whose derivatives are ``jax`` ones) at
  configurations with large velocities, to 1e-10;
* in float32, the flamingo's point Jacobians, contact Jacobian and mass
  matrix equal to the ``jacfwd`` form bit for bit: each entry of ``jacfwd``
  of the chained positions is one product arm · cos θ or arm · sin θ, or an
  exact zero, and the mass matrix is the same product of the same values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu import models as jmodels
from contactimplicitmpc_tpu.sim.residual import residual as jresidual

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import models as tmodels
from contactimplicitmpc_tpu_torch.models.base import Model
from contactimplicitmpc_tpu_torch.models.flamingo import _COMS, _FEET
from contactimplicitmpc_tpu_torch.sim.residual import (
    residual, residual_theta_jacobian, residual_z_jacobian)

NAMES = ["flamingo", "pushbot", "walledcartpole"]
# the contact Jacobians written out, with the flat terrain of their points
CONTACT = {"flamingo": "flat_2d_lc", "pushbot": "flat_2d_lc",
           "walledcartpole": "flat_2d_lc", "hopper_3D": "flat_3d_lc"}


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


def _states(name, n, dtype=torch.float64):
    """n seeded (q, v) pairs: angles over a full turn, velocities of a few
    units (the bias's centripetal terms grow with v²)."""
    model = tmodels.MODELS[name]
    rng = np.random.default_rng(40 + list(CONTACT).index(name))
    q = rng.uniform(-np.pi, np.pi, (n, model.nq))
    v = rng.uniform(-3.0, 3.0, (n, model.nq))
    return (torch.as_tensor(q, dtype=dtype), torch.as_tensor(v, dtype=dtype))


def _contact_jacobian_by_jacfwd(model, q):
    """The contact Jacobian from ``jacfwd`` of the contact points: the
    flamingo's toe and heel positions and the 3D hopper's foot; for the two
    wall models each wall's frame R applied to ∂(slider end or tip)/∂q plus
    the wall's own deflection term."""
    if isinstance(model, (tmodels.Flamingo, tmodels.Hopper3D)):
        return jacfwd(lambda qq: model.kinematics(qq).reshape(-1))(q)
    if isinstance(model, tmodels.PushBot):
        jd = jacfwd(model._kin_d)(q)
        walls = [jd, jd]
    else:
        # the tip's gap to wall i also moves with that wall's deflection
        jt = jacfwd(model._tip)(q)
        deflect = torch.zeros((2, 2, 4), dtype=q.dtype)
        deflect[0, 0, 2] = deflect[1, 0, 3] = -1.0
        walls = [jt + deflect[0], jt + deflect[1]]
    rot = [torch.tensor([[0.0, -1.0], [1.0, 0.0]], dtype=q.dtype),
           torch.tensor([[0.0, 1.0], [-1.0, 0.0]], dtype=q.dtype)]
    return torch.cat([r @ w for r, w in zip(rot, walls)], dim=0)


@pytest.mark.parametrize("name", NAMES)
def test_mass_matrix_and_bias_match_lagrangian(name):
    """M(q) against the Hessian of L in v and C(q, v) against
    ∂²L/∂v∂q · v − ∂L/∂q, at 8 seeded states, to 1e-12."""
    model = tmodels.MODELS[name]
    qs, vs = _states(name, 8)
    for q, v in zip(qs, vs):
        np.testing.assert_allclose(model.mass_matrix(q).numpy(),
                                   Model.mass_matrix(model, q).numpy(),
                                   rtol=0, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(model.bias(q, v).numpy(),
                                   Model.bias(model, q, v).numpy(),
                                   rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("name", list(CONTACT))
def test_contact_jacobian_matches_jacfwd(name):
    """J(q) against ``jacfwd`` of the contact points, and each contact's
    normal row against ``jacfwd`` of ϕ, at 8 seeded states, to 1e-12."""
    model = tmodels.MODELS[name]
    env = getattr(pt, CONTACT[name])
    ne = env.dim
    for q in _states(name, 8)[0]:
        got = model.contact_jacobian(q)
        np.testing.assert_allclose(
            got.numpy(), _contact_jacobian_by_jacfwd(model, q).numpy(),
            rtol=0, atol=1e-12, err_msg=name)
        dphi = jacfwd(lambda qq: model.phi(env, qq))(q)
        np.testing.assert_allclose(got[ne - 1::ne].numpy(), dphi.numpy(),
                                   rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_residual_and_jacobians_match_jax(name):
    """r, ∂r/∂z and ∂r/∂θ at 2 seeded points whose q0, q1, q2 differ by
    up to 0.05 a step of 0.01 (velocities of a few units), to 1e-10."""
    jm, model = jmodels.MODELS[name], tmodels.MODELS[name]
    jenv, env = ci.flat_2d_lc, pt.flat_2d_lc
    jd = ci.dims_of(jm, jenv)
    rng = np.random.default_rng(50 + NAMES.index(name))
    z = rng.uniform(0.1, 1.0, (2, jd.nz))
    theta = rng.uniform(-0.3, 0.3, (2, jd.ntheta))
    q1 = rng.uniform(-1.0, 1.0, (2, jd.nq))
    theta[:, jd.iq1] = q1
    theta[:, jd.iq0] = q1 - rng.uniform(-0.05, 0.05, (2, jd.nq))
    z[:, jd.iq2] = q1 + rng.uniform(-0.05, 0.05, (2, jd.nq))
    theta[:, jd.imu] = jm.mu_world
    theta[:, jd.ih] = 0.01

    def three(zz, tt):
        f = lambda a, b: jresidual(jm, jenv, a, b, 1e-4)
        return (f(zz, tt), jax.jacfwd(f, argnums=0)(zz, tt),
                jax.jacfwd(f, argnums=1)(zz, tt))

    want = jax.jit(three)
    for k in range(len(z)):
        w = want(jnp.asarray(z[k]), jnp.asarray(theta[k]))
        zt, tt = torch.as_tensor(z[k]), torch.as_tensor(theta[k])
        got = (residual(model, env, zt, tt, 1e-4),
               residual_z_jacobian(model, env, zt, tt),
               residual_theta_jacobian(model, env, zt, tt))
        for g, wk, what in zip(got, w, ("r", "rz", "rtheta")):
            np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=0,
                                       atol=1e-10, err_msg=f"{name} {what}")


def test_flamingo_float32_jacobians_bit_for_bit():
    """In float32 the closed-form point Jacobians (bodies and contacts), the
    contact Jacobian and the mass matrix equal the ``jacfwd`` form of the
    chained positions exactly, at 16 seeded configurations."""
    model = tmodels.flamingo
    for q in _states("flamingo", 16, torch.float32)[0]:
        jac_coms = jacfwd(model._com_positions)(q)
        assert torch.equal(model._point_jacobians(q, _COMS), jac_coms)
        feet = jacfwd(model.kinematics)(q)
        assert torch.equal(model._point_jacobians(q, _FEET), feet)
        assert torch.equal(model.contact_jacobian(q), feet.reshape(8, 9))
        masses = model.const("masses", model._masses, q)
        m_jacfwd = (torch.einsum("b,bin,bim->nm", masses, jac_coms, jac_coms)
                    + torch.diag(model.const("rot_diag", model._rot_diag, q)))
        assert torch.equal(model.mass_matrix(q), m_jacfwd)
