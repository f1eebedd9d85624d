"""The 3D models of the port against the JAX package, float64 on the CPU:
the rotations, the 3D terrain's contact-frame rotation, the residual and
its Jacobians of the centroidal quadruped family and the point-foot
quadruped, ``from_gait`` on their gaits, and ``simulate`` of the
centroidal stand and of the wall
(tests/test_torch_centroidal_mpc.py holds the control path).

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances: the rotations and the 3D rotation 1e-12, the residual and its
Jacobians 1e-10, ``from_gait`` 1e-12, ``simulate`` 1e-9; flags and iteration counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu import models as jmodels
from contactimplicitmpc_tpu.control import from_gait as jfrom_gait
from contactimplicitmpc_tpu.env import environment_3d as jenvironment_3d
from contactimplicitmpc_tpu.models import rotations as jrot
from contactimplicitmpc_tpu.sim.residual import residual as jresidual
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import models as tmodels
from contactimplicitmpc_tpu_torch.control.trajectory import from_gait
from contactimplicitmpc_tpu_torch.models import rotations as prot
from contactimplicitmpc_tpu_torch.sim.residual import (
    residual, residual_theta_jacobian, residual_z_jacobian)

N_SAMPLE = 5


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


# ---- rotations --------------------------------------------------------------

def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


ROTATIONS = {
    "skew": (3, lambda x: x),
    "conjugate": (4, _unit),
    "l_multiply": (4, _unit),
    "r_multiply": (4, _unit),
    "attitude_jacobian": (4, _unit),
    "quaternion_rotation_matrix": (4, _unit),
    "mrp_quaternion_map": (3, lambda x: 0.5 * x),
    "mrp_rotation_matrix": (3, lambda x: 0.5 * x),
    "euler_rotation_matrix": (3, lambda x: x),
}


@pytest.mark.parametrize("name", sorted(ROTATIONS) + ["multiply"])
def test_rotations_match(name):
    """Each rotation function on 6 seeded inputs, batched in the port and
    mapped one by one in JAX, to 1e-12."""
    rng = np.random.default_rng(sorted(ROTATIONS).index(name)
                                if name in ROTATIONS else 99)
    if name == "multiply":
        a, b = (_unit(rng.standard_normal((6, 4))) for _ in range(2))
        want = jax.vmap(jrot.multiply)(jnp.asarray(a), jnp.asarray(b))
        got = prot.multiply(torch.as_tensor(a), torch.as_tensor(b))
    else:
        n, make = ROTATIONS[name]
        x = make(rng.standard_normal((6, n)))
        want = jax.vmap(getattr(jrot, name))(jnp.asarray(x))
        got = getattr(prot, name)(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def _surface(lib):
    return lambda x: 0.2 * lib.sin(3.0 * x[..., 0]) * lib.cos(2.0 * x[..., 1])


def _surface_grad(lib):
    def g(x):
        return lib.stack([0.6 * lib.cos(3.0 * x[..., 0]) * lib.cos(2.0 * x[..., 1]),
                          -0.4 * lib.sin(3.0 * x[..., 0])
                          * lib.sin(2.0 * x[..., 1])], axis=-1)
    return g


@pytest.mark.parametrize("given_gradient", [True, False])
def test_3d_rotation_matches(given_gradient):
    """``Environment.rotation`` of a 3D terrain (Rodrigues, environment.jl:
    59-77) at 8 seeded positions, on a surface with its gradient given and
    with the gradient by autodiff, to 1e-12; every rotation is orthonormal
    and takes the surface normal to the z axis."""
    x = np.random.default_rng(5).uniform(-1.0, 1.0, (8, 2))
    jgrad = _surface_grad(jnp) if given_gradient else None
    tgrad = None
    if given_gradient:
        tgrad = lambda xx: torch.stack(
            [0.6 * torch.cos(3.0 * xx[..., 0]) * torch.cos(2.0 * xx[..., 1]),
             -0.4 * torch.sin(3.0 * xx[..., 0]) * torch.sin(2.0 * xx[..., 1])],
            dim=-1)
    jenv = jenvironment_3d(_surface(jnp), jgrad)
    env = pt.environment_3d(_surface(torch), tgrad)
    want = jax.vmap(jenv.rotation)(jnp.asarray(x))
    got = env.rotation(torch.as_tensor(x))
    assert got.shape == (8, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    eye = got @ got.transpose(-1, -2)
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(3), eye.shape),
                               atol=1e-12)
    sg = env.surf_grad(torch.as_tensor(x))
    n = torch.cat([-sg, torch.ones_like(sg[:, :1])], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    np.testing.assert_allclose((got @ n[..., None])[..., 0].numpy(),
                               np.broadcast_to([0.0, 0.0, 1.0], (8, 3)),
                               atol=1e-12)


# ---- the models' residuals --------------------------------------------------

MODELS = {  # registry name: the gait whose knots the residual is taken at
    "centroidal_quadruped": ("centroidal_quadruped", "inplace_trot_v2"),
    "centroidal_quadruped_undamped": ("centroidal_quadruped",
                                      "inplace_trot_v2"),
    "centroidal_quadruped_box": ("centroidal_quadruped", "stand_v0"),
    "centroidal_quadruped_wall": ("centroidal_quadruped", "stand_v0"),
    "point_foot_quadruped": ("point_foot_quadruped", "inplace_trot_v1"),
}


def test_registry_holds_the_ported_models():
    assert set(MODELS) <= set(tmodels.MODELS)
    for name, model in tmodels.MODELS.items():
        jm = jmodels.MODELS[name]
        assert (model.nq, model.nu, model.nw, model.nc) == \
            (jm.nq, jm.nu, jm.nw, jm.nc), name


@pytest.mark.parametrize("name", sorted(MODELS))
def test_residual_and_jacobians_at_gait_knots(name):
    """r, ∂r/∂z and ∂r/∂θ at 3 knots of a gait (configurations from the
    gait, the contact variables seeded positive numbers), to 1e-10."""
    jm, model = jmodels.MODELS[name], tmodels.MODELS[name]
    jd = ci.dims_of(jm, ci.flat_3d_lc)
    gait = load_gait(*MODELS[name])
    rng = np.random.default_rng(11)
    knots = 3
    z = rng.uniform(0.1, 1.0, (knots, jd.nz))
    z[:, :jd.nq] = gait["q"][2:knots + 2]
    theta = np.concatenate([
        gait["q"][:knots], gait["q"][1:knots + 1], gait["u"][:knots],
        0.1 * rng.standard_normal((knots, jd.nw)),
        np.full((knots, 1), jm.mu_world), np.full((knots, 1), float(gait["h"]))],
        axis=1)

    def three(zz, tt):
        f = lambda a, b: jresidual(jm, ci.flat_3d_lc, a, b, 1e-4)
        return (f(zz, tt), jax.jacfwd(f, argnums=0)(zz, tt),
                jax.jacfwd(f, argnums=1)(zz, tt))

    want = jax.jit(jax.vmap(three))(jnp.asarray(z), jnp.asarray(theta))
    env = pt.flat_3d_lc
    for k in range(knots):
        zt, tt = torch.as_tensor(z[k]), torch.as_tensor(theta[k])
        got = (residual(model, env, zt, tt, 1e-4),
               residual_z_jacobian(model, env, zt, tt),
               residual_theta_jacobian(model, env, zt, tt))
        for g, w, what in zip(got, want, ("r", "rz", "rtheta")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w[k]), rtol=0,
                                       atol=1e-10, err_msg=f"{name} {what}")


def test_relative_state_cost_matches():
    q = ([0.01, 0.02, 1.0], [0.3, 0.4, 0.5], [0.2, 0.2, 1.0])
    want = jmodels.relative_state_cost(*q)
    got = tmodels.relative_state_cost(*q, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,gait", [
    ("centroidal_quadruped", "inplace_trot_v2"),
    ("point_foot_quadruped", "inplace_trot_v1")])
def test_from_gait_matches(name, gait):
    """``from_gait`` with ``update_friction`` on a 3D gait (the slacks from
    ϕ on flat_3d_lc, μ the model's), to 1e-12."""
    jm, model = jmodels.MODELS[name], tmodels.MODELS[name]
    g = load_gait(name, gait)
    want = jfrom_gait(jm, ci.flat_3d_lc, g, update_friction=True)
    got = from_gait(model, pt.flat_3d_lc, g, update_friction=True,
                    device="cpu")
    for field in got._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), rtol=0,
                                   atol=1e-12, err_msg=field)


# ---- simulate ---------------------------------------------------------------

def _same_sim(got, want):
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    for name in ("q", "u", "gamma", "b", "z"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), rtol=0, atol=1e-9,
                                   err_msg=name)


def test_simulate_centroidal_stand():
    """The stand gait's controls played open loop (held over N_sample
    steps) from its initial state and from one with the body 1 cm higher:
    2 lanes × 10 steps."""
    jm, model = jmodels.centroidal_quadruped, tmodels.centroidal_quadruped
    gait = load_gait("centroidal_quadruped", "stand_v0")
    h = float(gait["h"]) / N_SAMPLE
    q1 = np.repeat(gait["q"][1][None], 2, axis=0)
    q1[1, 2] += 0.01
    v1 = np.repeat(((gait["q"][1] - gait["q"][0]) / float(gait["h"]))[None],
                   2, axis=0)
    want = jax.jit(jax.vmap(lambda q, v: ci.simulate(
        jm, ci.flat_3d_lc, 10, h, q, v,
        policy=ci.open_loop_policy(jnp.asarray(gait["u"]), N_SAMPLE))))(
            jnp.asarray(q1), jnp.asarray(v1))
    got = pt.simulate(model, pt.flat_3d_lc, 10, h, torch.as_tensor(q1),
                      torch.as_tensor(v1),
                      policy=pt.open_loop_policy(gait["u"], N_SAMPLE,
                                                 device="cpu"))
    assert bool(pt.status(got).all())
    _same_sim(got, want)


def test_simulate_wall():
    """examples/centroidal_wall_sim.py's stance with the feet launched at
    the wall (8 contacts), at two speeds: 2 lanes × 10 steps; the feet stop
    at the wall."""
    jm, model = jmodels.centroidal_quadruped_wall, \
        tmodels.centroidal_quadruped_wall
    q1 = np.zeros((2, 18))
    q1[:, 2] = 0.3
    for i, (fx, fy) in enumerate([[0.1, 0.1], [0.1, -0.1], [-0.1, 0.1],
                                  [-0.1, -0.1]]):
        q1[:, 6 + 3 * i:9 + 3 * i] = [fx, fy, 0.05]
    v1 = np.zeros((2, 18))
    v1[0, 6::3], v1[1, 6::3] = 10.0, 6.0
    want = jax.jit(jax.vmap(lambda q, v: ci.simulate(
        jm, ci.flat_3d_lc, 10, 0.01, q, v)))(jnp.asarray(q1), jnp.asarray(v1))
    got = pt.simulate(model, pt.flat_3d_lc, 10, 0.01, torch.as_tensor(q1),
                      torch.as_tensor(v1))
    assert bool(pt.status(got).all())
    _same_sim(got, want)
    assert float(got.q[:, :, 6::3].max()) < model.x_wall + 1e-6
