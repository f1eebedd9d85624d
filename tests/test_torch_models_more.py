"""The models this slice ports, against the JAX package, float64 on the
CPU: the 3D particle, the pushbot, the walled cartpole, the 3D hopper, the
flamingo and the quadruped with a payload. The registry's keys; each
model's scalar constants (the models carry no weights: their parameters
are these constants); the residual and its Jacobians at seeded points
(tests/test_torch_drops.py holds a short ``simulate`` of each drop of
tests/test_models_more.py); and every model's linearization in float32.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances: the residual and its Jacobians 1e-10 against JAX; float32
against float64 1e-3 of the scale.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu import models as jmodels
from contactimplicitmpc_tpu.sim.residual import residual as jresidual
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import models as tmodels
from contactimplicitmpc_tpu_torch.control.linearized import \
    linearize_trajectory
from contactimplicitmpc_tpu_torch.sim.residual import (
    residual, residual_theta_jacobian, residual_z_jacobian)

# registry name: (3D terrain?, the gait whose configurations the residual
# is taken at, or None for seeded configurations)
NEW = {"particle": (True, None),
       "pushbot": (False, None),
       "walledcartpole": (False, None),
       "hopper_3D": (True, ("hopper_3D", "gait_forward")),
       "flamingo": (False, ("flamingo", "gait_forward_36_4")),
       "quadruped_payload": (False, ("quadruped", "gait2"))}


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


def test_registry_matches():
    """The port's ``MODELS`` has the JAX package's 15 keys, and each model
    the same sizes."""
    assert list(tmodels.MODELS) == list(jmodels.MODELS)
    assert len(tmodels.MODELS) == 15
    for name, model in tmodels.MODELS.items():
        jm = jmodels.MODELS[name]
        assert (model.nq, model.nu, model.nw, model.nc) == \
            (jm.nq, jm.nu, jm.nw, jm.nc), name


@pytest.mark.parametrize("name", list(NEW))
def test_constants_match(name):
    """Every number the JAX instance holds (masses, lengths, inertias,
    friction, gravity, the joint friction) is the port instance's."""
    jm, model = jmodels.MODELS[name], tmodels.MODELS[name]
    held = {k: v for k, v in vars(jm).items()
            if isinstance(v, (int, float, tuple))}
    assert len(held) >= 4, held
    for key, value in held.items():
        assert getattr(model, key) == value, (name, key)


def _inputs(name, jd):
    """(z, θ) at 3 seeded points: the contact variables positive, the
    configurations from the gait where the model has one."""
    is_3d, gait = NEW[name]
    rng = np.random.default_rng(list(NEW).index(name))
    knots = 3
    z = rng.uniform(0.1, 1.0, (knots, jd.nz))
    theta = rng.uniform(-0.3, 0.3, (knots, jd.ntheta))
    if gait is not None:
        g = load_gait(*gait)
        z[:, :jd.nq] = g["q"][2:knots + 2]
        theta[:, jd.iq0] = g["q"][:knots]
        theta[:, jd.iq1] = g["q"][1:knots + 1]
    theta[:, jd.imu] = jmodels.MODELS[name].mu_world
    theta[:, jd.ih] = 0.01
    return z, theta


@pytest.mark.parametrize("name", list(NEW))
def test_residual_and_jacobians(name):
    """r, ∂r/∂z and ∂r/∂θ at the seeded points, to 1e-10."""
    jm, model = jmodels.MODELS[name], tmodels.MODELS[name]
    is_3d = NEW[name][0]
    jenv = ci.flat_3d_lc if is_3d else ci.flat_2d_lc
    env = pt.flat_3d_lc if is_3d else pt.flat_2d_lc
    z, theta = _inputs(name, ci.dims_of(jm, jenv))

    def three(zz, tt):
        f = lambda a, b: jresidual(jm, jenv, a, b, 1e-4)
        return (f(zz, tt), jax.jacfwd(f, argnums=0)(zz, tt),
                jax.jacfwd(f, argnums=1)(zz, tt))

    want = jax.jit(jax.vmap(three))(jnp.asarray(z), jnp.asarray(theta))
    for k in range(len(z)):
        zt, tt = torch.as_tensor(z[k]), torch.as_tensor(theta[k])
        got = (residual(model, env, zt, tt, 1e-4),
               residual_z_jacobian(model, env, zt, tt),
               residual_theta_jacobian(model, env, zt, tt))
        for g, w, what in zip(got, want, ("r", "rz", "rtheta")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w[k]), rtol=0,
                                       atol=1e-10, err_msg=f"{name} {what}")


def _flat(model):
    """The model's flat terrain: 3D where its contact points are."""
    return (pt.flat_3d_lc if model.kinematics(torch.zeros(model.nq)).shape[-1]
            == 3 else pt.flat_2d_lc)


@pytest.mark.parametrize("name", list(tmodels.MODELS))
def test_float32_linearization(name):
    """Every model's residual and its Jacobians over a batch of knots
    (``linearize_trajectory``, the knots' linearization on the card) in
    float32: float32 out, within 1e-3 of each block's scale of the float64
    ones. Under ``torch.func``'s forward mode a Python number with a 0-dim
    float32 tensor takes a float64 tangent, which broke the pushbot's and
    the walled cartpole's Jacobians in float32 before they kept their
    scalars in one-element tensors."""
    model = tmodels.MODELS[name]
    env = _flat(model)
    dims = pt.dims_of(model, env)
    rng = np.random.default_rng(30 + list(tmodels.MODELS).index(name))
    z = rng.uniform(0.1, 1.0, (3, dims.nz))
    theta = rng.uniform(-0.3, 0.3, (3, dims.ntheta))
    theta[:, dims.ih] = 0.01
    theta[:, dims.imu] = model.mu_world
    knots = lambda dtype: SimpleNamespace(z=torch.as_tensor(z, dtype=dtype),
                                          theta=torch.as_tensor(theta,
                                                                dtype=dtype))
    got = linearize_trajectory(model, env, knots(torch.float32), 1e-4)
    want = linearize_trajectory(model, env, knots(torch.float64), 1e-4)
    for field in ("r0", "rz0", "rtheta0"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == torch.float32, (field, g.dtype)
        scale = max(1.0, float(w.abs().max()))
        assert float((g.double() - w).abs().max()) <= 1e-3 * scale, field
