"""A short ``simulate`` of each drop of tests/test_models_more.py in the
port against the JAX package, float64 on the CPU: the 3D hopper dropped
onto flat ground, the pushbot tilted into its wall, the walled cartpole's
pole falling to a wall, 30 steps each (the JAX tests run 100-300).

The pushbot's and the cartpole's mass matrix and bias are written out in
the port (the JAX package's are ``jax`` derivatives of the Lagrangians;
tests/test_torch_closed_form.py holds the two forms to each other).
Tolerances: q, the impulses and z to 1e-8, flags and iteration counts
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu import models as jmodels

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import models as tmodels


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


# tests/test_models_more.py's drops, cut to 30 steps
DROPS = {"hopper_3D": ([0.0, 0.0, 0.6, 0.0, 0.0, 0.0, 0.5], True),
         "pushbot": ([0.3, 0.0], False),
         "walledcartpole": ([0.2, 0.0, 0.0, 0.0], False)}


@pytest.mark.parametrize("name", list(DROPS))
def test_simulate_drops(name):
    """Each drop from its initial state at rest, 30 steps of 0.01 with the
    default sim options: q and the impulses to 1e-8, flags and iteration
    counts exactly; every signed distance stays above -1e-6."""
    jm, model = jmodels.MODELS[name], tmodels.MODELS[name]
    q1, is_3d = DROPS[name]
    jenv = ci.flat_3d_lc if is_3d else ci.flat_2d_lc
    env = pt.flat_3d_lc if is_3d else pt.flat_2d_lc
    steps, h = 30, 0.01
    want = jax.jit(lambda q: ci.simulate(jm, jenv, steps, h, q,
                                         jnp.zeros_like(q)))(
        jnp.asarray(q1, jnp.float64))
    got = pt.simulate(model, env, steps, h,
                      torch.tensor([q1], dtype=torch.float64),
                      torch.zeros((1, len(q1)), dtype=torch.float64))
    assert bool(pt.status(got).all()) and bool(ci.status(want))
    np.testing.assert_array_equal(got.converged[0].numpy(), want.converged)
    np.testing.assert_array_equal(got.iterations[0].numpy(), want.iterations)
    for field in ("q", "gamma", "b", "z"):
        np.testing.assert_allclose(getattr(got, field)[0].numpy(),
                                   np.asarray(getattr(want, field)), rtol=0,
                                   atol=1e-8, err_msg=field)
    phi = torch.func.vmap(lambda q: model.phi(env, q))(got.q[0])
    assert float(phi.min()) > -1e-6
