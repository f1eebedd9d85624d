"""The quadruped trotting onto the piecewise slope with altitude discovery
in the closed loop (tests/test_mpc_terrain.py::test_quadruped_piecewise_mpc),
the port against the JAX package, float64 on the CPU.

That test's configuration: ``mpc_rollout`` on piecewise1_2d_lc with gait2,
direct-mode Newton in configuration mode with the adaptive knot solve, H
10, N_sample 5, κ 1e-4, the test's knot and sim options, altitude update
at 0.05, warm-start floor 1e-2; one lane, two control periods (10 sim
steps). Tolerance: q and u to 1e-8, flags and iteration counts exactly.
The full 250 steps stay with the JAX test. Most of this file's time is
JAX compiling the quadruped's closed loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.control import (CONFIGURATION, CIMPCOptions,
                                            NewtonOptions as JNewtonOptions,
                                            from_gait as jfrom_gait,
                                            initial_conditions as jinitial,
                                            tracking_objective as jtracking)
from contactimplicitmpc_tpu.control.rollout import mpc_rollout as jmpc_rollout
from contactimplicitmpc_tpu.models import quadruped as jquadruped
from contactimplicitmpc_tpu.sim.interior_point import IPOptions as JIPOptions
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
from contactimplicitmpc_tpu_torch.models import quadruped


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


def test_quadruped_piecewise_prefix_matches():
    """tests/test_mpc_terrain.py's trot onto the piecewise slope, 10 sim
    steps (2 control periods) of the nominal lane."""
    env, jenv = pt.piecewise1_2d_lc, ci.piecewise1_2d_lc
    dims = ci.dims_of(jquadruped, jenv)
    ref = jfrom_gait(jquadruped, jenv, load_gait("quadruped", "gait2"),
                     update_friction=True)
    n_sample, h_mpc, kappa, steps = 5, 10, 1.0e-4, 10
    qw = 1e-2 * np.array([5.0, 0.02, 0.10] + [0.25] * 8)
    obj = jtracking(dims, h_mpc, q=np.tile(qw, (h_mpc, 1)),
                    u=3e-2 * np.ones((h_mpc, dims.nu)),
                    gamma=1e-100 * np.ones((h_mpc, dims.nc)),
                    b=1e-100 * np.ones((h_mpc, dims.nb)))
    mpc_ip = JIPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=100,
                        undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    sim_opts = JIPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=100,
                          undercut=float("inf"), max_ls=6)
    n_opts = JNewtonOptions(r_tol=3e-4, max_iter=5)
    mpc_opts = CIMPCOptions(altitude_update=True,
                            altitude_impact_threshold=0.05)
    q1, v1 = (np.asarray(x) for x in jinitial(ref))
    want = jax.jit(lambda q, v: jmpc_rollout(
        jquadruped, jenv, ref, obj, steps, h_mpc, n_sample, kappa,
        CONFIGURATION, q, v, n_opts=n_opts, ip_opts=mpc_ip,
        sim_opts=sim_opts, warm_start_floor=1e-2, mpc_opts=mpc_opts))(
        jnp.asarray(q1), jnp.asarray(v1))
    got = mpc_rollout(
        quadruped, env, interop.contact_traj(ref, device="cpu"),
        interop.objective(obj, device="cpu"), steps, h_mpc, n_sample, kappa,
        CONFIGURATION, torch.tensor(q1)[None], torch.tensor(v1)[None],
        n_opts=interop.newton_options(n_opts),
        ip_opts=interop.ip_options(mpc_ip),
        sim_opts=interop.ip_options(sim_opts), warm_start_floor=1e-2,
        mpc_opts=interop.cimpc_options(mpc_opts))
    assert bool(np.asarray(want.sim_converged).all())
    for name in ("sim_converged", "newton_iterations", "sim_iterations"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("q", "u"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-8, err_msg=name)
    assert float(got.q[0, -1, 0] - got.q[0, 1, 0]) > 0.0
