"""Structure-mode parkour: the 2D hopper on the hard staircase with the O(H)
Riccati Newton and online altitude discovery
(tests/test_mpc_parkour_structure.py), the port against the JAX package,
float64 on the CPU.

That test's configuration: ``mpc_rollout`` with the controller on
flat_2d_lc and the physics on ``sim_env=stairs3_2d_lc``, gait
hopper_stair_ref, structure-mode Newton in configuration mode with the
adaptive knot solve (``default_mpc_ip_options(κ, 30)``), H 10, N_sample 10,
κ 2e-4, altitude update at 0.1, warm-start floor 1e-2, ``stride_idx=(0,
1)``; one lane, two control periods (20 sim steps). Tolerance: q and u to
1e-8, flags and iteration counts exactly. The full 2400 steps stay with the
JAX test.
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
                                            tracking_velocity_objective as
                                            jtracking_velocity)
from contactimplicitmpc_tpu.control.implicit_dynamics import \
    default_mpc_ip_options as jdefault_mpc_ip_options
from contactimplicitmpc_tpu.control.rollout import mpc_rollout as jmpc_rollout
from contactimplicitmpc_tpu.models import hopper_2d as jhopper
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
from contactimplicitmpc_tpu_torch.models import hopper_2d


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


def test_structure_parkour_prefix_matches():
    """The nominal lane's first 20 sim steps up the stairs."""
    jenv = ci.flat_2d_lc
    dims = ci.dims_of(jhopper, jenv)
    ref = jfrom_gait(jhopper, jenv, load_gait("hopper_2D", "hopper_stair_ref"))
    n_sample, h_mpc, kappa, steps = 10, 10, 2.0e-4, 20
    # parkour.jl:43-48: front-loaded q weights, light tail
    q_w = np.concatenate([
        np.tile(1e-0 * np.array([1e1, 1e-1, 1.0, 1.0]), (h_mpc - 5, 1)),
        np.tile(1e-1 * np.array([1.0, 1e-1, 1e1, 0.1]), (5, 1))])
    obj = jtracking_velocity(
        dims, h_mpc, v=np.tile(1e-3 * np.array([1e-2, 1, 1, 10]), (h_mpc, 1)),
        q=q_w, u=np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)))
    n_opts = JNewtonOptions(r_tol=3e-4, max_iter=5)
    ip_opts = jdefault_mpc_ip_options(kappa, max_iter=30)
    mpc_opts = CIMPCOptions(altitude_update=True,
                            altitude_impact_threshold=0.1)
    q1, v1 = (np.asarray(x) for x in jinitial(ref))
    want = jax.jit(lambda q, v: jmpc_rollout(
        jhopper, jenv, ref, obj, steps, h_mpc, n_sample, kappa,
        CONFIGURATION, q, v, n_opts=n_opts, ip_opts=ip_opts,
        warm_start_floor=1e-2, newton_mode="structure", mpc_opts=mpc_opts,
        stride_idx=(0, 1), sim_env=ci.stairs3_2d_lc))(
        jnp.asarray(q1), jnp.asarray(v1))
    got = mpc_rollout(
        hopper_2d, pt.flat_2d_lc, interop.contact_traj(ref, device="cpu"),
        interop.objective(obj, device="cpu"), steps, h_mpc, n_sample, kappa,
        CONFIGURATION, torch.tensor(q1)[None], torch.tensor(v1)[None],
        n_opts=interop.newton_options(n_opts),
        ip_opts=interop.ip_options(ip_opts), warm_start_floor=1e-2,
        newton_mode="structure", mpc_opts=interop.cimpc_options(mpc_opts),
        stride_idx=(0, 1), sim_env=pt.stairs3_2d_lc)
    assert bool(np.asarray(want.sim_converged).all())
    for name in ("sim_converged", "newton_iterations", "sim_iterations"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("q", "u"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-8, err_msg=name)
    assert float(np.abs(np.asarray(want.u)).max()) > 0
