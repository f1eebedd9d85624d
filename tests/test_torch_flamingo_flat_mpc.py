"""The flamingo walking on flat ground (tests/test_mpc_flamingo.py), the port
against the JAX package, float64 on the CPU.

That test's configuration: ``simulate`` driven by ``ci_mpc_policy`` on
flat_2d_lc, gait_forward_36_4 without the friction update,
configuration-force mode with the adaptive knot solve
(``default_mpc_ip_options(κ, 30)``), H 15, N_sample 5, κ 2e-4, the test's
velocity-tracking weights, ``NewtonOptions(r_tol=3e-4, max_iter=5)``, the
simulator's default options; one lane, the first two control periods (10
sim steps). Tolerance: q and u to 1e-8, flags and iteration counts exactly.
The full 1000 steps stay with the JAX test.
"""

import jax
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.control import (CONFIGURATION_FORCE,
                                            NewtonOptions as JNewtonOptions,
                                            ci_mpc_policy as jci_mpc_policy,
                                            from_gait as jfrom_gait,
                                            initial_conditions as jinitial,
                                            tracking_velocity_objective as
                                            jtracking_velocity)
from contactimplicitmpc_tpu.control.implicit_dynamics import \
    default_mpc_ip_options as jdefault_mpc_ip_options
from contactimplicitmpc_tpu.models import flamingo as jflamingo
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.models import flamingo


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


def test_flamingo_flat_prefix_matches():
    """The nominal lane's first 10 sim steps."""
    jenv = ci.flat_2d_lc
    dims = ci.dims_of(jflamingo, jenv)
    ref = jfrom_gait(jflamingo, jenv, load_gait("flamingo",
                                                "gait_forward_36_4"))
    n_sample, h_mpc, kappa, steps = 5, 15, 2.0e-4, 10
    # weights from mpc_flamingo.jl:22-27
    obj = jtracking_velocity(
        dims, h_mpc,
        v=np.tile(1e-3 * np.array([1e0, 1, 1e4, 1, 1, 1, 1, 1e4, 1e4]),
                  (h_mpc, 1)),
        q=np.tile(1e-1 * np.array([3e2, 1e-6, 3e2, 1, 1, 1, 1, 0.1, 0.1]),
                  (h_mpc, 1)),
        u=np.tile(3e-1 * np.array([0.1, 0.1, 0.3, 0.3, 1.0, 1.0]),
                  (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)))
    n_opts = JNewtonOptions(r_tol=3e-4, max_iter=5)
    ip_opts = jdefault_mpc_ip_options(kappa, max_iter=30)
    h_sim = float(ref.h) / n_sample
    q1, v1 = (np.asarray(x) for x in jinitial(ref))
    jpolicy = jci_mpc_policy(jflamingo, jenv, ref, obj, h_mpc=h_mpc,
                             n_sample=n_sample, kappa_mpc=kappa,
                             mode=CONFIGURATION_FORCE, n_opts=n_opts,
                             ip_opts=ip_opts)
    want = jax.jit(lambda q, v: ci.simulate(
        jflamingo, jenv, steps, h_sim, q, v, policy=jpolicy))(q1, v1)
    policy = pt.ci_mpc_policy(
        flamingo, pt.flat_2d_lc, interop.contact_traj(ref, device="cpu"),
        interop.objective(obj, device="cpu"), h_mpc=h_mpc,
        n_sample=n_sample, kappa_mpc=kappa, mode=CONFIGURATION_FORCE,
        n_opts=interop.newton_options(n_opts),
        ip_opts=interop.ip_options(ip_opts))
    got = pt.simulate(flamingo, pt.flat_2d_lc, steps, h_sim,
                      torch.tensor(q1)[None], torch.tensor(v1)[None],
                      policy=policy)
    assert bool(ci.status(want)) and bool(pt.status(got).all())
    for name in ("converged", "iterations"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("q", "u"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-8, err_msg=name)
    assert float(np.abs(np.asarray(want.u)).max()) > 0
