"""The 2D hopper over rough terrain with the flat-ground controller and
altitude discovery in the closed loop, the port against the JAX package,
float64 on the CPU, one lane, two control periods (10 sim steps).

tests/test_hopper_terrain.py drives examples/hopper_terrain.py, whose
``run_2d`` is the configuration: ``simulate`` driven by ``ci_mpc_policy``,
gait_forward, H 10, N_sample 5, κ 2e-4, the knot options
``default_mpc_ip_options(κ, 30)``, altitude update at 0.05; in float64 the
simulator's default options. The port runs it through
examples/torch_hopper_terrain.py's ``run_case`` with the JAX example's
adaptive knot solves, on the sine and the piecewise terrains.

Tolerance: q and u to 1e-8, flags and iteration counts exactly. The
full-length runs (500 sim steps) stay with the JAX test.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.control import (CONFIGURATION, CIMPCOptions,
                                            NewtonOptions as JNewtonOptions,
                                            ci_mpc_policy as jci_mpc_policy,
                                            from_gait as jfrom_gait,
                                            initial_conditions as jinitial,
                                            tracking_objective as jtracking)
from contactimplicitmpc_tpu.control.implicit_dynamics import \
    default_mpc_ip_options as jdefault_mpc_ip_options
from contactimplicitmpc_tpu.models import hopper_2d as jhopper
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples")


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


def assert_matches(got, want, fields, flags):
    for name in flags:
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in fields:
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-8, err_msg=name)


def example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("terrain", ["sine2_2D_lc", "piecewise1_2D_lc"])
def test_hopper_terrain_prefix_matches(terrain):
    """examples/hopper_terrain.py's ``run_2d`` (the configuration
    tests/test_hopper_terrain.py runs) on ``terrain``, float64, 10 sim
    steps (2 control periods), against examples/torch_hopper_terrain.py's
    ``run_case`` with adaptive knot solves."""
    jenv = ci.flat_2d_lc
    dims = ci.dims_of(jhopper, jenv)
    ref = jfrom_gait(jhopper, jenv, load_gait("hopper_2D", "gait_forward"))
    n_sample, h_mpc, kappa, steps = 5, 10, 2.0e-4, 10
    obj = jtracking(dims, h_mpc,
                    q=np.tile(1e-1 * np.array([0.1, 3.0, 1.0, 3.0]),
                              (h_mpc, 1)),
                    u=np.tile([1e-3, 1e0], (h_mpc, 1)),
                    gamma=1e-100 * np.ones((h_mpc, dims.nc)),
                    b=1e-100 * np.ones((h_mpc, dims.nb)))
    policy = jci_mpc_policy(
        jhopper, jenv, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION,
        n_opts=JNewtonOptions(r_tol=3e-4, max_iter=5),
        ip_opts=jdefault_mpc_ip_options(kappa, max_iter=30),
        mpc_opts=CIMPCOptions(altitude_update=True,
                              altitude_impact_threshold=0.05))
    q1, v1 = jinitial(ref)
    h_sim = float(ref.h) / n_sample
    want = jax.jit(lambda q, v: ci.simulate(
        jhopper, ci.ENVIRONMENTS[terrain], steps, h_sim, q, v,
        policy=policy))(q1, v1)
    _, got, got_h = example("torch_hopper_terrain").run_case(
        "hopper_2D", terrain, steps, torch.float64, "cpu", fixed_ip_iters=0)
    assert got_h == h_sim
    assert bool(ci.status(want)) and bool(pt.status(got).all())
    assert_matches(got, want, ("q", "u"), ("converged", "iterations"))
