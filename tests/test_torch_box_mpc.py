"""The centroidal quadruped's box variant standing beside the step under a
push toward it (tests/test_mpc_box.py::test_box_stand_mpc_push) in the port
against the JAX package, float64 on the CPU.

``mpc_rollout`` in that test's configuration (centroidal_quadruped_box,
gait centroidal_quadruped/stand_v0 on flat_3d_lc with the friction update,
direct-mode Newton in configuration mode, κ 2e-4, H 10, N_sample 5, the
test's knot and sim options, a warm-start floor of 1e-2) with fixed
8-iteration knot solves (the card kernel's form; its plain version on the
CPU), 10 sim steps with the test's push (3, 0, 0) / 5 moved to steps 5-9,
so that the disturbance lands inside the run. The nominal lane is compared
with JAX's: q, u, γ and b to 1e-8, flags and iteration counts exactly; the
feet's lowest gap to the box surface (``model.elevation``) to 1e-8 and
inside the test's bound −1e-4. The test's full 80 steps run on the card
(chip_smoke.py's path K, on the lanes of ``assets/box_offsets16.npz``,
which is checked here against its draw).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.control import (CONFIGURATION,
                                            NewtonOptions as JNewtonOptions,
                                            from_gait as jfrom_gait,
                                            initial_conditions as jinitial,
                                            tracking_velocity_objective as
                                            jtracking_velocity)
from contactimplicitmpc_tpu.control.rollout import mpc_rollout as jmpc_rollout
from contactimplicitmpc_tpu.models import centroidal_quadruped_box as jmodel
from contactimplicitmpc_tpu.sim.interior_point import IPOptions as JIPOptions
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
from contactimplicitmpc_tpu_torch.models import centroidal_quadruped_box

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "contactimplicitmpc_tpu_torch", "assets", "box_offsets16.npz")
H_MPC, N_SAMPLE, KAPPA, STEPS = 10, 5, 2.0e-4, 10
MPC_IP = JIPOptions(r_tol=1e-4, kappa_tol=KAPPA, max_iter=30, undercut=5.0,
                    gamma_reg=0.1, diff_sol=True, max_ls=3)
SIM_OPTS = JIPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=100,
                      undercut=float("inf"), max_ls=6)
N_OPTS = JNewtonOptions(r_tol=3e-5, max_iter=5, fixed_ip_iters=8)


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


def test_offsets_are_the_draw():
    """The committed lanes are tools/box_lanes_reference.py's
    ``default_rng(10)`` draw: lane 0 nominal, lanes 1-15 the body moved by
    0.02 · uniform(−1, 1) and turned by 0.05 · uniform(−1, 1), the feet
    fixed."""
    rng = np.random.default_rng(10)
    want = np.zeros((16, 18), np.float32)
    want[1:, :3] = 0.02 * rng.uniform(-1.0, 1.0, (15, 3))
    want[1:, 3:6] = 0.05 * rng.uniform(-1.0, 1.0, (15, 3))
    with np.load(ASSET) as f:
        got = f["offsets"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def gaps(q, elevation):
    """Each configuration's lowest foot height above the box surface."""
    feet = np.asarray(q)[..., 6:].reshape(-1, 4, 3)
    return (feet[..., 2] - elevation(feet[..., 0])).min(axis=1)


@pytest.fixture(scope="module")
def pushed():
    """Both packages' nominal lane, 10 steps with the push at 5-9."""
    dims = ci.dims_of(jmodel, ci.flat_3d_lc)
    ref = jfrom_gait(jmodel, ci.flat_3d_lc,
                     load_gait("centroidal_quadruped", "stand_v0"),
                     update_friction=True)
    v_w = 1e-3 * np.concatenate([np.ones(3), 1e3 * np.ones(3), np.ones(12)])
    q_body = np.array([1e-2, 1e-2, 1.0]) + 4.0 * np.array([0.2, 0.2, 1.0])
    q_w = np.concatenate([q_body, 0.3 * np.ones(3),
                          np.tile([0.2, 0.2, 1.0], 4)])
    obj = jtracking_velocity(dims, H_MPC, q=q_w, v=v_w,
                             u=3e-3 * np.ones(dims.nu))
    w = np.zeros((STEPS, dims.nw))
    w[5:10] = np.array([3.0, 0.0, 0.0]) / 5.0
    q1, v1 = (np.asarray(x) for x in jinitial(ref))
    want = jax.jit(lambda q, v: jmpc_rollout(
        jmodel, ci.flat_3d_lc, ref, obj, STEPS, H_MPC, N_SAMPLE, KAPPA,
        CONFIGURATION, q, v, n_opts=N_OPTS, ip_opts=MPC_IP,
        sim_opts=SIM_OPTS, warm_start_floor=1e-2, w=jnp.asarray(w)))(
        jnp.asarray(q1), jnp.asarray(v1))
    got = mpc_rollout(
        centroidal_quadruped_box, pt.flat_3d_lc,
        interop.contact_traj(ref, device="cpu"),
        interop.objective(obj, device="cpu"), STEPS, H_MPC, N_SAMPLE, KAPPA,
        CONFIGURATION, torch.tensor(q1)[None], torch.tensor(v1)[None],
        n_opts=interop.newton_options(N_OPTS),
        ip_opts=interop.ip_options(MPC_IP),
        sim_opts=interop.ip_options(SIM_OPTS), warm_start_floor=1e-2, w=w)
    return want, got


def test_push_prefix_matches(pushed):
    """The nominal lane under the push toward the step, 10 steps, against
    JAX: q, u, γ and b to 1e-8; flags and iteration counts exactly."""
    want, got = pushed
    for name in ("sim_converged", "newton_iterations", "sim_iterations"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      getattr(want, name), err_msg=name)
    assert bool(np.asarray(want.sim_converged).all())
    for name in ("q", "u", "gamma", "b"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   getattr(want, name), rtol=0, atol=1e-8,
                                   err_msg=name)
    # the push moves the body toward the step: q[t + 2] is sim step t's
    # result, and the body's x velocity turns positive after step 5
    dx = np.diff(got.q[0, 6:, 0].numpy())
    assert float(dx.max()) > 1e-4, dx


def test_feet_above_the_box(pushed):
    """The feet's lowest gap to the box surface, per configuration, in the
    port (its ``elevation`` on tensors) against JAX's (its ``elevation``
    on arrays) to 1e-8, and inside the test's bound −1e-4."""
    want, got = pushed
    gap_port = gaps(got.q[0], lambda x: centroidal_quadruped_box.elevation(
        torch.as_tensor(x)).numpy())
    gap_jax = gaps(want.q, lambda x: np.asarray(jmodel.elevation(
        jnp.asarray(x))))
    np.testing.assert_allclose(gap_port, gap_jax, rtol=0, atol=1e-8)
    assert float(gap_port.min()) > -1e-4, float(gap_port.min())
