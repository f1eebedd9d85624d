"""The point-foot quadruped's stand under a lateral push
(tests/test_mpc_point_foot.py::test_point_foot_stand_push_recovery) in the
port against the JAX package, float64 on the CPU.

``mpc_rollout`` in that test's configuration (gait stand_v0 on flat_3d_lc,
direct-mode Newton in configuration mode, κ 2e-4, H 10, N_sample 5, the
test's knot and sim options, a warm-start floor of 1e-2) with fixed
8-iteration knot solves (the card kernel's form; its plain version on the
CPU), 10 sim steps with the test's push (0, 5, 1) / 5 moved to steps 5-9,
so that the disturbance lands inside the run. The nominal lane is compared
with JAX's: q, u, γ and b to 1e-8, flags and iteration counts exactly. The
test's full 80 steps run on the card (chip_smoke.py's path I, on the lanes
of ``assets/point_foot_offsets16.npz``, which is checked here against its
draw).
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
from contactimplicitmpc_tpu.models import point_foot_quadruped as jmodel
from contactimplicitmpc_tpu.sim.interior_point import IPOptions as JIPOptions
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
from contactimplicitmpc_tpu_torch.models.point_foot_quadruped import \
    point_foot_quadruped

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "contactimplicitmpc_tpu_torch", "assets",
    "point_foot_offsets16.npz")
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


def committed_offsets():
    with np.load(ASSET) as f:
        return f["offsets"]


def test_offsets_are_the_draw():
    """The committed lanes are tools/point_foot_lanes_reference.py's
    ``default_rng(9)`` draw: lane 0 nominal, lanes 1-15 the body moved by
    0.02 · uniform(−1, 1) and turned by 0.05 · uniform(−1, 1), the feet
    fixed."""
    rng = np.random.default_rng(9)
    want = np.zeros((16, 18), np.float32)
    want[1:, :3] = 0.02 * rng.uniform(-1.0, 1.0, (15, 3))
    want[1:, 3:6] = 0.05 * rng.uniform(-1.0, 1.0, (15, 3))
    got = committed_offsets()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def stand():
    dims = ci.dims_of(jmodel, ci.flat_3d_lc)
    ref = jfrom_gait(jmodel, ci.flat_3d_lc,
                     load_gait("point_foot_quadruped", "stand_v0"),
                     update_friction=True)
    v_w = 1e-3 * np.concatenate([np.ones(3), 1e3 * np.ones(3), np.ones(12)])
    q_body = np.array([1e-2, 1e-2, 1.0]) + 4.0 * np.array([0.2, 0.2, 1.0])
    q_w = np.concatenate([q_body, 0.3 * np.ones(3),
                          np.tile([0.2, 0.2, 1.0], 4)])
    obj = jtracking_velocity(dims, H_MPC, q=q_w, v=v_w,
                             u=3e-3 * np.ones(dims.nu))
    w = np.zeros((STEPS, dims.nw))
    w[5:10] = np.array([0.0, 5.0, 1.0]) / 5.0
    return dims, ref, obj, w


def port_rollout(ref, obj, q1s, v1s, w):
    return mpc_rollout(
        point_foot_quadruped, pt.flat_3d_lc,
        interop.contact_traj(ref, device="cpu"),
        interop.objective(obj, device="cpu"), STEPS, H_MPC, N_SAMPLE, KAPPA,
        CONFIGURATION, torch.as_tensor(q1s), torch.as_tensor(v1s),
        n_opts=interop.newton_options(N_OPTS),
        ip_opts=interop.ip_options(MPC_IP),
        sim_opts=interop.ip_options(SIM_OPTS), warm_start_floor=1e-2, w=w)


def test_push_recovery_prefix_matches(stand):
    """The nominal lane under the push, 10 steps, against JAX; the port
    runs it beside lane 1 of the committed lanes (the push is shared by
    the lanes) and once more without the push, which must part from it
    from the first pushed step on."""
    dims, ref, obj, w = stand
    q1, v1 = (np.asarray(x) for x in jinitial(ref))
    want = jax.jit(lambda q, v: jmpc_rollout(
        jmodel, ci.flat_3d_lc, ref, obj, STEPS, H_MPC, N_SAMPLE, KAPPA,
        CONFIGURATION, q, v, n_opts=N_OPTS, ip_opts=MPC_IP,
        sim_opts=SIM_OPTS, warm_start_floor=1e-2, w=jnp.asarray(w)))(
        jnp.asarray(q1), jnp.asarray(v1))
    q1s = q1[None] + committed_offsets()[:2].astype(np.float64)
    v1s = np.repeat(v1[None], 2, axis=0)
    got = port_rollout(ref, obj, q1s, v1s, w)
    for name in ("sim_converged", "newton_iterations", "sim_iterations"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      getattr(want, name), err_msg=name)
    assert bool(np.asarray(want.sim_converged).all())
    assert bool(got.sim_converged.all())
    for name in ("q", "u", "gamma", "b"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   getattr(want, name), rtol=0, atol=1e-8,
                                   err_msg=name)
    calm = port_rollout(ref, obj, q1s[:1], v1s[:1], None)
    # q[t + 2] is sim step t's result: steps 0-4 are unpushed (one lane
    # against two rounds apart in the last bits)
    np.testing.assert_allclose(calm.q[0, :7].numpy(), got.q[0, :7].numpy(),
                               rtol=0, atol=1e-12)
    assert float((calm.q[0, 7:, 1] - got.q[0, 7:, 1]).abs().min()) > 1e-9
