"""TVLQR gains and the Raibert baselines of the port against the JAX
package, float64 on the CPU on seeded numpy inputs:

* ``tvlqr`` against the dense recursion of tests/test_gains.py and against
  JAX, to 1e-12; ``reference_gains`` on the 2D hopper's in-place gait (as
  tests/test_gains.py), to 1e-8;
* ``mrp_to_euler_xyz`` (the round trip of tests/test_raibert_3d.py, and
  seeded MRPs against JAX) and each policy's ``apply`` on a batch of
  seeded observations that take both phases, to 1e-12;
* ``simulate`` with ``raibert_policy`` (2D hopper, tests/test_raibert.py's
  options, 50 steps) and with ``raibert_policy_3d`` (3D hopper,
  tests/test_raibert_3d.py's options without restarts, 15 steps) against
  JAX: q, u and the impulses to 1e-8, flags and iteration counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu import models as jmodels
from contactimplicitmpc_tpu.control import from_gait as jfrom_gait
from contactimplicitmpc_tpu.control.gains import \
    reference_gains as jreference_gains
from contactimplicitmpc_tpu.control.gains import tvlqr as jtvlqr
from contactimplicitmpc_tpu.control.objective import \
    tracking_velocity_objective as jtracking_velocity
from contactimplicitmpc_tpu.control.raibert import \
    mrp_to_euler_xyz as jmrp_to_euler
from contactimplicitmpc_tpu.control.raibert import \
    raibert_policy as jraibert
from contactimplicitmpc_tpu.control.raibert import \
    raibert_policy_3d as jraibert_3d
from contactimplicitmpc_tpu.sim.simulator import PolicyObs as JPolicyObs
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import models as tmodels
from contactimplicitmpc_tpu_torch.control.gains import (reference_gains,
                                                        tvlqr)
from contactimplicitmpc_tpu_torch.control.objective import \
    tracking_velocity_objective
from contactimplicitmpc_tpu_torch.control.raibert import (mrp_to_euler_xyz,
                                                          raibert_policy,
                                                          raibert_policy_3d)
from contactimplicitmpc_tpu_torch.control.trajectory import from_gait
from contactimplicitmpc_tpu_torch.models.rotations import mrp_rotation_matrix

TIGHT = dict(rtol=0, atol=1e-12)


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


def t(x):
    return torch.as_tensor(np.array(x))


def test_tvlqr_matches_dense_recursion_and_jax():
    """tests/test_gains.py's sweep (n 4, m 2, T 8) against its dense
    recursion and against JAX's reverse scan."""
    rng = np.random.default_rng(0)
    n, m, T = 4, 2, 8
    a = rng.standard_normal((T - 1, n, n)) * 0.5
    b = rng.standard_normal((T - 1, n, m))
    q = np.stack([np.eye(n)] * T)
    r = np.stack([0.1 * np.eye(m)] * (T - 1))
    k, p = tvlqr(t(a), t(b), t(q), t(r))

    p_ref = [None] * T
    k_ref = [None] * (T - 1)
    p_ref[T - 1] = q[T - 1]
    for s in range(T - 2, -1, -1):
        btp = b[s].T @ p_ref[s + 1]
        k_ref[s] = np.linalg.solve(r[s] + btp @ b[s], btp @ a[s])
        acl = a[s] - b[s] @ k_ref[s]
        p_ref[s] = q[s] + k_ref[s].T @ r[s] @ k_ref[s] \
            + acl.T @ p_ref[s + 1] @ acl
    np.testing.assert_allclose(k.numpy(), np.stack(k_ref), atol=1e-9)
    np.testing.assert_allclose(p.numpy(), np.stack(p_ref), atol=1e-9)

    jk, jp = jtvlqr(*map(jnp.asarray, (a, b, q, r)))
    np.testing.assert_allclose(k.numpy(), jk, **TIGHT)
    np.testing.assert_allclose(p.numpy(), jp, **TIGHT)


def test_reference_gains_hopper():
    """tests/test_gains.py's hopper gains (3 periods of the in-place gait),
    to 1e-8; nontrivial as there."""
    gait = load_gait("hopper_2D", "gait_in_place")
    jref = jfrom_gait(jmodels.hopper_2d, ci.flat_2d_lc, gait, kappa=1e-4)
    ref = from_gait(tmodels.hopper_2d, pt.flat_2d_lc, gait, kappa=1e-4,
                    device="cpu")
    weights = dict(q=np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (ref.horizon, 1)),
                   v=np.tile(1e-3 * np.ones(4), (ref.horizon, 1)),
                   u=np.tile(np.array([3e-3, 1.0]), (ref.horizon, 1)))
    dims = pt.dims_of(tmodels.hopper_2d, pt.flat_2d_lc)
    want = jreference_gains(jmodels.hopper_2d, ci.flat_2d_lc, jref,
                            jtracking_velocity(dims, ref.horizon, **weights),
                            periods=3)
    got = reference_gains(tmodels.hopper_2d, pt.flat_2d_lc, ref,
                          tracking_velocity_objective(dims, ref.horizon,
                                                      device="cpu", **weights),
                          periods=3)
    assert got.shape == (ref.horizon, dims.nu, 2 * dims.nq)
    assert float(got.abs().max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)


def test_mrp_to_euler_xyz():
    """tests/test_raibert_3d.py's round trip (Rx·Ry·Rz → MRP → angles) to
    1e-8, and 32 seeded MRPs against JAX to 1e-12."""
    for angles in ([0.1, -0.2, 0.15], [0.0, 0.0, 0.0], [0.3, 0.1, -0.2]):
        c, s = np.cos(angles), np.sin(angles)
        rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
        ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
        rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
        rot = rx @ ry @ rz
        w = np.array([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0],
                      rot[1, 0] - rot[0, 1]])
        angle = np.arccos((np.trace(rot) - 1) / 2)
        p = (w / (2 * np.sin(angle)) * np.tan(angle / 4) if angle > 1e-12
             else np.zeros(3))
        np.testing.assert_allclose(mrp_rotation_matrix(t(p)).numpy(), rot,
                                   atol=1e-8)
        np.testing.assert_allclose(mrp_to_euler_xyz(t(p)).numpy(), angles,
                                   atol=1e-8)
    p = np.random.default_rng(90).uniform(-0.4, 0.4, (32, 3))
    np.testing.assert_allclose(mrp_to_euler_xyz(t(p)).numpy(),
                               jax.vmap(jmrp_to_euler)(jnp.asarray(p)),
                               **TIGHT)


def _observations(nq, nc, seed, lanes=16):
    """Seeded (q0, q1, γ) for a batch of lanes, half of them in contact."""
    rng = np.random.default_rng(seed)
    q1 = rng.uniform(-0.3, 0.3, (lanes, nq))
    q1[:, -1] += 0.5
    q0 = q1 - 0.01 * rng.standard_normal((lanes, nq))
    gamma = np.where(np.arange(lanes)[:, None] % 2 == 0, 0.1, 1e-3) \
        * rng.uniform(0.5, 1.0, (lanes, nc))
    return q0, q1, gamma


@pytest.mark.parametrize("three_d", [False, True])
def test_policy_apply_matches(three_d):
    """Each policy's ``apply`` on 16 seeded lanes (stance on the even
    lanes, flight on the odd ones, the 3D lanes moving and one at rest),
    to 1e-12."""
    if three_d:
        q0, q1, gamma = _observations(7, 1, 91)
        q0[3] = q1[3]                      # a lane at rest: no heading
        jpol = jraibert_3d(jmodels.hopper_3d, h=0.002, v0=(0.1, 0.2))
        pol = raibert_policy_3d(tmodels.hopper_3d, h=0.002, v0=(0.1, 0.2))
    else:
        q0, q1, gamma = _observations(4, 1, 92)
        jpol = jraibert(jmodels.hopper_2d, h=0.02, v0=0.2)
        pol = raibert_policy(tmodels.hopper_2d, h=0.02, v0=0.2)
    want = jax.vmap(lambda a, b, g: jpol[1](
        jpol[0](), JPolicyObs(a, b, g, 0))[0])(
        jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(gamma))
    got, state = pol[1](pol[0](16), pt.PolicyObs(t(q0), t(q1), t(gamma), 0))
    assert state == ()
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)


def _compare(got, want):
    assert bool(pt.status(got).all()) and bool(ci.status(want))
    np.testing.assert_array_equal(got.converged[0].numpy(), want.converged)
    np.testing.assert_array_equal(got.iterations[0].numpy(), want.iterations)
    for field in ("q", "u", "gamma", "b"):
        np.testing.assert_allclose(getattr(got, field)[0].numpy(),
                                   np.asarray(getattr(want, field)), rtol=0,
                                   atol=1e-8, err_msg=field)


def test_simulate_raibert_2d():
    """The 2D hopper under ``raibert_policy`` (tests/test_raibert.py: h_sim
    0.02, v0 0.2, its options) for 50 steps; it lands and takes off."""
    h, steps = 0.02, 50
    kw = dict(r_tol=1e-8, kappa_tol=1e-8, max_iter=100,
              undercut=float("inf"), max_ls=25)
    q1 = np.array([0.0, 0.5, 0.0, 0.5])
    want = jax.jit(lambda q, v: ci.simulate(
        jmodels.hopper_2d, ci.flat_2d_lc, steps, h, q, v,
        policy=jraibert(jmodels.hopper_2d, h=h, v0=0.2),
        opts=ci.IPOptions(**kw)))(jnp.asarray(q1), jnp.zeros(4))
    got = pt.simulate(tmodels.hopper_2d, pt.flat_2d_lc, steps, h,
                      t(q1[None]), torch.zeros((1, 4), dtype=torch.float64),
                      policy=raibert_policy(tmodels.hopper_2d, h=h, v0=0.2),
                      opts=pt.IPOptions(**kw))
    _compare(got, want)
    gamma = got.gamma[0, :, 0].numpy()
    assert np.any(gamma > 1.5e-2) and np.any(gamma < 1.5e-3)


def test_simulate_raibert_3d():
    """The 3D hopper under ``raibert_policy_3d`` (tests/test_raibert_3d.py:
    h_sim 0.002, v0 (0, 0.2), its options but for its two cold restarts)
    for 15 steps of its fall (in flight: the foot starts 0.5 above the
    ground, some 160 steps of fall). Every step of the fall converges on the first pass; a restart
    pass would reset every count to 0, so the iteration counts are compared
    without one."""
    h, steps = 0.002, 15
    kw = dict(r_tol=1e-8, kappa_tol=1e-8, max_iter=150,
              undercut=float("inf"), max_ls=25)
    q1 = np.array([0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.5])
    v1 = np.array([0.0, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0])
    want = jax.jit(lambda q, v: ci.simulate(
        jmodels.hopper_3d, ci.flat_3d_lc, steps, h, q, v,
        policy=jraibert_3d(jmodels.hopper_3d, h=h, v0=(0.0, 0.2)),
        opts=ci.IPOptions(**kw)))(jnp.asarray(q1), jnp.asarray(v1))
    got = pt.simulate(tmodels.hopper_3d, pt.flat_3d_lc, steps, h,
                      t(q1[None]), t(v1[None]),
                      policy=raibert_policy_3d(tmodels.hopper_3d, h=h,
                                               v0=(0.0, 0.2)),
                      opts=pt.IPOptions(**kw))
    _compare(got, want)
