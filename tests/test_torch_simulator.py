"""``simulate`` of the port against the JAX package's, float64 on the CPU:
the 2D cases of tests/test_simulator.py (drop, slide, slope, hopper drop,
a batch of rollouts), the open-loop, saturated and impulse/open-loop/random
inputs, the degenerate horizon, and the statistics of ``sim/stats.py``.

The JAX rollout is one lane, vmapped; the port takes the lanes as a leading
axis. Tolerance 1e-9 on every trajectory leaf (the same float64 arithmetic
in another order of summation), flags and iteration counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.models import hopper_2d as jhopper
from contactimplicitmpc_tpu.models import particle_2d as jparticle
from contactimplicitmpc_tpu.models.particle_2d import \
    Particle2D as JParticle2D
from contactimplicitmpc_tpu.sim import stats as jstats

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d
from contactimplicitmpc_tpu_torch.models.particle_2d import (Particle2D,
                                                             particle_2d)
from contactimplicitmpc_tpu_torch.sim import stats

LEAVES = ("q", "u", "w", "gamma", "b", "z")


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


def both(jmodel, model, jenv, env, steps, h, q1, v1, jkw=None, kw=None):
    q1, v1 = np.atleast_2d(q1).astype(float), np.atleast_2d(v1).astype(float)
    want = jax.jit(jax.vmap(lambda q, v: ci.simulate(
        jmodel, jenv, steps, h, q, v, **(jkw or {}))))(
            jnp.asarray(q1), jnp.asarray(v1))
    got = pt.simulate(model, env, steps, h, torch.as_tensor(q1),
                      torch.as_tensor(v1), **(kw or {}))
    return got, want


def assert_same(got, want):
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    for name in LEAVES:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), rtol=0, atol=1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("v1", [[0.0, 0.0], [1.0, 0.0]])
def test_particle_2d_drop_and_slide(v1):
    got, want = both(jparticle, particle_2d, ci.flat_2d_lc, pt.flat_2d_lc,
                     70, 0.01, [0.0, 1.0], v1)
    assert bool(pt.status(got).all())
    assert_same(got, want)
    assert abs(float(got.q[0, -1, 1])) < 1e-6
    v_end = (got.q[0, -1] - got.q[0, -2]) / 0.01
    np.testing.assert_allclose(v_end.numpy(), 0.0, atol=1e-6)


def test_particle_2d_slope_slides_down():
    """μ = 0.1 on the 0.5-gradient slope keeps sliding (particle.jl:246-267)."""
    got, want = both(JParticle2D(mu_world=0.1), Particle2D(mu_world=0.1),
                     ci.slope1_2d_lc, pt.slope1_2d_lc, 60, 0.01,
                     [0.0, 1.0], [0.0, 0.0])
    assert bool(pt.status(got).all())
    assert_same(got, want)
    assert float(got.q[0, -1, 0]) < 0.0 and float(got.q[0, -1, 1]) < 0.0


def test_hopper_2d_drop_no_penetration():
    """The hopper dropped with its foot 0.1 above the ground: its first
    contact impulse is at step 13 (of 0-29), and it stands on the ground
    for the rest of 30 steps."""
    got, want = both(jhopper, hopper_2d, ci.flat_2d_lc, pt.flat_2d_lc, 30,
                     0.01, [0.0, 0.6, 0.0, 0.5], np.zeros(4))
    assert bool(pt.status(got).all())
    assert_same(got, want)
    phi = torch.func.vmap(lambda q: hopper_2d.phi(pt.flat_2d_lc, q))(got.q[0])
    assert float(phi.min()) > -1e-6
    assert float(got.gamma.min()) > -1e-10


def test_batch_of_rollouts():
    """Eight lanes in one call, each with its own iteration counts."""
    xs = np.linspace(-1.0, 1.0, 8)
    q1 = np.stack([xs, np.linspace(0.5, 1.0, 8)], axis=1)
    got, want = both(jparticle, particle_2d, ci.flat_2d_lc, pt.flat_2d_lc,
                     50, 0.01, q1, np.zeros((8, 2)))
    assert got.q.shape == (8, 52, 2) and pt.status(got).shape == (8,)
    assert_same(got, want)
    np.testing.assert_allclose(got.q[:, -1, 0].numpy(), xs, atol=1e-6)


def test_open_loop_saturated_policy_and_disturbances():
    """A held open-loop control, clamped, under a held open-loop
    disturbance (both sample-and-hold over 3 steps)."""
    rng = np.random.default_rng(0)
    u_traj = 3.0 * rng.standard_normal((5, 2))
    w_traj = rng.standard_normal((4, 2))
    lo, hi = [-0.5, -0.3], [1.0, 0.1]
    jkw = dict(policy=ci.saturated_policy(ci.open_loop_policy(u_traj, 3),
                                          lo, hi),
               disturbances=ci.open_loop_disturbances(w_traj, 3))
    kw = dict(policy=pt.saturated_policy(
        pt.open_loop_policy(u_traj, 3, device="cpu"), lo, hi),
        disturbances=pt.open_loop_disturbances(w_traj, 3, device="cpu"))
    got, want = both(jparticle, particle_2d, ci.flat_2d_lc, pt.flat_2d_lc,
                     20, 0.01, [[0.0, 0.2], [0.3, 0.05]], np.zeros((2, 2)),
                     jkw, kw)
    assert float(got.u[..., 0].max()) == 1.0      # the clamp is active
    assert float(got.u[..., 0].min()) == -0.5
    assert_same(got, want)


def test_impulse_and_random_disturbances():
    """Impulses at given steps; the uniform disturbance from a draw made
    by JAX and handed over as numpy (a ``torch.Generator`` cannot repeat
    a JAX key's numbers)."""
    w_imp = np.array([[2.0, 0.0], [0.0, 5.0]])
    jkw = dict(disturbances=ci.impulse_disturbances(w_imp, np.array([3, 7])))
    kw = dict(disturbances=pt.impulse_disturbances(w_imp, [3, 7],
                                                   device="cpu"))
    got, want = both(jhopper, hopper_2d, ci.flat_2d_lc, pt.flat_2d_lc, 12,
                     0.01, [0.0, 0.6, 0.0, 0.5], np.zeros(4), jkw, kw)
    assert float(got.w[0, 3, 0]) == 2.0 and float(got.w[0, 7, 1]) == 5.0
    assert_same(got, want)

    key = jax.random.PRNGKey(1)
    draw = np.asarray(jax.random.uniform(key, (12, 2)))
    jkw = dict(disturbances=ci.random_disturbances(key, jhopper, [1.0, 0.5],
                                                   12))
    kw = dict(disturbances=pt.random_disturbances(
        None, hopper_2d, [1.0, 0.5], 12, device="cpu", draw=draw))
    got, want = both(jhopper, hopper_2d, ci.flat_2d_lc, pt.flat_2d_lc, 12,
                     0.01, [0.0, 0.6, 0.0, 0.5], np.zeros(4), jkw, kw)
    assert_same(got, want)
    gen = torch.Generator().manual_seed(0)
    _, apply = pt.random_disturbances(gen, hopper_2d, 0.5, 4, device="cpu")
    w, _ = apply((), torch.zeros(3, 4, dtype=torch.float64), 9)
    assert w.shape == (3, 2) and bool(((w >= 0) & (w < 0.5)).all())


def test_zero_horizon_and_refused_arguments():
    got, want = both(jparticle, particle_2d, ci.flat_2d_lc, pt.flat_2d_lc, 0,
                     0.01, [0.0, 1.0], [0.0, 0.0])
    assert got.q.shape == (1, 2, 2) and got.u.shape == (1, 0, 2)
    assert bool(pt.status(got).all())
    np.testing.assert_allclose(got.q.numpy(), want.q, atol=1e-15)
    q = torch.zeros(1, 2, dtype=torch.float64)
    # a live plotter is handed every lane of each step (utils/live.py)
    seen = []

    class Recorder:
        def record(self, t, q2, u, gamma):
            seen.append((t, tuple(q2.shape), tuple(u.shape),
                         tuple(gamma.shape)))

    pt.simulate(particle_2d, pt.flat_2d_lc, 1, 0.01, q, q,
                live_plotter=Recorder())
    assert seen == [(0, (1, 2), (1, particle_2d.nu), (1, particle_2d.nc))]
    with pytest.raises(ValueError, match="one row a lane"):
        pt.simulate(particle_2d, pt.flat_2d_lc, 1, 0.01, q[0], q[0])


def test_statistics():
    """``process`` against JAX's on the same times; ``time_policy`` calls
    the policy once to warm and ``reps`` times to measure."""
    times = [0.011, 0.013, 0.012, 0.02]
    want = jstats.process(times, 0.002, 5, 100)
    got = stats.process(times, 0.002, 5, 100)
    assert got._fields == want._fields
    np.testing.assert_allclose(tuple(got), tuple(want), rtol=1e-15)

    calls = []
    init, apply = pt.open_loop_policy(np.ones((3, 2)), 2, device="cpu")

    def counted(state, obs):
        calls.append(state)
        return apply(state, obs)

    q = torch.zeros(4, 2, dtype=torch.float64)
    out = stats.time_policy((init, counted), pt.PolicyObs(q, q, q[:, :1], 0),
                            reps=3)
    assert out.shape == (3,) and bool((out > 0).all())
    assert len(calls) == 4 and all(c == (-1, 2) for c in calls)
