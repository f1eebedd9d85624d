"""The port's main path, end to end, against the JAX package: the
closed-loop structure-mode CIMPC rollout of the flat-ground quadruped at
the ``HotPathConfig`` defaults, float64 on the CPU, 3 lanes × 10 sim steps.

Lane 0 starts from the gait's own initial condition; lanes 1-2 from "conf"
poses drawn with ``jax.random.PRNGKey(0)`` as bench.py draws them and
handed to both packages as numpy. The nominal lane never needs a Newton
step at these settings; the conf lanes run the full Newton loop (step,
Riccati sweep and the 7-trial batch of knot solves) in every period.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contactimplicitmpc_tpu.control import initial_conditions as jinit
from contactimplicitmpc_tpu.hotpath import HotPathConfig as JHotPath
from contactimplicitmpc_tpu.hotpath import \
    make_quadruped_rollout as jmake_rollout
from contactimplicitmpc_tpu.models.quadruped import \
    initial_configuration as jinit_conf

from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control.trajectory import tracking_errors
from contactimplicitmpc_tpu_torch.hotpath import (CONF_POSES, HotPathConfig,
                                                  conf_initial_states,
                                                  make_quadruped_rollout)

STEPS = 10
LANES = 3


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


def conf_lanes(model, ref, dtype=jnp.float64):
    """bench.py's "conf" initial states (bench.py:140-155) for LANES lanes,
    lane 0 the nominal one."""
    q1, v1 = jinit(ref)
    cmin = jnp.asarray([0.0, 0.6, 0.6, 0.6, -0.2, -0.3], dtype)
    cmax = jnp.asarray([0.05, 0.8, 0.8, 0.8, 0.2, 0.1], dtype)
    conf = cmin + (cmax - cmin) * jax.random.uniform(
        jax.random.PRNGKey(0), (LANES, 6), dtype)
    conf = conf.at[:, 5].set(jnp.maximum(conf[:, 5], 0.0))
    q1s = jax.vmap(lambda c: jinit_conf(model, *c))(conf).at[0].set(q1)
    v1s = jnp.broadcast_to(v1, q1s.shape)
    return np.asarray(q1s), np.asarray(v1s)


@pytest.fixture(scope="module")
def runs():
    jcfg = JHotPath()
    jroll, jref, jmodel, _, _ = jmake_rollout(jcfg, STEPS, jnp.float64)
    q1s, v1s = conf_lanes(jmodel, jref)
    # one lane a call of one compiled program: tracing the rollout under
    # vmap takes about twice as long, and the tracing is most of the time
    jroll = jax.jit(jroll)
    outs = [jroll(jnp.asarray(q), jnp.asarray(v)) for q, v in zip(q1s, v1s)]
    want = {k: np.stack([np.asarray(getattr(o, k)) for o in outs])
            for k in outs[0]._fields}

    cfg = interop.hotpath_config(jcfg)
    roll, ref, _, _, _ = make_quadruped_rollout(cfg, STEPS, torch.float64,
                                                device="cpu")
    got = roll(torch.as_tensor(q1s), torch.as_tensor(v1s))
    got = {k: v.numpy() for k, v in got._asdict().items()}
    return cfg, ref, got, want


def test_config_carried_over(runs):
    """The JAX HotPathConfig's defaults are the port's."""
    cfg, *_ = runs
    assert cfg == HotPathConfig()


def test_newton_runs_on_conf_lanes(runs):
    _, _, got, want = runs
    assert (want["newton_iterations"][1:] > 0).any()
    assert (got["newton_iterations"][1:] > 0).any()


def test_counts_and_flags_match(runs):
    """Sim convergence flags, sim and Newton iteration counts: exactly."""
    _, _, got, want = runs
    for k in ("sim_converged", "newton_iterations", "sim_iterations"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["q", "u", "gamma", "b"])
def test_trajectories_match(runs, name):
    """Configurations, controls and contact impulses to 1e-6."""
    _, _, got, want = runs
    assert np.isfinite(got[name]).all()
    np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6)


def test_newton_residuals_match(runs):
    """Final Newton residual norms per control period, relatively."""
    _, _, got, want = runs
    np.testing.assert_allclose(got["mpc_r_norm"], want["mpc_r_norm"],
                               rtol=1e-5, atol=1e-12)
    ok = np.isfinite(want["sim_rvio"])  # ROADMAP Queue 3: NaN after divergence
    np.testing.assert_allclose(got["sim_rvio"][ok], want["sim_rvio"][ok],
                               rtol=1e-5, atol=1e-9)


def test_conf_lanes_are_test_hotpath_lanes():
    """``hotpath.CONF_POSES`` is tests/test_hotpath.py's PRNGKey(0) draw,
    bit for bit, and ``conf_initial_states`` builds that test's 16 lanes
    from it (float32, to a few ulps)."""
    dt = jnp.float32
    _, jref, jmodel, _, _ = jmake_rollout(JHotPath(), STEPS, dt)
    q1, v1 = jinit(jref)
    cmin = jnp.asarray([0.0, 0.6, 0.6, 0.6, -0.2, -0.3], dt)
    cmax = jnp.asarray([0.05, 0.8, 0.8, 0.8, 0.2, 0.1], dt)
    conf = cmin + (cmax - cmin) * jax.random.uniform(
        jax.random.PRNGKey(0), (16, 6), dt)
    conf = conf.at[:, 5].set(jnp.maximum(conf[:, 5], 0.0))
    with np.load(CONF_POSES) as f:
        np.testing.assert_array_equal(f["conf"], np.asarray(conf))
    want = jax.vmap(lambda c: jinit_conf(jmodel, *c))(conf).astype(dt)
    want = np.asarray(want.at[0].set(q1.astype(dt)))

    _, ref, model, _, _ = make_quadruped_rollout(HotPathConfig(), STEPS,
                                                 torch.float32, device="cpu")
    q1s, v1s = conf_initial_states(model, ref)
    np.testing.assert_allclose(q1s.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v1s.numpy(), np.broadcast_to(v1, want.shape),
                               rtol=0, atol=1e-5)


def test_nominal_lane_tracks(runs):
    """The nominal lane's tracking errors (the bench's nominal-lane line)
    agree with JAX's and stay inside the reference CI thresholds
    (mpc_quadruped.jl:61-68, ×1.5 as tests/test_hotpath.py)."""
    cfg, ref, got, _ = runs
    errs = tracking_errors(ref, *(torch.as_tensor(got[k][0]) for k in
                                  ("q", "u", "gamma", "b")), cfg.n_sample)
    for e, bound in zip(errs, (0.0201, 0.0437, 0.374, 0.0789)):
        assert float(e) < 1.5 * bound
