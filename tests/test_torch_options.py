"""Options of the Newton solvers that the main path leaves off, the
direct-mode hot path, the port's public surface and its spans; CPU.

* the structure-mode solve with reduced-budget line-search trials
  (``trial_ip_iters``) and with the fixed Newton loop
  (``fixed_newton_iters``) against the JAX package's, float64, on the 2D
  hopper's first window for lanes from perturbed states (state to 1e-8,
  iteration counts exactly);
* ``HotPathConfig(newton_mode="direct")`` through ``make_quadruped_rollout``
  (the port alone: two lanes, one control period);
* the names the JAX package exports that the port has;
* ``utils/spans.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.control import NewtonOptions as JNewtonOptions
from contactimplicitmpc_tpu.control import from_gait as jfrom_gait
from contactimplicitmpc_tpu.control import structure_solver as jss
from contactimplicitmpc_tpu.control import tracking_objective as jtracking
from contactimplicitmpc_tpu.control.implicit_dynamics import \
    default_mpc_ip_options as jdefault_opts
from contactimplicitmpc_tpu.control.linearized import \
    linearize_trajectory as jlinearize
from contactimplicitmpc_tpu.hotpath import HotPathConfig as JHotPath
from contactimplicitmpc_tpu.models import hopper_2d as jhopper
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control import structure_solver as ss
from contactimplicitmpc_tpu_torch.hotpath import (HotPathConfig,
                                                  conf_initial_states,
                                                  make_quadruped_rollout)
from contactimplicitmpc_tpu_torch.utils import spans

H, KAPPA = 10, 1.0e-4


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


@pytest.mark.parametrize("trial_ip,fixed_newton", [(4, 0), (0, 3), (4, 2)])
def test_structure_newton_options_match(trial_ip, fixed_newton):
    env = ci.flat_2d_lc
    jd = ci.dims_of(jhopper, env)
    ref = jfrom_gait(jhopper, env, load_gait("hopper_2D", "gait_in_place"),
                     kappa=KAPPA)
    lin = jlinearize(jhopper, env, ref, KAPPA)
    lin_w = type(lin)(*(x[:H - 1] for x in lin))
    q_ref, u_ref, th_t = ref.q[:H + 1], ref.u[:H - 1], ref.theta[:H - 1]
    qw = np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (H, 1))
    obj = jtracking(jd, H, q=qw, u=np.tile(np.array([3e-3, 1e0]), (H, 1)))
    n_opts = JNewtonOptions(r_tol=3e-4, max_iter=4, fixed_ip_iters=8,
                            trial_ip_iters=trial_ip,
                            fixed_newton_iters=fixed_newton,
                            ls_growth_allow=2.0)
    ip_opts = jdefault_opts(KAPPA)
    rng = np.random.default_rng(0)
    lanes = 3
    scale = 0.02 * (1 + np.arange(lanes))[:, None] / lanes
    q0 = np.asarray(ref.q[0]) + scale * rng.standard_normal((lanes, jd.nq))
    q1 = np.asarray(ref.q[1]) + scale * rng.standard_normal((lanes, jd.nq))
    alt = np.zeros((lanes, jd.nc))
    jsobj = jss.structure_objective_from_tracking(jd, obj, n_opts.beta_init,
                                                  H, jnp.float64)
    st_ref = jss.state_from_reference(q_ref, u_ref, jd, H, jnp.float64)

    want = jax.jit(jax.vmap(lambda a, b, c: jss.structure_newton_solve(
        jd, jsobj, lin_w, q_ref, u_ref, th_t, a, b, st_ref, c, ip_opts,
        n_opts, H)))(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(alt))

    dims = pt.Dims(nq=jd.nq, nu=jd.nu, nw=jd.nw, nc=jd.nc, nf=jd.nf, ne=jd.ne)
    t = lambda x: torch.as_tensor(np.asarray(x))
    sobj = ss.structure_objective_from_tracking(
        dims, interop.objective(obj, device="cpu"), n_opts.beta_init, H)
    state = ss.StructureState(*(t(x).expand((lanes,) + x.shape).clone()
                                for x in st_ref))
    got = ss.structure_newton_solve(
        dims, sobj, interop.linearized_data(lin_w, device="cpu"), t(q_ref),
        t(u_ref), t(th_t), t(q0), t(q1), state, t(alt),
        interop.ip_options(ip_opts), interop.newton_options(n_opts), H)
    assert int(np.asarray(want.iterations).max()) > 0
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    np.testing.assert_allclose(got.r_norm.numpy(), want.r_norm, rtol=1e-6,
                               atol=1e-10)
    for g, w in zip(got.state, want.state):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-8)


def test_hotpath_config_carries_every_newton_field():
    jcfg = JHotPath(newton_mode="direct", trial_ip_iters=4,
                    fixed_newton_iters=3)
    cfg = interop.hotpath_config(jcfg)
    assert cfg == HotPathConfig(newton_mode="direct", trial_ip_iters=4,
                                fixed_newton_iters=3)
    assert interop.newton_options(jcfg.newton_options()) == \
        cfg.newton_options()
    want = {f.name for f in dataclasses.fields(jcfg.newton_options())}
    assert want == {f.name for f in dataclasses.fields(cfg.newton_options())}


def test_direct_mode_hot_path_runs():
    """The quadruped rollout with the dense horizon KKT (300 × 300 a
    lane), float64, two lanes × one control period: Newton runs on the
    perturbed lane, every output is finite, the sim converges."""
    cfg = HotPathConfig(newton_mode="direct")
    roll, ref, model, _, dims = make_quadruped_rollout(
        cfg, cfg.n_sample, torch.float64, device="cpu")
    q1s, v1s = (x[:2] for x in conf_initial_states(model, ref))
    out = roll(q1s, v1s)
    assert out.q.shape == (2, cfg.n_sample + 2, dims.nq)
    assert all(torch.isfinite(x).all() for x in out if x.is_floating_point())
    assert bool(out.sim_converged.all())
    assert int(out.newton_iterations[1].max()) > 0


def test_public_surface():
    """Every name of ``contactimplicitmpc_tpu.__all__``-style exports that
    exists in the port is importable from its root, as from JAX's."""
    for name in ("simulate", "status", "ip_solve", "IPOptions", "IPResult",
                 "z_initialize", "residual", "pack_theta", "pack_z",
                 "SimTrajectory", "control_saturation", "default_sim_options",
                 "empty_policy", "empty_disturbances", "open_loop_policy",
                 "open_loop_disturbances", "impulse_disturbances",
                 "random_disturbances", "saturated_policy", "Dims", "Model",
                 "dims_of", "dynamics", "flat_2d_lc", "slope1_2d_lc"):
        assert hasattr(ci, name) and hasattr(pt, name), name
    assert hasattr(pt, "ci_mpc_policy") and hasattr(pt, "CIMPCOptions")


def test_spans_are_off_unless_started():
    x = torch.zeros(1)
    with spans.span("a", x):
        pass
    assert spans.stop() == {}
    spans.start()
    for _ in range(3):
        with spans.span("a", x):
            with spans.span("b"):
                pass
    got = spans.stop()
    assert set(got) == {"a", "b"} and got["a"][1] == 3 and got["b"][1] == 3
    assert got["a"][0] >= got["b"][0] >= 0.0
    assert spans.stop() == {}
