"""The port's structure-mode Newton solver against the JAX package
(float64, CPU; the masked sim ``ip_solve`` step of three lanes from the
gait's knots is a case of tests/test_torch_sim_ip.py's
``test_first_sim_step_matches_jax``, sharing its compiled JAX solve): the
block-tridiagonal Cholesky/solve and the structured KKT solve on
random data, the NaN factor of a block that is not positive definite, and
one ``structure_newton_solve`` from a perturbed state, the warm-start
shift. Inputs are numpy arrays (seeded) handed to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contactimplicitmpc_tpu.control import structure_solver as jss
from contactimplicitmpc_tpu.control.implicit_dynamics import nd_of as jnd_of
from contactimplicitmpc_tpu.control.linearized import LinearizedData as JLin
from contactimplicitmpc_tpu.dims import Dims as JDims
from contactimplicitmpc_tpu.hotpath import HotPathConfig as JHotPath

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control import structure_solver as ss
from contactimplicitmpc_tpu_torch.control.implicit_dynamics import (
    CONFIGURATION, CONFIGURATION_FORCE, nd_of)
from contactimplicitmpc_tpu_torch.control.linearized import (
    LinearizedData, linearize_trajectory)
from contactimplicitmpc_tpu_torch.control.trajectory import from_gait
from contactimplicitmpc_tpu_torch.dims import Dims
from contactimplicitmpc_tpu_torch.hotpath import HotPathConfig
from contactimplicitmpc_tpu_torch.models.base import dims_of
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

F64 = torch.float64
KAPPA = 2.0e-4


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


def t64(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


@pytest.fixture(scope="module")
def gait():
    dims = dims_of(quadruped, pt.flat_2d_lc)
    ref = from_gait(quadruped, pt.flat_2d_lc, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=F64, device="cpu")
    return dims, ref


def _random_blocks(seed, n=4, stages=7, batch=2):
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal((batch, stages, n, n))
    diag = diag @ np.swapaxes(diag, -1, -2) + 5 * np.eye(n)
    off = 0.3 * rng.standard_normal((batch, stages - 1, n, n))
    rhs = rng.standard_normal((batch, stages, n))
    return diag, off, rhs


def test_block_tridiag_matches_jax():
    """Cholesky sweep and solve over a batch of two systems, to 1e-12."""
    diag, off, rhs = _random_blocks(3)
    lii, lji = ss.block_tridiag_cholesky(t64(diag), t64(off))
    x = ss.block_tridiag_solve(lii, lji, t64(rhs))
    for b in range(2):
        jl, jo = jss.block_tridiag_cholesky(jnp.asarray(diag[b]),
                                            jnp.asarray(off[b]))
        jx = jss.block_tridiag_solve(jl, jo, jnp.asarray(rhs[b]))
        np.testing.assert_allclose(lii[b].numpy(), np.asarray(jl), atol=1e-12)
        np.testing.assert_allclose(lji[b].numpy(), np.asarray(jo), atol=1e-12)
        np.testing.assert_allclose(x[b].numpy(), np.asarray(jx), atol=1e-12)


def test_non_pd_block_gives_nan():
    """A block that is not positive definite yields a factor that is NaN
    in its lower triangle (as jnp.linalg.cholesky) in that batch entry
    only; the solve propagates it and nothing raises."""
    diag, off, rhs = _random_blocks(4)
    diag[1, 3] = -np.eye(diag.shape[-1])
    lii, lji = ss.block_tridiag_cholesky(t64(diag), t64(off))
    x = ss.block_tridiag_solve(lii, lji, t64(rhs))
    jl, _ = jss.block_tridiag_cholesky(jnp.asarray(diag[1]),
                                       jnp.asarray(off[1]))
    np.testing.assert_array_equal(lii[1, 3].numpy(), np.asarray(jl)[3])
    assert torch.isnan(torch.diagonal(lii[1, 3])).all()
    assert torch.isfinite(lii[0]).all() and torch.isfinite(x[0]).all()
    assert not torch.isfinite(x[1]).all()


def test_structure_kkt_solve_matches_jax():
    """Y blocks and the full structured KKT solve on random stage data
    (nq=3, nu=2, H=6; two batch entries), to 1e-10."""
    nq, nu, h = 3, 2, 6
    rng = np.random.default_rng(11)
    q_w = 0.5 + rng.random((h + 1, nq))
    v_w = 0.1 + 0.1 * rng.random((h + 1, nq))
    u_w = 0.5 + rng.random((h + 1, nu))
    shapes = dict(aa=(h, nq, nq), ab=(h, nq, nq), ba=(h, nq, nu),
                  rlagu=(h, nu), rlagqa=(h, nq), rlagqb=(h, nq),
                  rdyn1=(h, nq), rdyn2=(h, nq))
    data = {k: rng.standard_normal((2,) + s) * (0.3 if k[0] in "ab" else 1.0)
            for k, s in shapes.items()}
    dims = Dims(nq=nq, nu=nu, nw=0, nc=1, nf=2, ne=2)
    obj = ss.build_structure_objective(dims, t64(q_w), t64(v_w), t64(u_w),
                                       1e-6, h)
    jobj = jss.build_structure_objective(JDims(**dataclasses.asdict(dims)),
                                         jnp.asarray(q_w), jnp.asarray(v_w),
                                         jnp.asarray(u_w), 1e-6, h)
    for name in obj._fields:
        np.testing.assert_allclose(getattr(obj, name).numpy(),
                                   np.asarray(getattr(jobj, name)), atol=1e-12)
    got = ss.structure_kkt_solve(dims, obj, *(t64(data[k]) for k in shapes),
                                 1e-5, h)
    yii, yij = ss.compute_y_blocks(obj, t64(data["aa"]), t64(data["ab"]),
                                   t64(data["ba"]), 1e-5, h)
    for b in range(2):
        want = jss.structure_kkt_solve(
            JDims(**dataclasses.asdict(dims)), jobj,
            *(jnp.asarray(data[k][b]) for k in shapes), 1e-5, h)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), atol=1e-10)
        jy = jss.compute_y_blocks(jobj, *(jnp.asarray(data[k][b])
                                          for k in ("aa", "ab", "ba")), 1e-5, h)
        np.testing.assert_allclose(yii[b].numpy(), np.asarray(jy[0]),
                                   atol=1e-10)
        np.testing.assert_allclose(yij[b].numpy(), np.asarray(jy[1]),
                                   atol=1e-10)


def test_structure_newton_solve_matches_jax(gait):
    """One structure-mode Newton solve (HotPathConfig options) for two
    lanes from perturbed states over the first receding-horizon window:
    state, residual norm and iteration count agree, and the Newton loop
    does run."""
    dims, ref = gait
    cfg = HotPathConfig()
    h = cfg.h_mpc
    lin = linearize_trajectory(quadruped, pt.flat_2d_lc, ref, KAPPA)
    lin_w = LinearizedData(*(x[:h - 1] for x in lin))
    q_ref, u_ref = ref.q[:h + 1], ref.u[:h - 1]
    th_t = ref.theta[:h - 1]
    rng = np.random.default_rng(5)
    st = ss.state_from_reference(q_ref, u_ref, dims, h)
    st = ss.StructureState(*(x[None].expand((2,) + x.shape).numpy()
                             + 0.02 * rng.standard_normal((2,) + x.shape)
                             for x in st))
    q0 = ref.q[0].numpy() + 0.01 * rng.standard_normal((2, dims.nq))
    q1 = ref.q[1].numpy() + 0.01 * rng.standard_normal((2, dims.nq))
    sobj = ss.structure_objective_from_tracking(
        dims, pt.hotpath.quadruped_tracking_weights(dims, h, F64, "cpu"),
        cfg.newton_options().beta_init, h)
    got = ss.structure_newton_solve(
        dims, sobj, lin_w, q_ref, u_ref, th_t, t64(q0), t64(q1),
        ss.StructureState(*map(t64, st)), torch.zeros(2, dims.nc, dtype=F64),
        cfg.mpc_ip_options(), cfg.newton_options(), h)
    assert (got.iterations > 0).all()

    jcfg = JHotPath()
    jd = JDims(**dataclasses.asdict(dims))
    jsobj = jss.StructureObjective(*(jnp.asarray(x.numpy()) for x in sobj))
    jlin = JLin(*(jnp.asarray(x.numpy()) for x in lin_w))

    def one(q0_, q1_, st_):
        return jss.structure_newton_solve(
            jd, jsobj, jlin, jnp.asarray(q_ref.numpy()),
            jnp.asarray(u_ref.numpy()), jnp.asarray(th_t.numpy()), q0_, q1_,
            jss.StructureState(*st_), jnp.zeros(dims.nc), jcfg.mpc_ip_options(),
            jcfg.newton_options(), h)

    want = jax.jit(jax.vmap(one))(jnp.asarray(q0), jnp.asarray(q1),
                                  tuple(jnp.asarray(x) for x in st))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_allclose(got.r_norm.numpy(), np.asarray(want.r_norm),
                               rtol=1e-6)
    for g, w in zip(got.state, want.state):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-8)
    # the options the two packages ran agree field by field
    assert interop.newton_options(jcfg.newton_options()) == \
        cfg.newton_options()
    assert interop.ip_options(jcfg.mpc_ip_options()) == cfg.mpc_ip_options()


def test_shift_state_and_modes_match_jax(gait):
    """The receding-horizon shift of the full warm start (the main path
    warm-starts duals only) for two lanes, exactly; ``nd_of`` of both
    implicit-dynamics modes."""
    dims, ref = gait
    h = HotPathConfig().h_mpc
    rng = np.random.default_rng(7)
    st = ss.state_from_reference(ref.q[:h + 1], ref.u[:h - 1], dims, h)
    st = [x[None].expand((2,) + x.shape).numpy()
          + rng.standard_normal((2,) + x.shape) for x in st]
    q_ref, u_ref = ref.q[1:h + 2], ref.u[1:h]
    got = ss.shift_state(ss.StructureState(*map(t64, st)), q_ref, u_ref, h)
    for b in range(2):
        want = jss.shift_state(
            jss.StructureState(*(jnp.asarray(x[b]) for x in st)),
            jnp.asarray(q_ref.numpy()), jnp.asarray(u_ref.numpy()), h)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    jd = JDims(**dataclasses.asdict(dims))
    for mode in (CONFIGURATION, CONFIGURATION_FORCE):
        assert nd_of(dims, mode) == jnd_of(jd, mode)


@pytest.mark.parametrize("velocity", [False, True])
def test_structure_objective_from_tracking_matches_jax(gait, velocity):
    """The stage blocks of a tracking objective with and without velocity
    weights (a ``TrackingVelocityObjective``'s v weights enter the stage
    blocks, as tests/test_mpc_structure_mode.py's objective has them), to
    1e-12, on seeded numpy weights."""
    from contactimplicitmpc_tpu.control import objective as jo

    from contactimplicitmpc_tpu_torch.control import objective as to

    dims, _ = gait
    h = HotPathConfig().h_mpc
    rng = np.random.default_rng(9)
    w = dict(q=rng.uniform(0.1, 1.0, (h, dims.nq)),
             u=rng.uniform(0.1, 1.0, (h, dims.nu)))
    if velocity:
        w["v"] = rng.uniform(0.1, 1.0, (h, dims.nq))
    make_t = (to.tracking_velocity_objective if velocity
              else to.tracking_objective)
    make_j = (jo.tracking_velocity_objective if velocity
              else jo.tracking_objective)
    got = ss.structure_objective_from_tracking(
        dims, make_t(dims, h, dtype=F64, device="cpu", **w), 1e-5, h)
    jd = JDims(**dataclasses.asdict(dims))
    want = jss.structure_objective_from_tracking(
        jd, make_j(jd, h, dtype=jnp.float64, **w), 1e-5, h, jnp.float64)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=0,
                                   atol=1e-12)
