"""Parity of the PyTorch port's model layer with the JAX package (float64,
CPU): Dims, the quadruped's kinematics and dynamics, the gait trajectory,
the NCP residual and its Jacobians. Inputs are numpy arrays handed to both
packages.

Also checks that no file of the port, nor ``chip_smoke.py`` and
tests/test_torch_cuda.py, imports JAX or the JAX package (by parsing the
sources: this interpreter may have JAX loaded already)."""

import ast
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.control import from_gait as jfrom_gait
from contactimplicitmpc_tpu.control.linearized import LinearizedData as JLin
from contactimplicitmpc_tpu.hotpath import \
    quadruped_tracking_weights as jquadruped_tracking_weights
from contactimplicitmpc_tpu.models import quadruped as jquad
from contactimplicitmpc_tpu.models.base import dims_of as jdims_of
from contactimplicitmpc_tpu.models.base import dynamics as jdynamics
from contactimplicitmpc_tpu.models.quadruped import \
    initial_configuration as jinit_conf
from contactimplicitmpc_tpu.utils.gaits import load_gait as jload_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control.linearized import \
    linearize_trajectory
from contactimplicitmpc_tpu_torch.control.trajectory import from_gait
from contactimplicitmpc_tpu_torch.hotpath import quadruped_tracking_weights
from contactimplicitmpc_tpu_torch.models.base import Model, dims_of, dynamics
from contactimplicitmpc_tpu_torch.models.quadruped import (
    initial_configuration, quadruped)
from contactimplicitmpc_tpu_torch.sim.residual import residual
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def gait_pair():
    env_j, env_t = ci.flat_2d_lc, pt.flat_2d_lc
    ref_j = jfrom_gait(jquad, env_j, jload_gait("quadruped", "gait2"),
                       update_friction=True)
    ref_t = from_gait(quadruped, env_t, load_gait("quadruped", "gait2"),
                      update_friction=True, dtype=F64, device="cpu")
    return ref_j, ref_t


def test_dims_match_jax():
    dj, dt = jdims_of(jquad, ci.flat_2d_lc), dims_of(quadruped, pt.flat_2d_lc)
    assert (dt.nq, dt.nu, dt.nw, dt.nc, dt.nb, dt.nz, dt.ntheta, dt.nx,
            dt.ny) == (11, 8, 2, 4, 8, 43, 34, 11, 16)
    names = [n for n, v in vars(type(dj)).items() if isinstance(v, property)]
    names += [f.name for f in dataclasses.fields(dj)]
    for name in names:
        assert getattr(dt, name) == getattr(dj, name), name


def test_gait_file_is_the_same():
    gj, gt = jload_gait("quadruped", "gait2"), load_gait("quadruped", "gait2")
    assert gj.keys() == gt.keys()
    for k in gj:
        np.testing.assert_array_equal(gj[k], gt[k])


def test_from_gait_matches(gait_pair):
    """z and θ of every gait knot, and the scalars, agree to 1e-12."""
    ref_j, ref_t = gait_pair
    for name in ("h", "kappa", "q", "u", "w", "gamma", "b", "z", "theta"):
        np.testing.assert_allclose(getattr(ref_t, name).numpy(),
                                   np.asarray(getattr(ref_j, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    again = interop.contact_traj(ref_j, device="cpu")
    np.testing.assert_array_equal(again.z.numpy(), np.asarray(ref_j.z))


def test_kinematics_mass_matrix_dynamics():
    """Feet, foot Jacobians, M(q), C(q, v) and the Euler–Lagrange residual
    at random states agree with the JAX model to 1e-10 (relative to the
    magnitude of each quantity)."""
    rng = np.random.default_rng(0)
    n = 3
    q0, q1, q2, lam = (rng.standard_normal((n, 11)) * 0.5 for _ in range(4))
    u1, w1 = rng.standard_normal((n, 8)), rng.standard_normal((n, 2))
    h = 0.01

    def jax_parts(q0, q1, q2, u1, w1, lam):
        return (jquad.kinematics(q1), jquad.contact_jacobian(q1),
                jquad.mass_matrix(q1), jquad.bias(q1, q2),
                jdynamics(jquad, h, q0, q1, u1, w1, lam, q2))

    def torch_parts(q0, q1, q2, u1, w1, lam):
        return (quadruped.kinematics(q1), quadruped.contact_jacobian(q1),
                quadruped.mass_matrix(q1), quadruped.bias(q1, q2),
                dynamics(quadruped, torch.tensor(h, dtype=F64), q0, q1, u1,
                         w1, lam, q2))

    args = (q0, q1, q2, u1, w1, lam)
    want = jax.jit(jax.vmap(jax_parts))(*map(jnp.asarray, args))
    got = torch.func.vmap(torch_parts)(*map(t64, args))
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(1.0, float(np.max(np.abs(w))))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10 * scale)


def test_closed_forms_match_torch_func():
    """The quadruped's closed-form com/foot Jacobians and bias equal the
    torch.func derivatives (jacfwd of the positions, the autodiff default
    of ``Model.bias``) they replace."""
    rng = np.random.default_rng(1)
    q, v = t64(rng.standard_normal(11)), t64(rng.standard_normal(11))
    jac = torch.func.jacfwd(quadruped._com_positions)(q)
    np.testing.assert_allclose(
        torch.einsum("b,bin,bim->nm", t64(quadruped._masses), jac, jac).numpy()
        + np.diag([0.0, 0.0] + quadruped._inertias),
        quadruped.mass_matrix(q).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        torch.func.jacfwd(lambda qq: quadruped.kinematics(qq).reshape(-1))(q),
        quadruped.contact_jacobian(q).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Model.bias(quadruped, q, v).numpy(),
                               quadruped.bias(q, v).numpy(), rtol=1e-12,
                               atol=1e-10)
    np.testing.assert_allclose(Model.mass_matrix(quadruped, q).numpy(),
                               quadruped.mass_matrix(q).numpy(), rtol=0,
                               atol=1e-12)


def test_initial_configuration():
    rng = np.random.default_rng(2)
    conf = np.array([0.0, 0.6, 0.6, 0.6, -0.2, 0.0]) + rng.random((4, 6)) * \
        np.array([0.05, 0.2, 0.2, 0.2, 0.4, 0.1])
    got = initial_configuration(quadruped, *t64(conf).T)
    want = np.stack([np.asarray(jinit_conf(jquad, *map(jnp.asarray, c)))
                     for c in conf])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_residual_and_jacobians_at_gait_knots(gait_pair):
    """r at the 60 gait2 knots to 1e-10; rz and rθ (linearize_trajectory,
    the data every knot solve starts from) to 1e-9."""
    ref_j, ref_t = gait_pair
    kappa = 2.0e-4
    nz = ref_j.z.shape[1]

    def jax_knot(z, th):
        """r(z, θ, 0) and one forward-mode Jacobian in (z, θ): the
        definition of JAX's rz and rθ (residual_z/theta_jacobian), in one
        compiled program to keep the compile short."""
        f = lambda x: ci.residual(jquad, ci.flat_2d_lc, x[:nz], x[nz:], 0.0)
        x = jnp.concatenate([z, th])
        return f(x), jax.jacfwd(f)(x)

    r_j, jac_j = map(np.asarray, jax.jit(jax.vmap(jax_knot))(ref_j.z,
                                                               ref_j.theta))
    lin_t = linearize_trajectory(quadruped, pt.flat_2d_lc, ref_t, kappa)
    r_t = torch.func.vmap(lambda z, th: residual(
        quadruped, pt.flat_2d_lc, z, th, 0.0))(ref_t.z, ref_t.theta)
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=0, atol=1e-10)
    # JAX's LinearizedData of these knots; its r0 is at κ, so the bilinear
    # rows shift by −κ
    r0_j = r_j.copy()
    r0_j[:, -16:] -= kappa
    want = interop.linearized_data(JLin(
        z0=ref_j.z, theta0=ref_j.theta, r0=r0_j, rz0=jac_j[:, :, :nz],
        rtheta0=jac_j[:, :, nz:]), device="cpu")
    for name in want._fields:
        w = getattr(want, name).numpy()
        tol = 1e-9 * np.abs(w).max() if name in ("rz0", "rtheta0") else 1e-10
        np.testing.assert_allclose(getattr(lin_t, name).numpy(), w, rtol=0,
                                   atol=tol, err_msg=name)


def test_tracking_objective_matches_jax():
    """The hot path's tracking weights, carried across from JAX's."""
    want = interop.tracking_objective(jquadruped_tracking_weights(
        jdims_of(jquad, ci.flat_2d_lc), 10, jnp.float64), device="cpu")
    got = quadruped_tracking_weights(dims_of(quadruped, pt.flat_2d_lc), 10,
                                     F64, "cpu")
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy())


def _port_sources():
    pkg = os.path.join(ROOT, "contactimplicitmpc_tpu_torch")
    for base, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    for pattern in ("examples/torch_*.py", "tools/torch_*.py",
                    "tests/test_torch_cuda.py",
                    "tests/test_torch_examples*.py"):
        yield from sorted(glob.glob(os.path.join(ROOT, pattern)))


def test_port_never_imports_jax():
    """No module of the port (nor chip_smoke.py, the port's examples and
    tools, nor the tests run on the card and the files they import) imports
    jax or the JAX package; the machine with the card has neither."""
    checked = 0
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib", "contactimplicitmpc_tpu"), \
                    (path, m)
        checked += 1
    assert checked >= 60
