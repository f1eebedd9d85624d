"""The quadruped's sim kernel (``csrc/sim_ip.cu``, ``ops/sim_ip.py``) on the
CPU, where the kernel cannot run: its packed model and formulas, the route
``SimSolve`` takes, and the wrapper's refusals.

- ``packed_residual`` is the kernel's residual written in PyTorch from the
  packed table alone (``csrc/sim_ip.cu``'s ``theta_terms``, ``rows`` and
  the bilinear rows: the midpoint terms as sums over the nine bodies of
  J_bᵀ m_b(...), J(q2)ᵀλ, the feet's heights and velocities over the lever
  arms). It is held to the port's ``residual`` and the JAX package's at
  1e-12 in float64 for ``quadruped`` and ``quadruped_payload`` on seeded
  points, and its forward-mode Jacobian to ``jacfwd`` of the port's.
  ``packed_jacobian`` is the kernel's closed-form Jacobian in (x, y1)
  (``jacobian``: the bodies' force derivatives summed through the lever
  arms, the diagonal's own terms, the contact rows), held at 1e-10 to
  ``jacfwd`` of the port's residual and to ``jax.jacfwd`` of the JAX
  package's, with the y2 identity the kernel assumes.
- The block's geometry, which the header alone sets (its threads, and its
  shared bytes from ``struct Prob`` and the source's scratch), fits an
  H100's 227 KB for max_ls 0–63, for the quadruped and at the centroidal
  family's widths.
- On CPU tensors ``SimSolve`` routes the quadruped to ``ip_solve``, and on
  the first sim step of the 16 lanes of ``assets/hotpath_conf16.npz``
  (the gait's first control, 0.3·N(0, 1) added from
  numpy.random.default_rng(3)) it matches the JAX package's ``ip_solve``
  in float64 with the hot path's sim options (24 masked trips) and with
  ``simulate``'s (adaptive, 25 halvings): flags and iteration counts
  exactly (but one lane's with ``simulate``'s r_tol of 1e-8, at the float64
  floor), z to 1e-8, phase S's float64 bound (two summation orders of the
  same float64 arithmetic; ``tests/test_torch_ip_solve.py`` holds the
  other models); and on one step of three lanes from the gait's knots with
  the hot path's options, z to 1e-9, rvio and kvio to 1e-12. The JAX solve
  is jitted for one lane with its residual jitted inside, once for each
  options, and called a lane at a time: tracing it under ``vmap`` takes
  twice as long.
- ``sim_ip`` raises on CPU tensors, and on every input it does not take;
  the packed table reads every constant from the model; ``SimSolve``'s
  route on CUDA tensors follows ``ops.sim_ip.KERNELS`` alone; the bound's
  rate follows the tensors' type.
- The state of phase L's closed loop where a float32 solve stalls
  (``contactimplicitmpc_tpu_torch/assets/sim_ip_f32_stall.npz``, written
  on the card by ``tools/sim_ip_f32_stall.py --write``) converges in
  float64.
"""

import dataclasses
import json
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.models import quadruped as jquadruped
from contactimplicitmpc_tpu.models import quadruped_payload as jpayload

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch.control.trajectory import from_gait
from contactimplicitmpc_tpu_torch.hotpath import (HotPathConfig,
                                                  conf_initial_states)
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d
from contactimplicitmpc_tpu_torch.models.quadruped import (quadruped,
                                                           quadruped_payload)
from contactimplicitmpc_tpu_torch.ops import sim_ip as sim_mod
from contactimplicitmpc_tpu_torch.sim.graphs import SimSolve
from contactimplicitmpc_tpu_torch.sim.interior_point import (IPOptions,
                                                             z_initialize)
from contactimplicitmpc_tpu_torch.sim.residual import pack_theta, residual
from contactimplicitmpc_tpu_torch.sim.simulator import default_sim_options
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

MODELS = {"quadruped": (jquadruped, quadruped),
          "quadruped_payload": (jpayload, quadruped_payload)}
# the JAX package's residual of each model, one sample, jitted once for the
# module: the residual test and the solves (which trace it inside) share it
JAX_RESIDUAL = {name: jax.jit(lambda z, th, k, m=jmodel: ci.residual(
    m, ci.flat_2d_lc, z, th, k)) for name, (jmodel, _) in MODELS.items()}
CFG = HotPathConfig()
F64 = dict(dtype=torch.float64, device="cpu")
STALL = os.path.join(os.path.dirname(pt.__file__), "assets",
                     "sim_ip_f32_stall.npz")


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


def unpack(pack) -> dict:
    """``name → tensor`` views of a packed vector (``PACK_LAYOUT``)."""
    out, off = {}, 0
    for name, shape in sim_mod.PACK_LAYOUT:
        size = int(np.prod(shape))
        out[name] = pack[off:off + size].reshape(shape)
        off += size
    return out


def packed_residual(pack, z, theta, kappa):
    """r(z, θ, κ) of one sample from the packed table alone, with the
    kernel's formulas."""
    p = unpack(pack)
    arms, feet = p["arms"][:9], p["arms"][9:]
    mass, g = p["masses"], p["g"]
    q2, gam, b, psi = z[:11], z[11:15], z[15:23], z[23:27]
    s1, eta, s2 = z[27:31], z[31:39], z[39:43]
    q0, q1, u, w = theta[:11], theta[11:22], theta[22:30], theta[30:32]
    mu, h = theta[32], theta[33]
    hh = 0.5 * h

    def midpoint(q, v, sgn):
        sn, cs = torch.sin(q[2:]), torch.cos(q[2:])
        va = v[2:]
        jvx = v[0] + arms @ (cs * va)
        jvz = v[1] + arms @ (sn * va)
        jdx = -(arms @ (va * va * sn))
        jdz = arms @ (va * va * cs)
        fx = mass * (sgn * jvx - hh * jdx)
        fz = mass * (sgn * jvz - hh * (jdz + g))
        angles = (arms * (cs * fx[:, None] + sn * fz[:, None])).sum(0)
        return torch.cat([fx.sum()[None], fz.sum()[None],
                          angles + sgn * p["inertias"] * va])

    vm1, vm2 = (q1 - q0) / h, (q2 - q1) / h
    dyn = (midpoint(0.5 * (q0 + q1), vm1, 1.0)
           + p["control_jacobian"].T @ u + p["disturbance_jacobian"].T @ w
           + midpoint(0.5 * (q1 + q2), vm2, -1.0)
           - h * p["joint_friction"] * vm2)
    sn, cs = torch.sin(q2[2:]), torch.cos(q2[2:])
    lx, lz = b[0::2] - b[1::2], gam
    dyn = dyn + torch.cat([lx.sum()[None], lz.sum()[None],
                           (feet * (cs * lx[:, None] + sn * lz[:, None])).sum(0)])
    phi = q2[1] - feet @ cs
    vt = ((q2[0] - q1[0]) + (feet * cs) @ (q2[2:] - q1[2:])) / h
    mdp = torch.stack([eta[0::2] - vt - psi, eta[1::2] + vt - psi],
                      dim=-1).reshape(8)
    fri = s2 - (mu * gam - (b[0::2] + b[1::2]))
    return torch.cat([dyn, s1 - phi, mdp, fri, gam * s1 - kappa,
                      b * eta - kappa, psi * s2 - kappa])


def packed_jacobian(pack, z, theta):
    """∂r/∂(x, y1) (27 × 27) of one sample from the packed table alone, with
    the kernel's closed form (``csrc/sim_ip.cu``'s ``jacobian``): each
    body's force derivative (dfx, dfz) along each column of q2 summed
    through the lever arms, the angle's own terms on the diagonal, J(q2)ᵀ
    along λ, the contact Jacobian at q2, the feet's velocity rows and the
    friction cone's constants."""
    p = unpack(pack)
    arms, feet = p["arms"][:9], p["arms"][9:]
    mass, g = p["masses"], p["g"]
    q2, gam, b = z[:11], z[11:15], z[15:23]
    q1, mu, h = theta[11:22], theta[32], theta[33]
    hh = 0.5 * h
    ang = 0.5 * (q1[2:] + q2[2:])
    sn, cs = torch.sin(ang), torch.cos(ang)
    sn2, cs2 = torch.sin(q2[2:]), torch.cos(q2[2:])
    v = (q2 - q1) / h
    va = v[2:]
    # the bodies' forces at the second midpoint (sgn = −1)
    fx = mass * (-(v[0] + arms @ (cs * va)) + hh * (arms @ (va * va * sn)))
    fz = mass * (-(v[1] + arms @ (sn * va)) - hh * (arms @ (va * va * cs) + g))
    # their derivatives along q2: v moves by 1/h, the midpoint angle by 1/2
    dfx = torch.zeros((9, 11), dtype=z.dtype)
    dfz = torch.zeros((9, 11), dtype=z.dtype)
    dfx[:, 0] = mass * (-1.0 / h)
    dfz[:, 1] = mass * (-1.0 / h)
    djvx = arms * (cs / h - 0.5 * va * sn)
    djvz = arms * (sn / h + 0.5 * va * cs)
    djdx = -arms * (2 * va * sn / h + 0.5 * va * va * cs)
    djdz = arms * (2 * va * cs / h - 0.5 * va * va * sn)
    dfx[:, 2:] = mass[:, None] * (-djvx - hh * djdx)
    dfz[:, 2:] = mass[:, None] * (-djvz - hh * djdz)
    lx, lz = b[0::2] - b[1::2], gam
    jac = torch.zeros((27, 27), dtype=z.dtype)
    jac[0, :11], jac[1, :11] = dfx.sum(0), dfz.sum(0)
    jac[2:11, :11] = cs[:, None] * (arms.T @ dfx) + sn[:, None] * (arms.T @ dfz)
    own = (0.5 * (arms * (cs * fz[:, None] - sn * fx[:, None])).sum(0)
           - p["inertias"] / h
           + (feet * (cs2 * lz[:, None] - sn2 * lx[:, None])).sum(0))
    jac[range(11), range(11)] -= p["joint_friction"]
    jac[range(2, 11), range(2, 11)] += own
    for c in range(4):
        # J(q2)ᵀ λ along γ_c (λ_z) and b_2c, b_2c+1 (λ_x = b_2c − b_2c+1)
        jac[1, 11 + c] = 1.0
        jac[2:11, 11 + c] = feet[c] * sn2
        jac[0, 15 + 2 * c], jac[0, 16 + 2 * c] = 1.0, -1.0
        jac[2:11, 15 + 2 * c] = feet[c] * cs2
        jac[2:11, 16 + 2 * c] = -feet[c] * cs2
        # impact: s1 − φ
        jac[11 + c, 1] = -1.0
        jac[11 + c, 2:11] = -feet[c] * sn2
        # maximum dissipation: η ∓ vt − ψ
        dvt = feet[c] * (cs2 - sn2 * (q2[2:] - q1[2:])) / h
        for m, sg in ((2 * c, -1.0), (2 * c + 1, 1.0)):
            jac[15 + m, 0] = sg / h
            jac[15 + m, 2:11] = sg * dvt
            jac[15 + m, 23 + c] = -1.0
        # friction cone: s2 − (μγ − (b_2c + b_2c+1))
        jac[23 + c, 11 + c] = -mu
        jac[23 + c, 15 + 2 * c] = jac[23 + c, 16 + 2 * c] = 1.0
    return jac


def points(n=6, seed=0):
    """(z, θ) (n, ·) float64 near the gait's stance: angles and positions
    moved by up to 0.2, velocities up to 1, cone variables in (0, 1)."""
    ref = from_gait(quadruped, pt.flat_2d_lc, load_gait("quadruped", "gait2"),
                    **F64)
    rng = np.random.default_rng(seed)
    q = ref.q[2].numpy()
    q1 = q + rng.uniform(-0.2, 0.2, (n, 11))
    h = 0.02
    q0 = q1 - h * rng.uniform(-1, 1, (n, 11))
    q2 = q1 + h * rng.uniform(-1, 1, (n, 11))
    theta = np.concatenate([q0, q1, rng.standard_normal((n, 8)),
                            rng.standard_normal((n, 2)),
                            np.full((n, 1), 0.8), np.full((n, 1), h)], axis=1)
    z = np.concatenate([q2, rng.uniform(0, 1, (n, 32))], axis=1)
    return z, theta


@pytest.mark.parametrize("name", list(MODELS))
def test_packed_residual_matches(name):
    """The kernel's residual from the packed table against the port's and
    the JAX package's, 1e-12."""
    _, model = MODELS[name]
    z, theta = points()
    pack = torch.as_tensor(sim_mod.pack_quadruped(model))
    kappa = 1e-3
    got = torch.stack([packed_residual(pack, a, b, kappa) for a, b in zip(
        torch.as_tensor(z), torch.as_tensor(theta))]).numpy()
    port = torch.func.vmap(lambda a, b: residual(
        model, pt.flat_2d_lc, a, b, kappa))(torch.as_tensor(z),
                                            torch.as_tensor(theta)).numpy()
    want = np.stack([np.asarray(JAX_RESIDUAL[name](a, b, kappa))
                     for a, b in zip(z, theta)])
    np.testing.assert_allclose(got, port, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", list(MODELS))
def test_packed_residual_jacobian_matches(name):
    """The forward-mode Jacobian of the packed residual in z (the kernel's
    dual lanes take its first 27 columns) against ``jacfwd`` of the port's
    residual (held to ``jax.jacfwd`` of the JAX package's by
    tests/test_torch_model.py), 1e-10."""
    _, model = MODELS[name]
    z, theta = points(n=3, seed=1)
    pack = torch.as_tensor(sim_mod.pack_quadruped(model))
    for a, b in zip(torch.as_tensor(z), torch.as_tensor(theta)):
        got = torch.func.jacfwd(lambda zz: packed_residual(pack, zz, b, 0.0))(a)
        want = pt.residual_z_jacobian(model, pt.flat_2d_lc, a, b)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("name", list(MODELS))
def test_packed_jacobian_closed_form_matches(name):
    """The kernel's closed-form Jacobian in (x, y1) against ``jacfwd`` of
    the port's residual and ``jax.jacfwd`` of the JAX package's, 1e-10;
    the rest of the equality rows' Jacobian is the y2 identity the kernel
    assumes (zero in the dynamics rows, one on the diagonal below)."""
    jmodel, model = MODELS[name]
    z, theta = points(n=2, seed=2)
    pack = torch.as_tensor(sim_mod.pack_quadruped(model))
    jax_jac = jax.jit(jax.jacfwd(lambda zz, th: ci.residual(
        jmodel, ci.flat_2d_lc, zz, th, 0.0)))
    for a, b in zip(torch.as_tensor(z), torch.as_tensor(theta)):
        got = packed_jacobian(pack, a, b).numpy()
        port = pt.residual_z_jacobian(model, pt.flat_2d_lc, a, b).numpy()
        want = np.asarray(jax_jac(a.numpy(), b.numpy()))
        for full in (port, want):
            np.testing.assert_allclose(got, full[:27, :27], rtol=0, atol=1e-10)
            np.testing.assert_array_equal(full[:11, 27:], 0.0)
            np.testing.assert_array_equal(full[11:27, 27:], np.eye(16))


def source_constants(src: str) -> dict:
    """Every ``constexpr int`` of a model's CUDA source, evaluated in order
    (its struct's ``::`` aliases read the file's own)."""
    env = {}
    for decl in re.findall(r"constexpr int ([^;]+);", src):
        for item in decl.split(","):
            name, expr = item.split("=", 1)
            env[name.strip()] = eval(expr.replace("::", ""), {}, env)
    return env


def test_launch_geometry_fits_and_matches_the_source():
    """The block's geometry is the header's alone: a block is its
    ``kThreads`` (256) threads, and ``shared_bytes`` (``struct Prob``'s
    ``kValues``, then each candidate's rows and scratch), evaluated from the
    header's own expressions at the quadruped's constants as
    ``csrc/sim_ip.cu`` declares them, fits an H100's 227 KB for max_ls
    0–63 in either arithmetic, and so it does at the centroidal family's
    widths (18, 24). (Each instantiation asserts its fit at build time.)"""
    with open(sim_mod.HEADER) as f:
        header = f.read()
    with open(sim_mod.QUADRUPED.source) as f:
        quad = source_constants(f.read())
    assert re.search(r"constexpr int kThreads = (\d+);", header).group(1) == "256"
    kernel = sim_mod.QUADRUPED
    assert (quad["NX"], quad["NY"], quad["NT"], quad["kPackSize"]) == (
        kernel.nx, kernel.ny, kernel.nt, kernel.pack_size)

    def strip(expr):
        return " ".join(expr.replace("Prob<M, S>::", "").replace(
            "M::", "").split())
    values = strip(re.search(r"kValues =(.*?);", header, re.S).group(1))
    per_value = strip(re.search(r"int shared_bytes\(int max_ls\) \{\s*"
                                r"return int\(sizeof\(S\)\) \* (.*?);\n\}",
                                header, re.S).group(1))

    def shared_bytes(model, max_ls, value_bytes):
        nx, ny = model["NX"], model["NY"]
        env = dict(model, NE=nx + ny, NZ=nx + 2 * ny, NM=max(nx, ny),
                   kMaxCand=2 * (sim_mod.MAX_LS + 1), max_ls=max_ls)
        env["kValues"] = eval(values, {}, env)
        return value_bytes * eval(per_value, {}, env)
    wide = dict(NX=18, NY=24, NT=53, NCST=18, kPackSize=600,
                kJacScratch=2 * 42 * 18 + 100, kEvalScratch=100)
    for model in (quad, wide):
        for value_bytes in (4, 8):
            sizes = [shared_bytes(model, ls, value_bytes)
                     for ls in range(sim_mod.MAX_LS + 1)]
            assert sizes == sorted(sizes) and sizes[0] > 0
            assert sizes[-1] <= 227 * 1024   # an H100 block's shared memory


def test_pack_layout_matches_the_source():
    """``PACK_LAYOUT``'s offsets are the source's P_* constants, and its
    length the source's kPackSize (``_load`` holds the built kernel's to it
    too)."""
    with open(sim_mod.QUADRUPED.source) as f:
        src = f.read()
    env = dict(NPOINT=13, NA=9, NBODY=9, NQ=11, NU=8, NW=2)
    pattern = (r"\b(P_[A-Z]+|kPackSize|kPointAngles|kAngleBodies|kAngleFeet)"
               r" = ([^,;:]+)[,;]")
    for name, expr in re.findall(pattern, src):
        env[name] = eval(expr, {}, env)
    offsets, off = {}, 0
    for name, shape in sim_mod.PACK_LAYOUT:
        offsets[name] = off
        off += int(np.prod(shape))
    assert [env[k] for k in ("P_ARMS", "P_MASS", "P_INERTIA", "P_JF", "P_B",
                             "P_A", "P_G", "P_PA", "P_AB", "P_AF")] == list(
        offsets.values())
    assert (env["kPointAngles"], env["kAngleBodies"], env["kAngleFeet"]) == (
        sim_mod.POINT_ANGLES, sim_mod.ANGLE_BODIES, sim_mod.ANGLE_FEET)
    assert env["kPackSize"] == sim_mod.PACK_SIZE == off
    assert sim_mod.pack_quadruped(quadruped).shape == (off,)


def test_pack_reads_every_constant_from_the_model():
    """Each block of the packed table is the model's own: a model whose
    disturbance Jacobian or control Jacobian differs packs them; the lever
    arms' lists (``sparse_arms``) are the dense table's nonzeros."""
    pack = unpack(torch.as_tensor(sim_mod.pack_quadruped(quadruped)))
    q = torch.zeros(quadruped.nq, dtype=torch.float64)
    np.testing.assert_array_equal(pack["disturbance_jacobian"].numpy(),
                                  quadruped.disturbance_jacobian(q).numpy())
    np.testing.assert_array_equal(pack["control_jacobian"].numpy(),
                                  quadruped._b)
    # the lever arms' lists hold their nonzeros, each in ascending index
    arms = pack["arms"].numpy()
    for name, rows in (("point_angles", arms), ("angle_bodies", arms[:9].T),
                       ("angle_feet", arms[9:].T)):
        lists = pack[name].numpy()
        dense = np.zeros_like(rows)
        for r, entry in enumerate(lists):
            n = int(entry[0])
            idx = entry[1:1 + 2 * n:2].astype(int)
            assert list(idx) == sorted(idx) and not entry[1 + 2 * n:].any()
            dense[r, idx] = entry[2:2 + 2 * n:2]
        np.testing.assert_array_equal(dense, rows)
    other = type(quadruped)()
    a = np.arange(22.0).reshape(2, 11) / 7.0
    other.disturbance_jacobian = lambda q: torch.as_tensor(a, dtype=q.dtype)
    moved = unpack(torch.as_tensor(sim_mod.pack_quadruped(other)))
    np.testing.assert_array_equal(moved["disturbance_jacobian"].numpy(), a)


def first_sim_step():
    """(z0, θ) float64 of the first sim step of the hot path's 16 lanes."""
    ref = from_gait(quadruped, pt.flat_2d_lc, load_gait("quadruped", "gait2"),
                    update_friction=True, **F64)
    q1, v1 = conf_initial_states(quadruped, ref)
    h = float(ref.h) / CFG.n_sample
    u = (ref.u[0] / CFG.n_sample + torch.as_tensor(
        0.3 * np.random.default_rng(3).standard_normal((16, 8))))
    theta = pack_theta(q1 - h * v1, q1, u, torch.zeros((16, 2), **F64),
                       quadruped.mu_world, h)
    dims = pt.dims_of(quadruped, pt.flat_2d_lc)
    return dims, z_initialize(dims, q1), theta


def gait_knot_step():
    """(z0, θ) float64 of one sim step of three lanes from the gait's first
    two knots, the nominal state and two with q1 moved by 0.01·N(0, 1)
    (numpy.random.default_rng(0))."""
    ref = from_gait(quadruped, pt.flat_2d_lc, load_gait("quadruped", "gait2"),
                    update_friction=True, **F64)
    h = float(ref.h) / CFG.n_sample
    rng = np.random.default_rng(0)
    q0 = ref.q[0].numpy() + np.zeros((3, 1))
    q1 = ref.q[1].numpy() + np.zeros((3, 1))
    q1[1:] += 0.01 * rng.standard_normal((2, quadruped.nq))
    u = np.repeat(ref.u[:1].numpy() / CFG.n_sample, 3, axis=0)
    q1 = torch.as_tensor(q1)
    theta = pack_theta(torch.as_tensor(q0), q1, torch.as_tensor(u),
                       torch.zeros((3, 2), **F64), quadruped.mu_world, h)
    dims = pt.dims_of(quadruped, pt.flat_2d_lc)
    return z_initialize(dims, q1), theta


_JAX_SOLVES = {}   # options → the JAX package's ip_solve of one lane, jitted


def jax_solve(opts):
    key = dataclasses.astuple(opts)
    if key not in _JAX_SOLVES:
        jd = ci.dims_of(jquadruped, ci.flat_2d_lc)
        r_j = JAX_RESIDUAL["quadruped"]
        jopts = ci.IPOptions(**dataclasses.asdict(opts))
        _JAX_SOLVES[key] = jax.jit(
            lambda z, th: ci.ip_solve(jd, r_j, z, th, jopts))
    return _JAX_SOLVES[key]


@pytest.mark.parametrize("options", ["hot_path", "simulate", "gait_knots"])
def test_first_sim_step_matches_jax(options):
    """``SimSolve`` routes CPU tensors to ``ip_solve``, and matches the JAX
    package's ``ip_solve`` in float64: on the first sim step of the hot
    path's 16 lanes with the hot path's options (24 masked trips) and with
    ``simulate``'s (adaptive, 25 halvings), flags exactly, z to 1e-8;
    iteration counts exactly with the hot path's options; with
    ``simulate``'s (r_tol 1e-8) one lane sits at its residual's float64
    floor for some trips and stops at a trip that rounding decides (the
    port 26, JAX 35; z 2.4e-9 apart), so there 15 of the 16 counts are
    held. ``gait_knots``: one step of three lanes from the gait's knots
    (``gait_knot_step``) with the hot path's options, flags and counts
    exactly, z to 1e-9, rvio and kvio to 1e-12."""
    opts = (default_sim_options() if options == "simulate"
            else CFG.sim_ip_options())
    if options == "gait_knots":
        z0, theta = gait_knot_step()
    else:
        _, z0, theta = first_sim_step()
    solve = SimSolve(quadruped, pt.flat_2d_lc, opts)
    assert solve.route(z0) == "eager"
    got = solve(z0, theta)

    one = jax_solve(opts)
    want = [one(jnp.asarray(a), jnp.asarray(b))
            for a, b in zip(z0.numpy(), theta.numpy())]
    lanes = z0.shape[0]
    assert bool(got.converged.all())
    np.testing.assert_array_equal(
        got.converged.numpy(), [bool(w.converged) for w in want])
    same = got.iterations.numpy() == [int(w.iterations) for w in want]
    assert same.sum() >= (lanes - 1 if options == "simulate" else lanes), same
    np.testing.assert_allclose(got.z.numpy(), np.stack(
        [np.asarray(w.z) for w in want]), rtol=0,
        atol=1e-9 if options == "gait_knots" else 1e-8)
    if options == "gait_knots":
        for k in ("rvio", "kvio"):
            np.testing.assert_allclose(
                getattr(got, k).numpy(),
                [float(getattr(w, k)) for w in want], rtol=0, atol=1e-12)


def test_sim_ip_raises_on_cpu_tensors_and_bad_inputs():
    """``sim_ip`` never computes on the CPU, and refuses what the kernel
    does not take before any launch."""
    dims, z0, theta = first_sim_step()
    opts = CFG.sim_ip_options()
    before = sim_mod.sim_ip.launches
    cases = [
        ((quadruped, pt.flat_2d_lc, z0, theta, opts), "CUDA tensors"),
        ((hopper_2d, pt.flat_2d_lc, z0, theta, opts), "no kernel takes"),
        ((quadruped, pt.piecewise1_2d_lc, z0, theta, opts),
         "no kernel takes"),
        ((quadruped, pt.flat_2d_lc, z0, theta,
          IPOptions(diff_sol=True)), "diff_sol"),
        ((quadruped, pt.flat_2d_lc, z0, theta, IPOptions(max_ls=64)),
         "max_ls"),
        ((quadruped, pt.flat_2d_lc, z0.float(), theta, opts), "float32"),
        ((quadruped, pt.flat_2d_lc, z0[:, :40], theta, opts), "expected"),
        ((quadruped, pt.flat_2d_lc, z0.t().contiguous().t(), theta, opts),
         "contiguous"),
    ]
    for args, message in cases:
        with pytest.raises(ValueError, match=message):
            sim_mod.sim_ip(*args)
    for arithmetic, message in (("float32", "for float32 tensors"),
                                ("float16", "arithmetic")):
        with pytest.raises(ValueError, match=message):
            sim_mod.sim_ip(quadruped, pt.flat_2d_lc, z0, theta, opts,
                           arithmetic=arithmetic)
    assert sim_mod.sim_ip.launches == before
    assert sim_mod.takes(quadruped_payload, pt.flat_2d_lc)
    assert not sim_mod.takes(quadruped, pt.flat_3d_lc)


def test_work_counts_trips():
    """The bound grows with the trips the problems took and with the
    candidates a trip; the operations are the same for either tensor type
    and the bytes follow it; the rate is the tensors' type's (float32 for
    float32 tensors, though the kernel computes in float64); the dual-number
    Jacobian's count differs from the closed form's by its Jacobian alone,
    a trip."""
    f1, b1 = sim_mod.work(16, 160, 6, 0, 4)
    f2, _ = sim_mod.work(16, 320, 6, 0, 4)
    f3, _ = sim_mod.work(16, 160, 25, 0, 4)
    f4, b4 = sim_mod.work(16, 160, 6, 0, 8)
    assert f2 > f1 and f3 > f1 and f4 == f1 and b4 > b1 > 0
    ms4, by4 = sim_mod.bound_ms(16, 160, CFG.sim_ip_options(), 4)
    assert by4 == "operations"
    assert ms4 == 1e3 * f1 / sim_mod.PEAK_FLOPS[4] == 1e3 * f1 / 67e12
    ms8, by8 = sim_mod.bound_ms(16, 160, CFG.sim_ip_options(), 8)
    assert by8 == "operations" and ms8 == 1e3 * f4 / 34e12
    fd, bd = sim_mod.work(16, 160, 6, 0, 4, jacobian="dual")
    jac = sim_mod.JACOBIAN
    assert bd == b1 and jac["closed_form"] < jac["dual"] == 27 * 3 * 630
    assert fd - f1 == 160 * (jac["dual"] - jac["closed_form"])
    msd, _ = sim_mod.bound_ms(16, 160, CFG.sim_ip_options(), 4, "dual")
    assert msd == 1e3 * fd / 67e12 > ms4


def test_route_follows_the_kernel_table(monkeypatch):
    """On CUDA tensors ``SimSolve`` takes the kernel for exactly the
    (model class, terrain) pairs of ``KERNELS`` and the graphs for every
    other: the sim layer names no model. (A stand-in with ``is_cuda``
    plays the CUDA tensor: the route reads nothing else.)"""
    cuda = types.SimpleNamespace(is_cuda=True)
    opts = CFG.sim_ip_options()
    assert SimSolve(quadruped, pt.flat_2d_lc, opts).route(cuda) == "kernel"
    assert SimSolve(quadruped_payload, pt.flat_2d_lc,
                    opts).route(cuda) == "kernel"
    for model, env in ((hopper_2d, pt.flat_2d_lc),
                       (quadruped, pt.piecewise1_2d_lc)):
        assert SimSolve(model, env, opts).route(cuda) == "graphs"
    monkeypatch.setitem(sim_mod.KERNELS, (type(hopper_2d), pt.flat_2d_lc),
                        sim_mod.QUADRUPED)
    assert SimSolve(hopper_2d, pt.flat_2d_lc, opts).route(cuda) == "kernel"


def test_f32_stall_state_converges_in_float64():
    """The sim step of phase L's closed loop at which the kernel in float32
    arithmetic stalled (``tools/sim_ip_f32_stall.py --write`` on the card):
    the float64 solve of that float32 problem converges well inside its
    trips."""
    data = np.load(STALL)
    opts = IPOptions(**json.loads(str(data["options"])))
    z0 = torch.as_tensor(data["z0"]).double()
    theta = torch.as_tensor(data["theta"]).double()
    assert z0.shape == (1, 43) and theta.shape == (1, 34)
    assert data["z0"].dtype == np.float32
    out = SimSolve(quadruped, pt.flat_2d_lc, opts)(z0, theta)
    assert bool(out.converged.all())
    assert int(out.iterations[0]) <= opts.max_iter // 2
