"""The quadruped's sim kernel (``csrc/sim_ip.cu``, ``ops/sim_ip.py``) on the
CPU, where the kernel cannot run: its packed model and formulas, the route
``SimSolve`` takes, and the wrapper's refusals.

- ``packed_residual`` is the kernel's residual written in PyTorch from the
  packed table alone (``csrc/sim_ip.cu``'s ``theta_terms``,
  ``equality_rows`` and bilinear rows: the midpoint terms as sums over the
  nine bodies of J_bᵀ m_b(...), J(q2)ᵀλ, the feet's heights and velocities
  over the lever arms). It is held to the port's ``residual`` and the JAX
  package's at 1e-12 in float64 for ``quadruped`` and ``quadruped_payload``
  on seeded points, and its forward-mode Jacobian (what the kernel's dual
  lanes compute) to ``jacfwd`` of the port's and to ``jax.jacfwd`` of the
  JAX package's.
- On CPU tensors ``SimSolve`` routes the quadruped to ``ip_solve``, and on
  the first sim step of the 16 lanes of ``assets/hotpath_conf16.npz``
  (the gait's first control, 0.3·N(0, 1) added from
  numpy.random.default_rng(3)) it matches the JAX package's ``ip_solve``
  in float64 with the hot path's sim options (24 masked trips) and with
  ``simulate``'s (adaptive, 25 halvings): flags and iteration counts
  exactly (but one lane's with ``simulate``'s r_tol of 1e-8, at the float64
  floor), z to 1e-8, phase S's float64 bound (two summation orders of the
  same float64 arithmetic; ``tests/test_torch_ip_solve.py`` holds the
  other models). The JAX solve
  is jitted for one lane with its residual jitted inside, and called a
  lane at a time: tracing it under ``vmap`` takes twice as long.
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


def test_pack_layout_matches_the_source():
    """``PACK_LAYOUT``'s offsets are the source's P_* constants, and its
    length the source's kPackSize (``_load`` holds the built kernel's to it
    too)."""
    with open(sim_mod.QUADRUPED.source) as f:
        src = f.read()
    env = dict(NPOINT=13, NA=9, NBODY=9, NQ=11, NU=8, NW=2)
    pattern = r"\b(P_[A-Z]+|kPackSize) = ([^,;:]+)[,;]"
    for name, expr in re.findall(pattern, src):
        env[name] = eval(expr, {}, env)
    offsets, off = {}, 0
    for name, shape in sim_mod.PACK_LAYOUT:
        offsets[name] = off
        off += int(np.prod(shape))
    assert [env[k] for k in ("P_ARMS", "P_MASS", "P_INERTIA", "P_JF", "P_B",
                             "P_A", "P_G")] == list(offsets.values())
    assert env["kPackSize"] == sim_mod.PACK_SIZE == off
    assert sim_mod.pack_quadruped(quadruped).shape == (off,)


def test_pack_reads_every_constant_from_the_model():
    """Each block of the packed table is the model's own: a model whose
    disturbance Jacobian or control Jacobian differs packs them."""
    pack = unpack(torch.as_tensor(sim_mod.pack_quadruped(quadruped)))
    q = torch.zeros(quadruped.nq, dtype=torch.float64)
    np.testing.assert_array_equal(pack["disturbance_jacobian"].numpy(),
                                  quadruped.disturbance_jacobian(q).numpy())
    np.testing.assert_array_equal(pack["control_jacobian"].numpy(),
                                  quadruped._b)
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


@pytest.mark.parametrize("options", ["hot_path", "simulate"])
def test_first_sim_step_matches_jax(options):
    """``SimSolve`` routes CPU tensors to ``ip_solve``, and matches the JAX
    package's ``ip_solve`` on the first sim step of the hot path's 16
    lanes, float64: flags exactly, z to 1e-8. Iteration counts exactly
    with the hot path's options; with ``simulate``'s (r_tol 1e-8) one lane
    sits at its residual's float64 floor for some trips and stops at a
    trip that rounding decides (the port 26, JAX 35; z 2.4e-9 apart), so
    there 15 of the 16 counts are held."""
    opts = (CFG.sim_ip_options() if options == "hot_path"
            else default_sim_options())
    _, z0, theta = first_sim_step()
    solve = SimSolve(quadruped, pt.flat_2d_lc, opts)
    assert solve.route(z0) == "eager"
    got = solve(z0, theta)

    jd = ci.dims_of(jquadruped, ci.flat_2d_lc)
    r_j = JAX_RESIDUAL["quadruped"]
    jopts = ci.IPOptions(**dataclasses.asdict(opts))
    one = jax.jit(lambda z, th: ci.ip_solve(jd, r_j, z, th, jopts))
    want = [one(jnp.asarray(a), jnp.asarray(b))
            for a, b in zip(z0.numpy(), theta.numpy())]
    assert bool(got.converged.all())
    np.testing.assert_array_equal(
        got.converged.numpy(), [bool(w.converged) for w in want])
    same = got.iterations.numpy() == [int(w.iterations) for w in want]
    assert same.sum() >= (16 if options == "hot_path" else 15), same
    np.testing.assert_allclose(got.z.numpy(), np.stack(
        [np.asarray(w.z) for w in want]), rtol=0, atol=1e-8)


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
    float32 tensors, though the kernel computes in float64)."""
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
