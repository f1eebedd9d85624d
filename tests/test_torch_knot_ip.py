"""The port's batched knot interior-point solve against the JAX package.

The problems are the 60 ``gait2`` knots, linearized by the port (held to
JAX's own linearization in test_torch_model.py) and handed to both
packages as numpy arrays, with θ perturbed by 0.003·N(0, 1) from
``numpy.random.default_rng(0)`` as in tests/test_pallas_ip.py. On the CPU
the port's wrapper runs the plain version (ops/fixed_ip.py); the CUDA
kernel is checked against it on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contactimplicitmpc_tpu.dims import Dims as JDims
from contactimplicitmpc_tpu.ops.fixed_ip import \
    linearized_ip_fixed as jax_fixed
from contactimplicitmpc_tpu.ops.pallas_ip import linearized_ip_fixed_pallas
from contactimplicitmpc_tpu.sim.interior_point import IPOptions as JIPOptions

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch.control.linearized import \
    linearize_trajectory
from contactimplicitmpc_tpu_torch.control.trajectory import from_gait
from contactimplicitmpc_tpu_torch.models.base import dims_of
from contactimplicitmpc_tpu_torch.models.centroidal_quadruped import \
    centroidal_quadruped
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.ops.fixed_ip import (knot_blocks,
                                                       linearized_ip_fixed)
from contactimplicitmpc_tpu_torch.ops import knot_ip as knot_mod
from contactimplicitmpc_tpu_torch.ops.knot_ip import (knot_ip, pack_blocks,
                                                      pack_knots,
                                                      pack_knots_plain,
                                                      pack_layout,
                                                      warp_template, work)
from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

KAPPA = 2.0e-4
# the main path's knot options (HotPathConfig.mpc_ip_options), 8 iterations
MAIN = dict(r_tol=1.0e-5, kappa_tol=KAPPA, max_iter=30, undercut=5.0,
            gamma_reg=0.1, max_ls=3, refine=1)
# tests/test_pallas_ip.py's float32 options, 16 iterations
F32 = dict(r_tol=2e-5, kappa_tol=KAPPA, max_iter=16, undercut=5.0,
           gamma_reg=0.1, max_ls=3, refine=1)
FIELDS = ("z", "converged", "rvio", "kvio", "dz")


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


@pytest.fixture(scope="module")
def knots():
    """(dims, numpy inputs) for the 60 gait2 knots, float64."""
    dims = dims_of(quadruped, pt.flat_2d_lc)
    ref = from_gait(quadruped, pt.flat_2d_lc, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=torch.float64,
                    device="cpu")
    lin = linearize_trajectory(quadruped, pt.flat_2d_lc, ref, KAPPA)
    n = ref.horizon
    theta = ref.theta.numpy() + 0.003 * np.random.default_rng(0) \
        .standard_normal(ref.theta.shape)
    inputs = dict(z0_lin=lin.z0, theta0=lin.theta0, r0=lin.r0, rz0=lin.rz0,
                  rtheta0=lin.rtheta0)
    inputs = {k: v.numpy() for k, v in inputs.items()}
    inputs.update(alt=np.zeros((n, dims.nc)), theta=theta,
                  q2_init=ref.q[2:].numpy())
    return dims, inputs


@pytest.fixture(scope="module")
def centroidal_knots():
    """(dims, numpy inputs) for the first 10 knots of the centroidal
    quadruped's trot on flat_3d_lc (nx 18, ny 24, ntheta 53), float64,
    for 2 lanes with θ perturbed by 0.003·N(0, 1) from
    ``numpy.random.default_rng(0)``: problems (2, 10)."""
    dims = dims_of(centroidal_quadruped, pt.flat_3d_lc)
    ref = from_gait(centroidal_quadruped, pt.flat_3d_lc,
                    load_gait("centroidal_quadruped", "inplace_trot_v2"),
                    update_friction=True, dtype=torch.float64, device="cpu")
    lin = linearize_trajectory(centroidal_quadruped, pt.flat_3d_lc, ref,
                               KAPPA)
    k = 10
    theta = ref.theta[:k].numpy() + 0.003 * np.random.default_rng(0) \
        .standard_normal((2, k, dims.ntheta))
    inputs = dict(z0_lin=lin.z0, theta0=lin.theta0, r0=lin.r0, rz0=lin.rz0,
                  rtheta0=lin.rtheta0)
    inputs = {key: v[:k].numpy() for key, v in inputs.items()}
    inputs.update(alt=np.zeros((2, k, dims.nc)), theta=theta,
                  q2_init=np.broadcast_to(ref.q[2:k + 2].numpy(),
                                          (2, k, dims.nq)).copy())
    return dims, inputs


ORDER = ("z0_lin", "theta0", "r0", "rz0", "rtheta0", "alt", "theta", "q2_init")


def run_jax(dims, inputs, opts, iters, dtype):
    jd = JDims(**dataclasses.asdict(dims))
    jopts = JIPOptions(**opts)
    f = jax.jit(jax.vmap(lambda *a: jax_fixed(jd, *a, jopts, iters=iters)))
    out = f(*(jnp.asarray(inputs[k], dtype) for k in ORDER))
    return {k: np.asarray(getattr(out, k)) for k in FIELDS}


def run_port(dims, inputs, opts, iters, dtype):
    out = linearized_ip_fixed(
        dims, *(torch.as_tensor(inputs[k], dtype=dtype) for k in ORDER),
        IPOptions(**opts), iters)
    return {k: getattr(out, k).numpy() for k in FIELDS}


def test_plain_matches_jax_float64(knots):
    """float64: z, rvio, kvio and dz to 1e-9, identical converged flags."""
    dims, inputs = knots
    want = run_jax(dims, inputs, MAIN, 8, jnp.float64)
    got = run_port(dims, inputs, MAIN, 8, torch.float64)
    np.testing.assert_array_equal(got["converged"], want["converged"])
    assert want["converged"].mean() > 0.5, want["converged"].mean()
    for k in ("z", "rvio", "kvio", "dz"):
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9 * scale,
                                   err_msg=k)


# examples/centroidal_trot.py's knot options (float32 form: 1 refinement
# pass), 8 iterations: what the card's wide kernel runs on path D
CENTROIDAL = dict(r_tol=1e-4, kappa_tol=KAPPA, max_iter=30, undercut=5.0,
                  gamma_reg=0.1, max_ls=3, refine=1)


def test_plain_matches_jax_centroidal(centroidal_knots):
    """The plain version at the centroidal quadruped's dimensions, which
    the kernel takes with a block a problem (``struct WLay``): float64, 8
    iterations, 1 refinement pass, against JAX's ``linearized_ip_fixed``
    on 2 lanes × 10 knots; z, rvio, kvio and dz to 1e-8, identical
    converged flags."""
    dims, inputs = centroidal_knots
    assert (dims.nx, dims.ny, dims.ntheta) == (18, 24, 53)
    assert not warp_template(dims)
    jd = JDims(**dataclasses.asdict(dims))
    jopts = JIPOptions(**CENTROIDAL)
    per_knot = jax.vmap(lambda *a: jax_fixed(jd, *a, jopts, iters=8))
    out = jax.jit(jax.vmap(lambda a, th, q: per_knot(
        *(jnp.asarray(inputs[key]) for key in ORDER[:5]), a, th, q)))(
            *(jnp.asarray(inputs[key]) for key in ORDER[5:]))
    want = {key: np.asarray(getattr(out, key)) for key in FIELDS}
    got = run_port(dims, inputs, CENTROIDAL, 8, torch.float64)
    np.testing.assert_array_equal(got["converged"], want["converged"])
    assert want["converged"].mean() > 0.5, want["converged"].mean()
    for key in ("z", "rvio", "kvio", "dz"):
        scale = max(1.0, float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-8 * scale, err_msg=key)


def close_f32(dims, got_z, want_z, both):
    """test_pallas_ip.py's float32 tolerances on knots both converge: the
    q2 block (what the MPC consumes) within 1e-3 everywhere, all of z
    within 5e-3 on at least 95% of them. A knot whose residual sits at the
    float32 evaluation floor (~1e-5, next to r_tol 2e-5) can take one more
    masked iteration in one package than in the other; that step moves the
    weakly determined cone slacks by up to ~1e-2 while both results meet
    the tolerance (one gait2 knot here: 9.9e-3 on η)."""
    err = np.abs(got_z - want_z)[both]
    assert err[:, dims.iq2].max() < 1e-3, err[:, dims.iq2].max()
    assert (err.max(axis=1) < 5e-3).mean() >= 0.95, err.max(axis=1)


def test_plain_matches_jax_float32(knots):
    """float32 at test_pallas_ip.py's settings: z as ``close_f32``;
    converged flags agree on at least 95% of the knots; dz within 1e-2 of
    its scale."""
    dims, inputs = knots
    want = run_jax(dims, inputs, F32, 16, jnp.float32)
    got = run_port(dims, inputs, F32, 16, torch.float32)
    both = want["converged"] & got["converged"]
    assert both.mean() > 0.9, (want["converged"].mean(), got["converged"].mean())
    assert (want["converged"] == got["converged"]).mean() >= 0.95
    close_f32(dims, got["z"], want["z"], both)
    dz_err = np.abs(got["dz"] - want["dz"])[both].max()
    assert dz_err < 1e-2 * np.abs(want["dz"]).max(), dz_err


@pytest.mark.parametrize("k", [60, 3])
def test_plain_matches_pallas_interpret(knots, k):
    """Against the Pallas kernel run in interpret mode, as
    tests/test_pallas_ip.py runs it: all knots, and the N=3 padding case."""
    dims, inputs = knots
    sub = {key: v[:k] for key, v in inputs.items()}
    jd = JDims(**dataclasses.asdict(dims))
    out = linearized_ip_fixed_pallas(
        jd, *(jnp.asarray(sub[key], jnp.float32) for key in ORDER),
        JIPOptions(**F32), 16, True)
    got = run_port(dims, sub, F32, 16, torch.float32)
    conv = np.asarray(out.converged)
    assert conv.all() and got["converged"].all()
    close_f32(dims, got["z"], np.asarray(out.z), conv)
    for key in ("rvio", "kvio"):
        assert (got[key] <= F32["r_tol" if key == "rvio" else "kappa_tol"]).all()
        assert (np.asarray(getattr(out, key)) <= 2e-4).all()


def test_wrapper_dispatches_cpu_to_plain(knots):
    """On CPU tensors the wrapper is the plain version, counts no launch,
    and broadcasts the knot data over a leading batch of problems."""
    dims, inputs = knots
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in inputs.items()}
    opts = IPOptions(**MAIN)
    before = knot_ip.launches
    rep = lambda x: x[None].expand((2,) + x.shape).contiguous()
    out = knot_ip(dims, *(t[k] for k in ORDER[:5]), rep(t["alt"]),
                  rep(t["theta"]), rep(t["q2_init"]), opts, 8)
    ref = linearized_ip_fixed(dims, *(t[k] for k in ORDER), opts, 8)
    assert knot_ip.launches == before
    for k in FIELDS:
        for lane in range(2):
            np.testing.assert_allclose(getattr(out, k)[lane].numpy(),
                                       getattr(ref, k).numpy(), rtol=0,
                                       atol=1e-12, err_msg=k)


def test_nonfinite_guards_match_jax(knots):
    """Problem 0 has an infinite θ entry: every trial iterate is non-finite,
    so the last finite iterate (the initial one) is kept and the knot is
    not converged. Problem 1 has a NaN sensitivity column: dz is zeroed and
    the knot flagged. Both packages agree."""
    dims, inputs = knots
    bad = {k: v[:3].copy() for k, v in inputs.items()}
    bad["theta"][0, 5] = np.inf
    bad["rtheta0"][1, :, 20] = np.nan
    bad["theta"][1, 20] = bad["theta0"][1, 20]
    want = run_jax(dims, bad, MAIN, 8, jnp.float64)
    got = run_port(dims, bad, MAIN, 8, torch.float64)
    assert not got["converged"][0] and not got["converged"][1]
    np.testing.assert_array_equal(got["converged"], want["converged"])
    z_init = np.concatenate([bad["q2_init"][0], np.ones(dims.nz - dims.nq)])
    np.testing.assert_array_equal(got["z"][0], z_init)
    assert np.all(got["dz"][1] == 0.0)
    for k in ("z", "dz"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(np.isfinite(got["rvio"]),
                                  np.isfinite(want["rvio"]))



def test_work_count_matches_hand_count(knots):
    """The operations and bytes of one call, for the quadruped's dims at
    the main path's shape (1008 problems over 9 knots, 8 iterations, 1
    refinement pass, 3 halvings), against a count written out by hand:
    nx 11, ny 16, nz 43, ntheta 34, 27 equality rows."""
    dims, _ = knots
    n, k = 1008, 9
    flops, nbytes = work(dims, n, k, iters=8, refine=1, max_ls=3)
    schur = 2 * (16 * 11 + 16 * 16 + 11 * 16 + 11 * 11) + 6 * 16   # 1554
    jac = 2 * 27 * 43 + 3 * 16 + 43                                # 2413
    solve = schur + jac + schur + 43                               # 5564
    residual = 2 * 27 * 43 + 43 + 27 + 2 * 16                      # 2424
    # the line search: two 27 × 43 products for both directions' Rza d, 8
    # candidates of 27 affine rows and 16 bilinear ones, the merit at α = 0
    search = 2 * 2 * 27 * 43 + 8 * (4 * 27 + 8 * 16) + 2 * 43      # 6618
    factor = 2 * 16 * 16 * 16 + 3 * 16 + 16 * 16                   # 8496
    iteration = residual + factor + 3 * solve + search + 368       # 34598
    final = residual + factor + 34 * solve                         # 200096
    base = 2 * 27 * 34 + 34 + 2 * 27                               # 1924
    knot = 2 * 11 * 11 * 11 + 2 * 16 * 11 * 11 + 2 * 16 * 16 * 11  # 12166
    assert (schur, jac, solve, residual) == (1554, 2413, 5564, 2424)
    assert (search, iteration, final) == (6618, 34598, 200096)
    assert flops == n * (base + 8 * iteration + final) + k * knot
    assert abs(flops / n - 479e3) < 1e3, flops / n
    per_problem = 4 * (34 + 11 + 4) + 4 * (43 + 43 * 34 + 2) + 1   # 6225
    per_knot = 4 * (43 + 34 + 43 + 43 * 43 + 43 * 34)              # 13724
    assert nbytes == n * per_problem + k * per_knot
    # The reckoning the kernel's redesign started from, ~658 kflop and
    # ~6.2 KB a problem, charged more than the function needs: a product
    # of its own for each of the 8 candidates (residual + 4 × 43 each, in
    # place of `search`) and a 16 × 32 tableau for each of the 9 inverses.
    # With both put back the count is within 5% of it.
    direct = flops / n + 8 * (8 * (residual + 4 * 43) - search) \
        + 9 * 2 * 16 * 16 * 16
    assert abs(direct - 658e3) < 0.05 * 658e3, direct
    assert abs(nbytes / n - 6.2e3) < 0.05 * 6.2e3, nbytes / n
    # operations bound it: 67 TFLOP/s against 3.35 TB/s
    assert flops / 67e12 > nbytes / 3.35e12


@pytest.mark.parametrize("iters,refine,max_ls", [(0, 0, 0), (8, 0, 3),
                                                 (10, 2, 6)])
def test_work_count_scales(knots, iters, refine, max_ls):
    """Linear in the problems at a fixed knot count; more iterations,
    refinement passes or halvings never cost less."""
    dims, _ = knots
    f1, b1 = work(dims, 9, 9, iters, refine, max_ls)
    f2, b2 = work(dims, 18, 9, iters, refine, max_ls)
    f0, b0 = work(dims, 0, 9, iters, refine, max_ls)
    assert f2 - f1 == f1 - f0 > 0 and b2 - b1 == b1 - b0 > 0
    assert work(dims, 9, 9, iters + 1, refine, max_ls)[0] > f1
    assert work(dims, 9, 9, iters + 1, refine + 1, max_ls)[0] > f1
    assert work(dims, 9, 9, iters + 1, refine, max_ls + 1)[0] > f1
    assert work(dims, 9, 9, iters + 1, refine, max_ls)[1] == b1


def test_plain_packing_of_wide_knots(centroidal_knots):
    """The layout of the block-a-problem template (``struct WLay``): no
    slot padding, rows at an odd stride (no two threads reading a row each
    share a bank), every block at its place, zeros elsewhere, the size a
    multiple of 16 bytes; the kernel's own count of it is checked against
    ``pack_layout`` where the kernel is built."""
    dims, inputs = centroidal_knots
    t = [torch.as_tensor(inputs[k], dtype=torch.float32) for k in ORDER[:5]]
    z0, theta0, r0, rz0, rtheta0 = t
    lay = pack_layout(dims)
    assert lay.slots == tuple(range(dims.nz)) and lay.size % 4 == 0
    assert "dxdy" not in lay.blocks
    assert all(stride % 2 == 1 for name, (_, rows, stride, _) in
               lay.blocks.items() if rows > 1)
    pack = pack_knots_plain(dims, *t)
    assert torch.equal(pack_knots(dims, *t), pack)
    ne = dims.nx + dims.ny
    b = knot_blocks(dims, rz0)
    diag = lambda m: torch.diagonal(m, dim1=-2, dim2=-1)
    want = {"rza": rz0[:, :ne], "dxi": b.dxi, "dy1": b.dy1, "cai": b.cai,
            "sb": b.ry1 - b.caib, "ry1d": diag(b.ry1), "caibd": diag(b.caib),
            "ry2": b.ry2, "z0": z0, "r0": r0[:, :ne], "theta0": theta0,
            "rtheta0": rtheta0.reshape(10, -1)}
    got = pack_blocks(dims, pack)
    assert list(got) == list(want)
    used = torch.zeros(lay.size, dtype=torch.bool)
    for name, (off, rows, stride, cols) in lay.blocks.items():
        assert torch.equal(got[name], want[name].reshape(got[name].shape)), name
        for row in range(rows):
            used[off + row * stride:off + row * stride + cols] = True
    assert bool((pack[:, ~used] == 0).all())


def test_plain_packing_holds_fixed_ip_blocks(knots):
    """The packed per-knot constants, plain version, against the blocks
    ``ops/fixed_ip.py`` forms: each block at its place of the layout,
    zeros in all padding, every piece 16-byte aligned; on CPU tensors
    ``pack_knots`` is the plain version."""
    dims, inputs = knots
    t = [torch.as_tensor(inputs[k][:9], dtype=torch.float32)
         for k in ORDER[:5]]
    z0, theta0, r0, rz0, rtheta0 = t
    lay = pack_layout(dims)
    pack = pack_knots_plain(dims, *t)
    assert pack.shape == (9, lay.size) and pack.dtype == torch.float32
    assert torch.equal(pack_knots(dims, *t), pack)
    assert all(off % 4 == 0 and stride % 4 == 0
               for off, _, stride, _ in lay.blocks.values())
    nx, ne = dims.nx, dims.nx + dims.ny
    b = knot_blocks(dims, rz0)
    slots = list(lay.slots)
    diag = lambda m: torch.diagonal(m, dim1=-2, dim2=-1)
    want = {"rza": None, "dxi": b.dxi, "dy1": b.dy1, "dxdy": b.dxi @ b.dy1,
            "cai": b.cai, "sb": b.ry1 - b.caib, "ry1d": diag(b.ry1),
            "caibd": diag(b.caib), "ry2": b.ry2, "z0": None,
            "r0": r0[:, :ne], "theta0": theta0,
            "rtheta0": rtheta0.reshape(9, -1)}
    got = pack_blocks(dims, pack)
    assert list(got) == list(want) == list(lay.blocks)
    used = torch.zeros(lay.size, dtype=torch.bool)
    for name, (off, rows, stride, cols) in lay.blocks.items():
        if want[name] is None:
            continue
        assert torch.equal(got[name], want[name].reshape(got[name].shape)), name
        for row in range(rows):
            used[off + row * stride:off + row * stride + cols] = True
    # the padded vectors: x in the first slots, y1 and y2 aligned after it
    assert slots[:nx] == list(range(nx)) and slots[nx] % 4 == 0
    assert torch.equal(got["rza"][:, :, slots], rz0[:, :ne, :])
    assert torch.equal(got["z0"][:, 0, slots], z0)
    for name in ("rza", "z0"):
        off, rows, stride, _ = lay.blocks[name]
        for row in range(rows):
            used[off + row * stride + torch.as_tensor(slots)] = True
    assert not pack[:, ~used].any()
    assert int((~used).sum()) > 0


# ---- every model's instantiation --------------------------------------------

def _flat(model):
    """The model's flat terrain: 3D where its contact points are."""
    return (pt.flat_3d_lc if model.kinematics(torch.zeros(model.nq)).shape[-1]
            == 3 else pt.flat_2d_lc)


def _cu_table(name):
    """The (nx, ny, ntheta, nc) lines of a table of csrc/knot_ip.cu."""
    with open(knot_mod.SOURCE) as f:
        src = f.read()
    body = re.split(r"\n\s*\n|#define", src.split(f"#define {name}(X)", 1)[1],
                    maxsplit=1)[0]
    return [tuple(int(v) for v in m.groups()) for m in
            re.finditer(r"X\((\d+), (\d+), (\d+), (\d+)\)", body)]


def test_instantiation_tables_mirror_the_source():
    """The two tables of csrc/knot_ip.cu list what ``KNOT_IP_MODELS`` and
    ``KNOT_IP_WIDE_MODELS`` mirror, in order; every model of the registry,
    on its flat terrain, has its dimensions in the table of the template
    ``warp_template`` picks, under its name, and the ten are distinct."""
    assert _cu_table("KNOT_IP_MODELS") == list(knot_mod.KNOT_IP_MODELS)
    assert _cu_table("KNOT_IP_WIDE_MODELS") == \
        list(knot_mod.KNOT_IP_WIDE_MODELS)
    tables = {**knot_mod.KNOT_IP_MODELS, **knot_mod.KNOT_IP_WIDE_MODELS}
    assert len(tables) == 10
    listed = [m for models in tables.values() for m in models]
    assert sorted(listed) == sorted(pt.models.MODELS)
    for name, model in pt.models.MODELS.items():
        dims = dims_of(model, _flat(model))
        table = (knot_mod.KNOT_IP_MODELS if warp_template(dims)
                 else knot_mod.KNOT_IP_WIDE_MODELS)
        key = (dims.nx, dims.ny, dims.ntheta, dims.nc)
        assert name in table.get(key, ()), (name, key)
    # the nonlinear cone's dimensions (ny = 3) are in neither table
    nc = dims_of(pt.models.particle_2d, pt.flat_2d_nc)
    assert (nc.nx, nc.ny, nc.ntheta, nc.nc) not in tables


def _chip_smoke():
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def new_knots(name):
    """(dims, numpy inputs, options) for 2 lanes over the first 5 knots of
    what chip_smoke.py gives the kernel for ``name`` (its path's gait, or
    the committed knot states of a model no path runs), float64, θ
    perturbed by 0.003·N(0, 1) from ``numpy.random.default_rng(0)``."""
    model, env, ref, kappa, opts, _ = _chip_smoke().phase_case(
        name, device="cpu", dtype=torch.float64)
    opts = {k: v for k, v in dataclasses.asdict(opts).items()
            if k in {f.name for f in dataclasses.fields(JIPOptions)}}
    dims = dims_of(model, env)
    lin = linearize_trajectory(model, env, ref, kappa)
    k = 5
    theta = ref.theta[:k].numpy() + 0.003 * np.random.default_rng(0) \
        .standard_normal((2, k, dims.ntheta))
    inputs = dict(z0_lin=lin.z0, theta0=lin.theta0, r0=lin.r0, rz0=lin.rz0,
                  rtheta0=lin.rtheta0)
    inputs = {key: v[:k].numpy() for key, v in inputs.items()}
    inputs.update(alt=np.zeros((2, k, dims.nc)), theta=theta,
                  q2_init=np.broadcast_to(ref.q[2:k + 2].numpy(),
                                          (2, k, dims.nq)).copy())
    return dims, inputs, opts


NEW_DIMS = {"flamingo": (9, 16, 28, 4), "particle_2D": (2, 4, 10, 1),
            "pushbot": (2, 8, 10, 2), "walledcartpole": (4, 8, 15, 2),
            "particle": (3, 6, 14, 1), "hopper_3D": (7, 6, 22, 1),
            "centroidal_quadruped_wall": (18, 48, 53, 8)}


@pytest.mark.parametrize("name", list(NEW_DIMS))
def test_plain_matches_jax_new_dims(name):
    """The plain version at each set of dimensions this slice instantiates,
    float64, 8 iterations, the options chip_smoke.py gives that
    instantiation, against JAX's ``linearized_ip_fixed`` on 2 lanes × 5
    knots: z, rvio, kvio and dz to 1e-8, identical converged flags."""
    dims, inputs, opts = new_knots(name)
    assert (dims.nx, dims.ny, dims.ntheta, dims.nc) == NEW_DIMS[name]
    jd = JDims(**dataclasses.asdict(dims))
    jopts = JIPOptions(**opts)
    per_knot = jax.vmap(lambda *a: jax_fixed(jd, *a, jopts, iters=8))
    out = jax.jit(jax.vmap(lambda a, th, q: per_knot(
        *(jnp.asarray(inputs[key]) for key in ORDER[:5]), a, th, q)))(
            *(jnp.asarray(inputs[key]) for key in ORDER[5:]))
    want = {key: np.asarray(getattr(out, key)) for key in FIELDS}
    got = run_port(dims, inputs, opts, 8, torch.float64)
    np.testing.assert_array_equal(got["converged"], want["converged"])
    for key in ("z", "rvio", "kvio", "dz"):
        scale = max(1.0, float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-8 * scale, err_msg=key)


@pytest.mark.parametrize("name", ["particle", "hopper_3D",
                                  "centroidal_quadruped_wall"])
def test_plain_packing_of_new_wide_knots(name):
    """The block-a-problem layout (``struct WLay``) at the three sets of
    dimensions this slice adds to it: no slot padding, rows at an odd
    stride, every block at its place, zeros elsewhere, the size a multiple
    of 16 bytes."""
    dims, inputs, _ = new_knots(name)
    assert not warp_template(dims)
    t = [torch.as_tensor(inputs[k], dtype=torch.float32) for k in ORDER[:5]]
    z0, theta0, r0, rz0, rtheta0 = t
    lay = pack_layout(dims)
    assert lay.slots == tuple(range(dims.nz)) and lay.size % 4 == 0
    assert all(stride % 2 == 1 for _, rows, stride, _ in lay.blocks.values()
               if rows > 1)
    pack = pack_knots_plain(dims, *t)
    assert torch.equal(pack_knots(dims, *t), pack)
    ne = dims.nx + dims.ny
    b = knot_blocks(dims, rz0)
    diag = lambda m: torch.diagonal(m, dim1=-2, dim2=-1)
    want = {"rza": rz0[:, :ne], "dxi": b.dxi, "dy1": b.dy1, "cai": b.cai,
            "sb": b.ry1 - b.caib, "ry1d": diag(b.ry1), "caibd": diag(b.caib),
            "ry2": b.ry2, "z0": z0, "r0": r0[:, :ne], "theta0": theta0,
            "rtheta0": rtheta0.reshape(len(z0), -1)}
    got = pack_blocks(dims, pack)
    assert list(got) == list(want)
    used = torch.zeros(lay.size, dtype=torch.bool)
    for key, (off, rows, stride, cols) in lay.blocks.items():
        assert torch.equal(got[key], want[key].reshape(got[key].shape)), key
        for row in range(rows):
            used[off + row * stride:off + row * stride + cols] = True
    assert bool((pack[:, ~used] == 0).all())


@pytest.mark.parametrize("name", ["quadruped", "flamingo"])
def test_affine_merit_form_matches_jax_float64(name, knots):
    """The plain version with the line search's equality rows in the
    kernel's form (``affine_merit``: r − α Rza d) is the same function: in
    float64, 8 iterations, z, rvio, kvio and dz to 1e-8 of JAX's, flags
    equal (the quadruped's gait2 knots at the main path's options; the
    flamingo's 2 lanes × 5 knots at its path's)."""
    if name == "quadruped":
        dims, inputs = knots
        opts = MAIN
        want = run_jax(dims, inputs, opts, 8, jnp.float64)
    else:
        dims, inputs, opts = new_knots(name)
        jd = JDims(**dataclasses.asdict(dims))
        per_knot = jax.vmap(lambda *a: jax_fixed(jd, *a, JIPOptions(**opts),
                                                 iters=8))
        out = jax.jit(jax.vmap(lambda a, th, q: per_knot(
            *(jnp.asarray(inputs[key]) for key in ORDER[:5]), a, th, q)))(
                *(jnp.asarray(inputs[key]) for key in ORDER[5:]))
        want = {key: np.asarray(getattr(out, key)) for key in FIELDS}
    out = linearized_ip_fixed(
        dims, *(torch.as_tensor(inputs[k], dtype=torch.float64)
                for k in ORDER), IPOptions(**opts), 8, affine_merit=True)
    got = {k: getattr(out, k).numpy() for k in FIELDS}
    np.testing.assert_array_equal(got["converged"], want["converged"])
    for key in ("z", "rvio", "kvio", "dz"):
        scale = max(1.0, float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-8 * scale, err_msg=key)
