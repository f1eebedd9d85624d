"""``implicit_dynamics`` of the port against the JAX package's on the 2D
hopper, float64 on the CPU: both modes (configuration, configurationforce),
the fixed-iteration knot solve (``ops/knot_ip.py``'s plain version here,
the CUDA kernel on the card) and the adaptive one (``ip_solve`` over
``linearized_residual_fns`` with ``make_schur_solver``), for lanes ×
line-search trials × knots in one batch; the plain knot solve at the
hopper's dimensions against ``linearized_ip_fixed`` of JAX; and the packed
layout of the kernel's second instantiation.

Inputs: the in-place gait's knots with θ perturbed by 0.003·N(0, 1) from a
numpy seed. Tolerances: z and d to 1e-9, sensitivities to 1e-7, flags
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.control import from_gait as jfrom_gait
from contactimplicitmpc_tpu.control import implicit_dynamics as jimplicit
from contactimplicitmpc_tpu.control.implicit_dynamics import \
    default_mpc_ip_options as jdefault_opts
from contactimplicitmpc_tpu.control.linearized import \
    linearize_trajectory as jlinearize
from contactimplicitmpc_tpu.models import hopper_2d as jhopper
from contactimplicitmpc_tpu.ops.fixed_ip import \
    linearized_ip_fixed as jfixed
from contactimplicitmpc_tpu.utils.gaits import load_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control.implicit_dynamics import (
    CONFIGURATION, CONFIGURATION_FORCE, implicit_dynamics)
from contactimplicitmpc_tpu_torch.control.trajectory import ContactTraj
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d
from contactimplicitmpc_tpu_torch.ops import knot_ip as knot_mod
from contactimplicitmpc_tpu_torch.ops.fixed_ip import linearized_ip_fixed

KAPPA = 1.0e-4
H_MPC = 10
LEAD = (2, 3)     # lanes × trials


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
def setup():
    jd = ci.dims_of(jhopper, ci.flat_2d_lc)
    ref = jfrom_gait(jhopper, ci.flat_2d_lc,
                     load_gait("hopper_2D", "gait_in_place"), kappa=KAPPA)
    lin = jlinearize(jhopper, ci.flat_2d_lc, ref, KAPPA)
    lin = type(lin)(*(x[:H_MPC] for x in lin))
    rng = np.random.default_rng(0)
    # working trajectories: the reference window, perturbed per problem
    q = np.asarray(ref.q[:H_MPC + 2]) + 0.003 * rng.standard_normal(
        LEAD + (H_MPC + 2, jd.nq))
    u = np.asarray(ref.u[:H_MPC]) + 0.003 * rng.standard_normal(
        LEAD + (H_MPC, jd.nu))
    theta = np.broadcast_to(np.asarray(ref.theta[:H_MPC]),
                            LEAD + (H_MPC, jd.ntheta)).copy()
    theta[..., jd.iq0] = q[..., :H_MPC, :]
    theta[..., jd.iq1] = q[..., 1:H_MPC + 1, :]
    theta[..., jd.iu1] = u
    bc = lambda x: np.broadcast_to(np.asarray(x[:H_MPC]),
                                   LEAD + x[:H_MPC].shape).copy()
    trajs = dict(h=np.array(ref.h), kappa=np.array(ref.kappa), q=q, u=u,
                 w=bc(ref.w), gamma=bc(ref.gamma) + 0.01, b=bc(ref.b),
                 z=bc(ref.z), theta=theta)
    alt = 0.002 * rng.standard_normal(LEAD + (jd.nc,))
    return jd, ref, lin, trajs, alt


def jax_implicit(setup, mode, opts, fixed_iters):
    jd, ref, lin, trajs, alt = setup

    def one(q, u, w, gamma, b, z, theta, alt_):
        traj = type(ref)(h=ref.h, kappa=ref.kappa, q=q, u=u, w=w, gamma=gamma,
                         b=b, z=z, theta=theta)
        return jimplicit(jd, mode, lin, traj, alt_, opts,
                         fixed_iters=fixed_iters)

    fn = jax.jit(jax.vmap(jax.vmap(one)))
    return fn(*(jnp.asarray(trajs[k]) for k in
                ("q", "u", "w", "gamma", "b", "z", "theta")), jnp.asarray(alt))


def torch_implicit(setup, mode, opts, fixed_iters):
    jd, ref, lin, trajs, alt = setup
    dims = pt.Dims(nq=jd.nq, nu=jd.nu, nw=jd.nw, nc=jd.nc, nf=jd.nf, ne=jd.ne)
    traj = ContactTraj(**{k: torch.as_tensor(v) for k, v in trajs.items()})
    return implicit_dynamics(dims, mode, interop.linearized_data(
        lin, device="cpu"), traj, torch.as_tensor(alt),
        interop.ip_options(opts), fixed_iters=fixed_iters)


@pytest.mark.parametrize("mode", [CONFIGURATION, CONFIGURATION_FORCE])
@pytest.mark.parametrize("fixed_iters", [8, 0])
def test_implicit_dynamics_matches(setup, mode, fixed_iters):
    opts = jdefault_opts(KAPPA, max_iter=30)
    want = jax_implicit(setup, mode, opts, fixed_iters)
    got = torch_implicit(setup, mode, opts, fixed_iters)
    assert got.d.shape == LEAD + (H_MPC, want.d.shape[-1])
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    if not fixed_iters:
        assert bool(want.converged.all())
    for name, tol in (("d", 1e-9), ("z", 1e-9), ("dq0", 1e-7), ("dq1", 1e-7),
                      ("du1", 1e-7)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("iters,refine", [(3, 0), (8, 1)])
def test_plain_knot_solve_at_hopper_dims_matches(setup, iters, refine):
    """``ops/fixed_ip.py`` (the kernel's plain version) at nx 4, ny 4,
    nθ 14 against the JAX package's ``linearized_ip_fixed``."""
    import dataclasses
    jd, ref, lin, trajs, alt = setup
    opts = dataclasses.replace(jdefault_opts(KAPPA), refine=refine)
    q2 = trajs["q"][..., 2:, :]

    def one(z0, th0, r0, rz0, rt0, alt_, theta, q2_):
        return jfixed(jd, z0, th0, r0, rz0, rt0, alt_, theta, q2_, opts,
                      iters=iters)

    over_knots = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, None, 0, 0))
    fn = jax.jit(jax.vmap(jax.vmap(
        lambda a, th, q: over_knots(*lin, a, th, q))))
    want = fn(jnp.asarray(alt), jnp.asarray(trajs["theta"]), jnp.asarray(q2))

    dims = pt.Dims(nq=jd.nq, nu=jd.nu, nw=jd.nw, nc=jd.nc, nf=jd.nf, ne=jd.ne)
    alt_p = torch.as_tensor(alt)[..., None, :].expand(LEAD + (H_MPC, jd.nc))
    got = linearized_ip_fixed(
        dims, *interop.linearized_data(lin, device="cpu"), alt_p,
        torch.as_tensor(trajs["theta"]), torch.as_tensor(q2),
        interop.ip_options(opts), iters=iters)
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    np.testing.assert_allclose(got.z.numpy(), want.z, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.dz.numpy(), want.dz, rtol=0, atol=1e-7)


def test_pack_layout_of_the_hopper_instantiation():
    """``pack_layout`` for (nx, ny, nθ, nc) = (4, 4, 14, 1) against the
    sizes that ``struct Lay<4, 4, 14, 1>`` of csrc/knot_ip.cu computes, and
    the plain packing's padding."""
    dims = pt.dims_of(hopper_2d, pt.flat_2d_lc)
    assert (dims.nx, dims.ny, dims.ntheta, dims.nc) == (4, 4, 14, 1)
    lay = knot_mod.pack_layout(dims)
    pad4 = lambda n: (n + 3) // 4 * 4
    nx, ny, nt = 4, 4, 14
    ne, nz, nv = nx + ny, nx + 2 * ny, pad4(nx) + 2 * ny
    xs, ys = pad4(nx), ny + 4
    k_rt0 = (ne * nv + nx * xs + 2 * nx * ys + ny * xs + ny * ny + 3 * ny
             + nv + pad4(ne) + pad4(nt))
    assert lay.blocks["rtheta0"][0] == k_rt0 == 256
    assert lay.size == k_rt0 + pad4(nz * nt) == 424
    assert all(off % 4 == 0 for off, *_ in lay.blocks.values())
    assert lay.slots == tuple(range(nz))     # nx is a multiple of 4: no pad

    rng = np.random.default_rng(1)
    knots = [torch.as_tensor(rng.standard_normal(s)) for s in (
        (3, nz), (3, nt), (3, nz), (3, nz, nz), (3, nz, nt))]
    knots[3] = knots[3] + 4 * torch.eye(nz, dtype=torch.float64)
    pack = knot_mod.pack_knots(dims, *knots)
    assert pack.shape == (3, 424)
    blocks = knot_mod.pack_blocks(dims, pack)
    assert torch.equal(blocks["rza"], knots[3][:, :ne, :])
    assert torch.equal(blocks["theta0"][:, 0], knots[1])
    covered = torch.zeros(424, dtype=torch.bool)
    for off, rows, stride, cols in lay.blocks.values():
        for r in range(rows):
            covered[off + r * stride: off + r * stride + cols] = True
    assert bool((pack[:, ~covered] == 0).all())
