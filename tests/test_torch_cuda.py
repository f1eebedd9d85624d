"""The hand-written CUDA knot kernel (``csrc/knot_ip.cu``) and its per-knot
prologue against their plain PyTorch versions on the card, and the checks
the wrapper makes before any launch.

The tests that need the card are marked ``cuda`` and skip where CUDA is
absent. This file imports neither JAX nor the JAX package, so it also runs
on a machine that has only PyTorch; there, leave out tests/conftest.py
(it configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from contactimplicitmpc_tpu_torch.control import graphs as newton_graphs
from contactimplicitmpc_tpu_torch.control.linearized import \
    linearize_trajectory
from contactimplicitmpc_tpu_torch.control.trajectory import from_gait
from contactimplicitmpc_tpu_torch.env import flat_2d_lc, flat_3d_lc
from contactimplicitmpc_tpu_torch.hotpath import (HotPathConfig,
                                                  conf_initial_states,
                                                  make_quadruped_rollout)
from contactimplicitmpc_tpu_torch.models.base import dims_of
from contactimplicitmpc_tpu_torch.control.implicit_dynamics import \
    default_mpc_ip_options
from contactimplicitmpc_tpu_torch.dims import Dims
from contactimplicitmpc_tpu_torch.models.centroidal_quadruped import \
    centroidal_quadruped
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.ops import knot_ip as knot_mod
from contactimplicitmpc_tpu_torch.ops.fixed_ip import linearized_ip_fixed
from contactimplicitmpc_tpu_torch.ops.knot_ip import knot_ip, warp_template
from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

CFG = HotPathConfig()
OPTS = CFG.mpc_ip_options()
DIMS = dims_of(quadruped, flat_2d_lc)
STAGES, TRIALS = CFG.h_mpc - 1, CFG.newton_max_ls + 1


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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def knot_problems(device, lanes, trials=TRIALS, stages=STAGES):
    """The main path's layout, (lanes, trials, stages) problems over the
    first ``stages`` gait2 knots, float32, with θ perturbed by
    0.003·N(0, 1) from numpy.random.default_rng(0) (the recipe of
    tests/test_pallas_ip.py)."""
    ref = from_gait(quadruped, flat_2d_lc, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=torch.float32, device=device)
    lin = linearize_trajectory(quadruped, flat_2d_lc, ref, CFG.kappa_mpc)
    shape = (lanes, trials, stages)
    noise = np.random.default_rng(0).standard_normal(shape + (DIMS.ntheta,))
    theta = ref.theta[:stages] + 0.003 * torch.as_tensor(
        noise, dtype=torch.float32, device=device)
    q2 = ref.q[2:stages + 2].expand(shape + (DIMS.nq,)).contiguous()
    alt = torch.zeros(shape + (DIMS.nc,), dtype=torch.float32, device=device)
    return ([x[:stages].contiguous() for x in lin]
            + [alt, theta.contiguous(), q2])


def both(problems, iters):
    out = knot_ip(DIMS, *problems, OPTS, iters)
    want = linearized_ip_fixed(DIMS, *problems, OPTS, iters)
    torch.cuda.synchronize()
    return out, want


def dz_rel(out, want):
    scale = want.dz.abs().amax(dim=(-2, -1)).clamp(min=1e-30)
    return (out.dz - want.dz).abs().amax(dim=(-2, -1)) / scale


def shapes_of(device, dtype=torch.float32, n_knot=STAGES, lead=(2, STAGES)):
    nz, nt = DIMS.nz, DIMS.ntheta
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return [zeros(n_knot, nz), zeros(n_knot, nt), zeros(n_knot, nz),
            zeros(n_knot, nz, nz), zeros(n_knot, nz, nt),
            zeros(*lead, DIMS.nc), zeros(*lead, nt), zeros(*lead, DIMS.nq)]


def _wrong_dtype(args):
    args[3] = args[3].double()


def _wrong_shape(args):
    args[4] = args[4][:, :, :-1].contiguous()


def _not_contiguous(args):
    args[6] = args[6].mT.contiguous().mT


def _knot_count(args):
    args[5:] = [x[:, :-1].contiguous() for x in args[5:]]


@pytest.mark.parametrize("spoil", [_wrong_dtype, _wrong_shape,
                                   _not_contiguous, _knot_count])
def test_launch_checks_inputs_first(spoil):
    """The launch path refuses inputs the kernel does not take before it
    builds or launches anything (checked here on CPU tensors: a build
    would fail first with "nvcc not found")."""
    args = shapes_of("cpu")
    spoil(args)
    before = knot_ip.launches
    with pytest.raises(ValueError, match="knot_ip"):
        knot_mod._launch(DIMS, *args, OPTS, 8)
    assert knot_ip.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,trials,stages", [(16, TRIALS, STAGES),
                                                 (16, 1, STAGES),
                                                 (1, 1, 3)])
@pytest.mark.parametrize("iters", [1, 3])
def test_kernel_matches_plain_early(card, lanes, trials, stages, iters):
    """After 1 and 3 iterations, before two float32 solves can part: every
    problem to 1e-4 in z and 1e-3 of its scale in dz, the same converged
    flags; one launch counted. The shapes are the main path's two (1008
    problems in the line search, 144 at the start of a period) and a
    3-knot one."""
    problems = knot_problems(card, lanes, trials, stages)
    before = knot_ip.launches
    out, want = both(problems, iters)
    assert knot_ip.launches == before + 1
    assert torch.isfinite(out.z).all() and torch.isfinite(out.dz).all()
    assert float((out.z - want.z).abs().max()) < 1e-4
    assert float(dz_rel(out, want).max()) < 1e-3
    assert bool((out.converged == want.converged).all())


@pytest.mark.cuda
def test_kernel_matches_plain_main_iterations(card):
    """At the main path's 8 iterations two correct float32 solves part on
    a few problems near the tolerance set (chip_smoke.py's header has the
    measured spread): shares of agreeing problems."""
    out, want = both(knot_problems(card, 16), CFG.fixed_ip_iters)
    assert float((out.converged == want.converged).float().mean()) >= 0.93
    conv = out.converged & want.converged
    err = (out.z - want.z).abs()[conv]
    assert float((err[:, :DIMS.nq].amax(dim=1) < 1e-3).float().mean()) >= 0.95
    assert float((err.amax(dim=1) < 5e-3).float().mean()) >= 0.85
    assert float((dz_rel(out, want)[conv] < 1e-2).float().mean()) >= 0.93


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,trials,stages", [(229, 1, STAGES),
                                                 (457, 1, STAGES),
                                                 (911, 1, STAGES),
                                                 (911, 3, 3)])
def test_ragged_blocks(card, lanes, trials, stages):
    """From 2048 problems on a block takes 8 problems of a knot (the
    kernel's ``block_warps``), and these batches give every knot a number
    of problems that is no multiple of 8: the last block of each knot is
    part empty. Every problem still agrees with the plain version as the
    small batches do."""
    problems = knot_problems(card, lanes, trials, stages)
    assert lanes * trials * stages >= 2048 and (lanes * trials) % 8 != 0
    out, want = both(problems, 3)
    assert torch.isfinite(out.z).all() and torch.isfinite(out.dz).all()
    assert float((out.z - want.z).abs().max()) < 1e-4
    assert float(dz_rel(out, want).max()) < 1e-3
    assert bool((out.converged == want.converged).all())


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [float("nan"), 1e30])
def test_poisoned_theta_stays_in_its_problem(card, poison):
    """One problem's θ is poisoned (NaN, or a huge finite value): the
    kernel keeps a finite z there and flags it unconverged, as the plain
    version does (for NaN both keep the initial point and the same dz), and
    every other problem comes out bit for bit as without the poison."""
    problems = knot_problems(card, 4, 1, STAGES)
    clean = knot_ip(DIMS, *problems, OPTS, CFG.fixed_ip_iters)
    theta = problems[6].clone()
    theta[1, 0, 4, 7] = poison
    bad = problems[:6] + [theta, problems[7]]
    out, want = both(bad, CFG.fixed_ip_iters)
    hit = torch.zeros_like(out.converged)
    hit[1, 0, 4] = True
    assert torch.isfinite(out.z).all() and torch.isfinite(out.dz).all()
    assert not bool(out.converged[hit]) and not bool(want.converged[hit])
    if poison != poison:
        z_init = torch.cat([problems[7][hit],
                            torch.ones((1, DIMS.nz - DIMS.nq), device=card)], 1)
        assert torch.equal(out.z[hit], z_init)
        assert torch.equal(want.z[hit], z_init)
        assert float(dz_rel(out, want)[hit]) < 1e-3
    assert bool(((want.dz[hit] == 0) <= (out.dz[hit] == 0)).all())
    for a, b in zip(out, clean):
        assert torch.equal(a[~hit], b[~hit])


@pytest.mark.cuda
def test_poisoned_knot_zeroes_its_sensitivities(card):
    """A NaN column in one knot's rθ0: every problem of that knot gets
    dz = 0 and is flagged, z stays finite, exactly as the plain version
    gives; the other knots' problems are untouched."""
    problems = knot_problems(card, 3, 2, STAGES)
    clean = knot_ip(DIMS, *problems, OPTS, CFG.fixed_ip_iters)
    rtheta0 = problems[4].clone()
    rtheta0[2, :, 20] = float("nan")
    bad = problems[:4] + [rtheta0] + problems[5:]
    out, want = both(bad, CFG.fixed_ip_iters)
    assert torch.isfinite(out.z).all() and torch.isfinite(out.dz).all()
    assert not bool(out.dz[:, :, 2].any()) and not bool(want.dz[:, :, 2].any())
    assert not bool(out.converged[:, :, 2].any())
    assert not bool(want.converged[:, :, 2].any())
    assert torch.equal(out.z[:, :, 2], want.z[:, :, 2])
    keep = torch.arange(STAGES, device=card) != 2
    for a, b in zip(out, clean):
        assert torch.equal(a[:, :, keep], b[:, :, keep])


@pytest.mark.cuda
def test_prologue_packs_knot_constants(card):
    """The kernel's prologue against the plain packing of the same
    constants: copies exact, the products and the inverse to 1e-5 of each
    block's largest entry, zeros in all padding."""
    knots = knot_problems(card, 1)[:5]
    got = knot_mod.pack_knots(DIMS, *knots)
    want = knot_mod.pack_knots_plain(DIMS, *knots)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (STAGES, knot_mod.pack_layout(DIMS).size)
    exact = {"rza", "dy1", "ry1d", "ry2", "z0", "r0", "theta0", "rtheta0"}
    blocks = knot_mod.pack_blocks(DIMS, want)
    for name, a in knot_mod.pack_blocks(DIMS, got).items():
        b = blocks[name]
        if name in exact:
            assert torch.equal(a, b), name
        else:
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name
    assert bool((got[want == 0] == 0).all())


@pytest.mark.cuda
def test_main_path_runs_through_kernel(card):
    """Two lanes × two control periods of the main path on the card: the
    outputs stay on the card and finite, and every Newton evaluation of
    every period launched the kernel."""
    steps = 2 * CFG.n_sample
    rollout, ref, model, _, _ = make_quadruped_rollout(
        CFG, steps, torch.float32, device=card)
    q1s, v1s = conf_initial_states(model, ref)
    newton_graphs.reset_stats()
    before = knot_ip.launches
    res = rollout(q1s[:2], v1s[:2])
    torch.cuda.synchronize()
    per_period = 1 + CFG.newton_iters
    # besides the launches of the Newton graphs' warm-up (one set a rollout)
    warmup = newton_graphs.stats["warmup_launches"]
    assert knot_ip.launches - before - warmup == 2 * per_period
    for name, x in res._asdict().items():
        assert x.is_cuda, name
        if x.is_floating_point():
            assert torch.isfinite(x).all(), name
    assert bool(res.sim_converged.all())


# ---- the second instantiation: hopper_2d on flat ground --------------------

H_DIMS = dims_of(hopper_2d, flat_2d_lc)
H_KAPPA = 1.0e-4
H_OPTS = default_mpc_ip_options(H_KAPPA)


def hopper_problems(device, lanes, trials, stages):
    """(lanes, trials, stages) problems over the first ``stages`` knots of
    the hopper's in-place gait, float32, θ perturbed as ``knot_problems``
    perturbs the quadruped's."""
    ref = from_gait(hopper_2d, flat_2d_lc,
                    load_gait("hopper_2D", "gait_in_place"), kappa=H_KAPPA,
                    dtype=torch.float32, device=device)
    lin = linearize_trajectory(hopper_2d, flat_2d_lc, ref, H_KAPPA)
    shape = (lanes, trials, stages)
    noise = np.random.default_rng(0).standard_normal(shape + (H_DIMS.ntheta,))
    theta = ref.theta[:stages] + 0.003 * torch.as_tensor(
        noise, dtype=torch.float32, device=device)
    q2 = ref.q[2:stages + 2].expand(shape + (H_DIMS.nq,)).contiguous()
    alt = torch.zeros(shape + (H_DIMS.nc,), dtype=torch.float32,
                      device=device)
    return ([x[:stages].contiguous() for x in lin]
            + [alt, theta.contiguous(), q2])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,trials,stages", [(16, 7, 10), (16, 1, 10),
                                                 (1, 1, 3), (37, 7, 10)])
@pytest.mark.parametrize("iters,refine", [(1, 0), (3, 0), (3, 1)])
def test_hopper_kernel_matches_plain_early(card, lanes, trials, stages, iters,
                                           refine):
    """The hopper's instantiation (nx 4, ny 4, nθ 14, nc 1: no sensitivity
    column past the warp's lanes, idle lanes past NY, NE and NT) after 1
    and 3 iterations, at the direct path's two shapes (K = 10 knots), a
    3-knot one and one of 2590 problems (8 warps a block, ragged): every
    problem to 1e-4 in z and 1e-3 of its scale in dz."""
    import dataclasses
    opts = dataclasses.replace(H_OPTS, refine=refine)
    problems = hopper_problems(card, lanes, trials, stages)
    before = knot_ip.launches
    out = knot_ip(H_DIMS, *problems, opts, iters)
    want = linearized_ip_fixed(H_DIMS, *problems, opts, iters)
    torch.cuda.synchronize()
    assert knot_ip.launches == before + 1
    assert torch.isfinite(out.z).all() and torch.isfinite(out.dz).all()
    assert float((out.z - want.z).abs().max()) < 1e-4
    assert float(dz_rel(out, want).max()) < 1e-3
    assert bool((out.converged == want.converged).all())


@pytest.mark.cuda
def test_hopper_prologue_packs_knot_constants(card):
    """The prologue at the hopper's dimensions against the plain packing."""
    knots = hopper_problems(card, 1, 1, 10)[:5]
    got = knot_mod.pack_knots(H_DIMS, *knots)
    want = knot_mod.pack_knots_plain(H_DIMS, *knots)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (10, knot_mod.pack_layout(H_DIMS).size)
    exact = {"rza", "dy1", "ry1d", "ry2", "z0", "r0", "theta0", "rtheta0"}
    blocks = knot_mod.pack_blocks(H_DIMS, want)
    for name, a in knot_mod.pack_blocks(H_DIMS, got).items():
        b = blocks[name]
        if name in exact:
            assert torch.equal(a, b), name
        else:
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name
    assert bool((got[want == 0] == 0).all())


@pytest.mark.cuda
def test_quadruped_kernel_at_ten_knots(card):
    """The quadruped's instantiation at the direct path's K = 10 knots
    (structure mode has 9)."""
    out, want = both(knot_problems(card, 16, TRIALS, 10), 3)
    assert float((out.z - want.z).abs().max()) < 1e-4
    assert float(dz_rel(out, want).max()) < 1e-3
    assert bool((out.converged == want.converged).all())


@pytest.mark.cuda
def test_model_without_instantiation_raises(card):
    """Dimensions the build does not hold raise on CUDA tensors: no
    fallback to the plain version. Every model of the JAX package on a
    linearized-cone terrain has its instantiation; the 2D particle on the
    nonlinear cone (ny 3) has none."""
    dims = Dims(nq=2, nu=2, nw=2, nc=1, nf=1, ne=2)
    nz, nt = dims.nz, dims.ntheta
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=card)
    args = [zeros(3, nz), zeros(3, nt), zeros(3, nz), zeros(3, nz, nz),
            zeros(3, nz, nt), zeros(2, 3, dims.nc), zeros(2, 3, nt),
            zeros(2, 3, dims.nq)]
    before = knot_ip.launches
    with pytest.raises(RuntimeError, match="unsupported dims"):
        knot_ip(dims, *args, H_OPTS, 3)
    assert knot_ip.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("newton_mode", ["direct", "structure"])
def test_general_path_runs_through_kernel(card, newton_mode):
    """``simulate`` + ``ci_mpc_policy`` on the hopper, on the card (4 lanes
    × 10 steps, 2 control updates, adaptive sim solves): the knot solves of
    both Newton modes launch the kernel, every output is a finite CUDA
    tensor and every step converges."""
    import contactimplicitmpc_tpu_torch as pt
    from contactimplicitmpc_tpu_torch.control.implicit_dynamics import \
        CONFIGURATION
    from contactimplicitmpc_tpu_torch.control.newton import NewtonOptions
    from contactimplicitmpc_tpu_torch.control.objective import \
        tracking_objective
    from contactimplicitmpc_tpu_torch.control.trajectory import \
        initial_conditions
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions

    ref = from_gait(hopper_2d, flat_2d_lc,
                    load_gait("hopper_2D", "gait_in_place"), kappa=H_KAPPA,
                    dtype=torch.float32, device=card)
    obj = tracking_objective(H_DIMS, 10, q=1e-2 * np.array([0.1, 3, 1, 3]),
                             u=[3e-3, 1.0], dtype=torch.float32, device=card)
    policy = pt.ci_mpc_policy(
        hopper_2d, flat_2d_lc, ref, obj, h_mpc=10, n_sample=5,
        kappa_mpc=H_KAPPA, mode=CONFIGURATION, newton_mode=newton_mode,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, fixed_ip_iters=8))
    q1, v1 = initial_conditions(ref)
    offsets = 0.02 * torch.as_tensor(
        np.random.default_rng(0).uniform(-1, 1, (4, 4)), dtype=torch.float32,
        device=card)
    before = knot_ip.launches
    traj = pt.simulate(
        hopper_2d, flat_2d_lc, 10, float(ref.h) / 5, q1[None] + offsets,
        v1.expand(4, -1).contiguous(), policy=policy,
        opts=IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40, max_ls=6))
    torch.cuda.synchronize()
    assert knot_ip.launches >= before + 2
    for name, x in traj._asdict().items():
        assert x.is_cuda, name
        if x.is_floating_point():
            assert torch.isfinite(x).all(), name
    assert bool(pt.status(traj).all())


# ---- the wide template, a block a problem: the centroidal quadruped --------

def centroidal_problems(device, lanes, trials, stages):
    """(lanes, trials, stages) problems over the first ``stages`` knots of
    the centroidal quadruped's in-place trot on flat_3d_lc (nx 18, ny 24,
    nθ 53, nc 4), float32, θ perturbed as ``knot_problems`` perturbs the
    quadruped's; with examples/centroidal_trot.py's float32 knot options."""
    kappa = 2.0e-4
    dims = dims_of(centroidal_quadruped, flat_3d_lc)
    opts = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=30, undercut=5.0,
                     gamma_reg=0.1, diff_sol=True, max_ls=3, refine=1)
    ref = from_gait(centroidal_quadruped, flat_3d_lc,
                    load_gait("centroidal_quadruped", "inplace_trot_v2"),
                    update_friction=True, dtype=torch.float32, device=device)
    lin = linearize_trajectory(centroidal_quadruped, flat_3d_lc, ref, kappa)
    shape = (lanes, trials, stages)
    noise = np.random.default_rng(0).standard_normal(shape + (dims.ntheta,))
    theta = ref.theta[:stages] + 0.003 * torch.as_tensor(
        noise, dtype=torch.float32, device=device)
    q2 = ref.q[2:stages + 2].expand(shape + (dims.nq,)).contiguous()
    alt = torch.zeros(shape + (dims.nc,), dtype=torch.float32, device=device)
    return dims, opts, ([x[:stages].contiguous() for x in lin]
                        + [alt, theta.contiguous(), q2])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,trials", [(16, 1), (16, 7)])
@pytest.mark.parametrize("iters", [1, 3])
def test_centroidal_kernel_matches_plain_early(card, lanes, trials, iters):
    """The wide template (``struct WLay``: a block of threads a problem, the
    knot's block and the problem's state in shared memory past 48 KB) at
    the centroidal quadruped's dimensions, N = 160 and 1120 over K = 10
    knots, after 1 and 3 iterations: every problem to 1e-4 in z and 1e-3 of
    its scale in dz, the same converged flags."""
    dims, opts, problems = centroidal_problems(card, lanes, trials, 10)
    assert not warp_template(dims)
    before = knot_ip.launches
    out = knot_ip(dims, *problems, opts, iters)
    want = linearized_ip_fixed(dims, *problems, opts, iters)
    torch.cuda.synchronize()
    assert knot_ip.launches == before + 1
    assert torch.isfinite(out.z).all() and torch.isfinite(out.dz).all()
    assert float((out.z - want.z).abs().max()) < 1e-4
    assert float(dz_rel(out, want).max()) < 1e-3
    assert bool((out.converged == want.converged).all())


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [float("nan"), 1e30])
def test_centroidal_poisoned_theta_stays_in_its_problem(card, poison):
    """The wide template with one problem's θ poisoned: that problem keeps
    a finite z and is flagged unconverged, as in the plain version (for NaN
    both keep the initial point), and every other problem comes out bit for
    bit as without the poison."""
    dims, opts, problems = centroidal_problems(card, 4, 1, 10)
    clean = knot_ip(dims, *problems, opts, 8)
    theta = problems[6].clone()
    theta[1, 0, 4, 7] = poison
    bad = problems[:6] + [theta, problems[7]]
    out = knot_ip(dims, *bad, opts, 8)
    want = linearized_ip_fixed(dims, *bad, opts, 8)
    torch.cuda.synchronize()
    hit = torch.zeros_like(out.converged)
    hit[1, 0, 4] = True
    assert torch.isfinite(out.z).all() and torch.isfinite(out.dz).all()
    assert not bool(out.converged[hit]) and not bool(want.converged[hit])
    if poison != poison:
        z_init = torch.cat([problems[7][hit],
                            torch.ones((1, dims.nz - dims.nq), device=card)],
                           1)
        assert torch.equal(out.z[hit], z_init)
        assert torch.equal(want.z[hit], z_init)
    assert bool(((want.dz[hit] == 0) <= (out.dz[hit] == 0)).all())
    for a, b in zip(out, clean):
        assert torch.equal(a[~hit], b[~hit])


@pytest.mark.cuda
def test_centroidal_prologue_packs_knot_constants(card):
    """The wide template's prologue against the plain packing of the same
    constants at its own layout: copies exact, the products and the
    inverse to 1e-5 of each block's largest entry, zeros elsewhere."""
    dims, _, problems = centroidal_problems(card, 1, 1, 10)
    knots = problems[:5]
    got = knot_mod.pack_knots(dims, *knots)
    want = knot_mod.pack_knots_plain(dims, *knots)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (10, knot_mod.pack_layout(dims).size)
    exact = {"rza", "dy1", "ry1d", "ry2", "z0", "r0", "theta0", "rtheta0"}
    blocks = knot_mod.pack_blocks(dims, want)
    for name, a in knot_mod.pack_blocks(dims, got).items():
        b = blocks[name]
        if name in exact:
            assert torch.equal(a, b), name
        else:
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name
    assert bool((got[want == 0] == 0).all())


# ---- the instantiations every other model needs ------------------------------

def _chip_smoke():
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def new_problems(name, device, lanes, trials):
    """(dims, options, problems) of chip_smoke.py's phase for ``name``: its
    knots (the path's gait, or the committed knot states of a model no path
    runs), (lanes, trials, K) problems with θ perturbed as
    ``knot_problems`` perturbs the quadruped's."""
    cs = _chip_smoke()
    model, env, ref, kappa, opts, k = cs.phase_case(name, device=device)
    dims = dims_of(model, env)
    lin = linearize_trajectory(model, env, ref, kappa)
    knots, alt, th, q2 = cs.knot_problems(lin, ref, lanes, trials, k,
                                          np.random.default_rng(0), dims)
    return dims, opts, knots + [alt, th, q2]


NEW = ["flamingo", "hopper_3D", "pushbot", "walledcartpole", "particle_2D",
       "particle", "centroidal_quadruped_wall"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("iters", [1, 3])
def test_new_instantiation_matches_plain_early(card, name, iters):
    """Each instantiation this slice adds, at 16 lanes × 7 trials × its K
    knots, after 1 and 3 iterations: every problem to 1e-4 in z and 1e-3
    of its scale in dz, the same converged flags, one launch."""
    dims, opts, problems = new_problems(name, card, 16, 7)
    before = knot_ip.launches
    out = knot_ip(dims, *problems, opts, iters)
    want = linearized_ip_fixed(dims, *problems, opts, iters)
    torch.cuda.synchronize()
    assert knot_ip.launches == before + 1
    assert torch.isfinite(out.z).all() and torch.isfinite(out.dz).all()
    assert float((out.z - want.z).abs().max()) < 1e-4
    assert float(dz_rel(out, want).max()) < 1e-3
    assert bool((out.converged == want.converged).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", NEW)
def test_new_prologue_packs_knot_constants(card, name):
    """Each new instantiation's prologue against the plain packing at its
    own layout: copies exact, the products and the inverse to 1e-5 of each
    block's largest entry, zeros elsewhere."""
    dims, _, problems = new_problems(name, card, 1, 1)
    knots = problems[:5]
    got = knot_mod.pack_knots(dims, *knots)
    want = knot_mod.pack_knots_plain(dims, *knots)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    exact = {"rza", "dy1", "ry1d", "ry2", "z0", "r0", "theta0", "rtheta0"}
    blocks = knot_mod.pack_blocks(dims, want)
    for key, a in knot_mod.pack_blocks(dims, got).items():
        b = blocks[key]
        if key in exact:
            assert torch.equal(a, b), key
        else:
            scale = float(b.abs().max()) or 1.0
            assert float((a - b).abs().max()) <= 1e-5 * scale, key
    # zeros the kernel must keep: padding and the copies' (a computed entry
    # may sum to a tiny value where the plain version's terms cancel)
    zero = want == 0
    for key, (off, rows, stride, cols) in knot_mod.pack_layout(
            dims).blocks.items():
        if key not in exact:
            for row in range(rows):
                zero[:, off + row * stride:off + row * stride + cols] = False
    assert bool((got[zero] == 0).all())
