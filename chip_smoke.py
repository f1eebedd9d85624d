"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device — require CUDA, print the card's name and power limit, pin full
   float32 products;
2. build — compile the knot interior-point kernel (csrc/knot_ip.cu) from
   this checkout with nvcc; one build holds the three instantiations
   (quadruped and 2D hopper a warp a problem, the centroidal quadruped a
   block a problem);
3. kernel against its plain version, at the quadruped's dimensions — the
   gait2 knots linearized on the card, θ perturbed by 0.003·N(0, 1) from
   numpy.random.default_rng(0), at the structure path's two shapes (16
   lanes × 7 line-search trials × 9 stages = 1008 problems, and 16 × 1 × 9
   = 144, the first launch of every period), at the direct path's two
   (K = 10 knots: 1120 and 160), at N = 3 and at N = 256 × 63 = 16128
   (past 2048 problems a block holds 8 warps, not 1): every problem after
   1 and 3 iterations (``max_abs_err`` below is the largest |Δz| there,
   over both instantiations), and shares of agreeing problems after the
   main path's 8; the kernel's per-knot prologue against the plain packing
   of the same constants; then warm times of both at N = 144, 1008, 16128
   and at K = 10 (CUDA events; the kernel's launches queued behind a spin
   on the device so that the events bracket kernels, not the host's
   enqueueing), and the kernel's bound at each
   (``ops/knot_ip.py::bound_ms``): the larger of its operations over 67
   TFLOP/s (float32 outside the tensor cores) and its bytes over 3.35
   TB/s, both counted by ``work`` from the shapes;
4. the same at the 2D hopper's dimensions (nx 4, ny 4, nθ 14, nc 1) — the
   in-place gait's knots, N = 16 × 7 × 10 = 1120, 16 × 1 × 10 = 160, 3 and
   37 × 7 × 10 = 2590: every problem after 1 and 3 iterations, shares
   after 8, the prologue, times and bounds; and a model the build does not
   hold raises;
5. the wide template (a block a problem) at the centroidal quadruped's
   dimensions (nx 18, ny 24, nθ 53, nc 4) — the in-place trot's knots on
   flat_3d_lc with examples/centroidal_trot.py's float32 knot options, N =
   16 × 7 × 10 = 1120, 16 × 1 × 10 = 160, 3 and 64 × 7 × 10 = 4480: every
   problem after 1 and 3 iterations, shares after 8, the prologue, times
   and bounds;
6. path A — the flat-ground quadruped closed-loop MPC rollout at the
   HotPathConfig defaults (structure-mode Newton), float32, 16 lanes × 50
   sim steps, with the kernel's launch counter read around it and the
   closed-loop health checked as tests/test_hotpath.py checks the JAX
   package: the same 16 lanes (``hotpath.conf_initial_states``), the
   nominal lane inside the reference CI thresholds, at least 90% of lanes
   with ≥ 95% converged sim steps;
7. path B — the general path on the 2D hopper, the configuration of
   examples/hopper_monte_carlo.py: ``simulate`` driven by
   ``ci_mpc_policy`` with direct-mode Newton (8 fixed knot iterations, so
   that the knot solves launch the kernel) and adaptive sim solves, 16
   lanes × 100 sim steps. Lane 0 is the gait's initial condition, lanes
   1-15 the example's offsets (0.05 · uniform(−1, 1) drawn by JAX from
   PRNGKey(100), committed as numpy). On these lanes the JAX package
   (float32, CPU, tools/hopper_lanes_reference.py) converges every step of
   all 16; the port may lose one. The nominal lane converges every step
   and stays inside tests/test_mpc_hopper.py's bounds (its height bound is
   taken at that test's step 500; at step 100 the gait is at its apex, and
   the band here is the example's 0 < z < 1);
8. path C — the quadruped through ``mpc_rollout`` with
   ``HotPathConfig(newton_mode="direct")`` (a 300 × 300 KKT a lane), 16
   lanes × 25 sim steps, the health of path A;
9. path D — the centroidal quadruped (18 DoF, 3D) through ``mpc_rollout``
   in examples/centroidal_trot.py's configuration (direct-mode Newton in
   configuration mode, a 480 × 480 KKT a lane, fixed 8-iteration knot
   solves on the wide template, adaptive float32 sim solves, a warm-start
   floor of 1e-2), 16 lanes × 50 sim steps: lane 0 nominal, lanes 1-15 the
   body moved by 0.02 in position and 0.05 in Euler angles
   (assets/centroidal_offsets16.npz, tools/centroidal_lanes_reference.py).
   The nominal lane converges every step with q error < 0.05 and a lowest
   body height above half the reference's; at most one lane fewer than the
   JAX package's 16 converges every step;
10. spans — each path once more for 2 control periods with
   host-synchronised spans on (sim IP, Newton, of it the KKT solve and the
   knot kernel).

JSON lines give the bound and the kernel's share of it at each timed
shape; the line before the card's name is a JSON object with the kernel's
comparison, launches (summed over the four paths, and by path), times and
bound at path A's N = 1008 and, beside them, the hopper instantiation's
and the centroidal quadruped's at N = 1120; the last
line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

import os

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch.control.implicit_dynamics import (
    CONFIGURATION, default_mpc_ip_options)
from contactimplicitmpc_tpu_torch.control.linearized import \
    linearize_trajectory
from contactimplicitmpc_tpu_torch.control.newton import NewtonOptions
from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
from contactimplicitmpc_tpu_torch.control.objective import \
    tracking_velocity_objective
from contactimplicitmpc_tpu_torch.control.trajectory import (
    from_gait, initial_conditions, tracking_errors)
from contactimplicitmpc_tpu_torch.dims import Dims
from contactimplicitmpc_tpu_torch.env import flat_2d_lc, flat_3d_lc
from contactimplicitmpc_tpu_torch.hotpath import (HotPathConfig,
                                                  conf_initial_states,
                                                  make_quadruped_rollout)
from contactimplicitmpc_tpu_torch.models.base import dims_of
from contactimplicitmpc_tpu_torch.models.centroidal_quadruped import \
    centroidal_quadruped
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.ops import knot_ip as knot_mod
from contactimplicitmpc_tpu_torch.ops.fixed_ip import linearized_ip_fixed
from contactimplicitmpc_tpu_torch.ops.knot_ip import knot_ip
from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
from contactimplicitmpc_tpu_torch.utils import spans
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

# Tolerances of the kernel against the plain version, float32, set from the
# spread between two correct float32 implementations (the JAX package's and
# the port's plain version, on the CPU, same 1008 problems):
# - after 1 and 3 iterations the two agree on every problem to ~1e-5 in z
#   and ~5e-5 relative in dz, so EXACT_Z / EXACT_DZ hold on every problem;
# - after the main path's 8 iterations, problems whose residual sits near
#   the float32 floor, and the loose κ tolerance (2e-4) that leaves the
#   cone slacks weakly determined, let two correct solves land on different
#   points of the tolerance set: measured agreement 95.6% of converged
#   flags, 99.1% of q2 blocks within 1e-3, 90.5% of z within 5e-3, 97.8% of
#   dz within 1e-2 of its scale. The bounds below sit under those.
EXACT_ITERS = (1, 3)
EXACT_Z = 1e-4        # max |Δz| over all problems
EXACT_DZ = 1e-3       # max |Δdz| / max |dz| of the problem
CONV_AGREE = 0.93     # share of converged flags that agree
Q2_TOL, Q2_SHARE = 1e-3, 0.95   # q2 block, share of both-converged problems
Z_TOL, Z_SHARE = 5e-3, 0.85     # all of z
DZ_TOL, DZ_SHARE = 1e-2, 0.93   # dz relative to the problem's largest entry
# The hopper's instantiation after 8 iterations, set the same way
# (tools/knot_ip_spread.py hopper_2d, the same 1120 problems on the CPU):
# its r_tol = 1e-8 lies under the float32 floor, so neither solve flags a
# problem converged and the shares are over all problems; JAX and the plain
# version agree on 100% of flags, 100% of q2 within 1e-3, 100% of z within
# 5e-3 (largest 4.2e-3) and 99.9% of dz within 1e-2.
HOPPER_SHARES = {"conv_agree": 0.97, "q2_share": 0.97, "z_share": 0.95,
                 "dz_share": 0.95}
# The centroidal quadruped's (the wide template) after 8 iterations, set the
# same way (tools/knot_ip_spread.py centroidal_quadruped, the trot's 1120
# problems, examples/centroidal_trot.py's float32 knot options): every
# problem converges in both, and JAX and the plain version agree on 100% of
# flags, q2 blocks within 1e-3, z within 5e-3 (largest 1.6e-5) and dz within
# 1e-2 (largest 4.1e-5 of its scale); the bounds are the hopper's.
CENTROIDAL_SHARES = dict(HOPPER_SHARES)
# Path D's lanes in the JAX package (tools/centroidal_lanes_reference.py,
# float32 on the CPU, the same 16 lanes × 50 steps with fixed 8-iteration
# knot solves): all 16 converge every sim step; nominal q/u/γ/b errors
# 0.000357 / 0.0832 / 0.253 / 0.0280, lowest body height 0.2996 nominal and
# 0.2853–0.3025 over the lanes against the reference's 0.2995, 2.44 Newton
# iterations a period. The port may lose one lane.
CENTROIDAL_JAX_OK = 16
QUADRUPED_SHARES = {"conv_agree": CONV_AGREE, "q2_share": Q2_SHARE,
                    "z_share": Z_SHARE, "dz_share": DZ_SHARE}
# The prologue's products and inverse against the plain packing: both sum
# 11 float32 terms in another order, ~1e-7 of the block's largest entry
# measured; copies are exact.
PACK_TOL = 1e-5
PACK_EXACT = ("rza", "dy1", "ry1d", "ry2", "z0", "r0", "theta0", "rtheta0")

SPIN_CYCLES = 60_000_000   # ≈ 35 ms of device spin ahead of timed launches


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, spin=False):
    """CUDA-event time of one call; with ``spin`` the calls are queued
    behind a spin on the device, so that a short kernel's time is not the
    host's enqueueing time."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


HOPPER_OFFSETS = os.path.join(
    os.path.dirname(os.path.abspath(pt.__file__)), "assets",
    "hopper_offsets16.npz")
CENTROIDAL_OFFSETS = os.path.join(
    os.path.dirname(os.path.abspath(pt.__file__)), "assets",
    "centroidal_offsets16.npz")


def knot_problems(lin, ref, lanes, trials, stages, rng, dims):
    """The paths' layout: lin of ``stages`` knots, per-problem tensors
    (lanes, trials, stages, ·) with θ perturbed per problem."""
    shape = (lanes, trials, stages)
    th = ref.theta[:stages] + 0.003 * torch.as_tensor(
        rng.standard_normal(shape + (dims.ntheta,)), dtype=torch.float32,
        device="cuda")
    q2 = ref.q[2:stages + 2].expand(shape + (dims.nq,)).contiguous()
    alt = torch.zeros(shape + (dims.nc,), dtype=torch.float32, device="cuda")
    knots = [x[:stages].contiguous() for x in lin]
    return knots, alt, th.contiguous(), q2


def compare_pack(dims, knots):
    """The prologue's packed per-knot constants against the plain packing."""
    got = knot_mod.pack_knots(dims, *knots)
    want = knot_mod.pack_knots_plain(dims, *knots)
    torch.cuda.synchronize()
    assert got.shape == want.shape, (got.shape, want.shape)
    want_blocks = knot_mod.pack_blocks(dims, want)
    worst = 0.0
    for name, a in knot_mod.pack_blocks(dims, got).items():
        b = want_blocks[name]
        if name in PACK_EXACT:
            assert torch.equal(a, b), name
        else:
            rel = float((a - b).abs().max()) / float(b.abs().max())
            assert rel <= PACK_TOL, (name, rel)
            worst = max(worst, rel)
    assert bool((got[want == 0] == 0).all()), "padding not zero"
    print(f"prologue vs plain packing, K={got.shape[0]}: copies equal, "
          f"largest relative error of a computed block {worst:.3g}",
          flush=True)


def dz_rel(out, ref):
    scale = ref.dz.abs().amax(dim=(-2, -1)).clamp(min=1e-30)
    return (out.dz - ref.dz).abs().amax(dim=(-2, -1)) / scale


def compare_exact(out, ref, iters):
    """Every problem after a few iterations, before solves can part."""
    z_err = float((out.z - ref.z).abs().max())
    dz_err = float(dz_rel(out, ref).max())
    same = bool((out.converged == ref.converged).all())
    print(f"kernel vs plain, {iters} iterations, N="
          f"{out.converged.numel()}: max |Δz| {z_err:.3g}, max relative "
          f"|Δdz| {dz_err:.3g}, converged flags equal {same}", flush=True)
    assert torch.isfinite(out.z).all() and torch.isfinite(out.dz).all()
    assert z_err < EXACT_Z and dz_err < EXACT_DZ and same, (z_err, dz_err)
    return z_err


def compare_full(dims, out, ref, bounds, converged_only=True):
    """The paths' iteration count: shares of agreeing problems, among the
    problems both solves flag converged or among all of them."""
    both = out.converged & ref.converged
    if not converged_only:
        both = torch.ones_like(both)
    err = (out.z - ref.z).abs()[both]
    stats = {
        "n": int(out.converged.numel()),
        "conv_kernel": float(out.converged.float().mean()),
        "conv_plain": float(ref.converged.float().mean()),
        "conv_agree": float((out.converged == ref.converged).float().mean()),
        "q2_share": float((err[:, :dims.nq].amax(dim=1) < Q2_TOL)
                          .float().mean()),
        "z_share": float((err.amax(dim=1) < Z_TOL).float().mean()),
        "dz_share": float((dz_rel(out, ref)[both] < DZ_TOL).float().mean()),
        "z_max_err": float(err.max()),
        "rvio_max": float(out.rvio[both].max()),
    }
    print("kernel vs plain, path iterations:", json.dumps(stats), flush=True)
    assert torch.isfinite(out.z).all() and torch.isfinite(out.dz).all()
    for key, least in bounds.items():
        assert stats[key] >= least, (key, stats)
    return stats


def kernel_phase(name, model, gait, kappa, opts, iters, shapes, shares,
                 timed, tag, update_friction=False, converged_only=True,
                 env=flat_2d_lc):
    """One instantiation against its plain version: every problem of
    ``shapes`` (lanes, trials, knots) after 1 and 3 iterations, shares of
    the first shape after ``iters``, the prologue, and times and bounds of
    the ``timed`` shapes. Returns (largest |Δz|, {N: (kernel ms, plain ms,
    bound ms, bound by)})."""
    dims = dims_of(model, env)
    ref = from_gait(model, env, gait, kappa=kappa,
                    update_friction=update_friction, dtype=torch.float32,
                    device="cuda")
    lin = linearize_trajectory(model, env, ref, kappa)
    rng = np.random.default_rng(0)

    def pair(problems, n_iter=iters):
        knots, alt, th, q2 = problems
        return (lambda: knot_ip(dims, *knots, alt, th, q2, opts, n_iter),
                lambda: linearized_ip_fixed(dims, *knots, alt, th, q2, opts,
                                            n_iter))

    def run(problems, n_iter):
        kern, plain = pair(problems, n_iter)
        out, want = kern(), plain()
        torch.cuda.synchronize()
        return out, want

    print(f"---- {name}: nx {dims.nx}, ny {dims.ny}, ntheta {dims.ntheta}, "
          f"nc {dims.nc}", flush=True)
    made = [knot_problems(lin, ref, *shape, rng, dims) for shape in shapes]
    max_err = 0.0
    for problems in made:
        for n_iter in EXACT_ITERS:
            max_err = max(max_err, compare_exact(*run(problems, n_iter),
                                                 n_iter))
    compare_full(dims, *run(made[0], iters), shares, converged_only)
    compare_pack(dims, made[0][0])

    times = {}
    for lanes, trials, knots in timed:
        k_fn, p_fn = pair(knot_problems(lin, ref, lanes, trials, knots, rng,
                                        dims))
        n = lanes * trials * knots
        p1 = cuda_ms(p_fn, 3)
        k1 = cuda_ms(k_fn, 20, spin=True)
        k2 = cuda_ms(k_fn, 20, spin=True)
        p2 = cuda_ms(p_fn, 3)
        bound, which = knot_mod.bound_ms(dims, n, knots, iters, opts)
        times[(n, knots)] = (min(k1, k2), min(p1, p2), bound, which)
        print(f"knot_ip {name} N={n} K={knots}: kernel {min(k1, k2):.4f} ms, "
              f"plain {min(p1, p2):.4f} ms, bound {bound:.5f} ms by {which} "
              f"{tag}", flush=True)
    return max_err, times


def check_outputs(res):
    for name, x in res._asdict().items():
        assert x.is_cuda, name
        if x.is_floating_point():
            assert torch.isfinite(x).all(), name


def lane_success(converged):
    """Share of lanes with ≥ 95% converged sim steps, and the per-lane
    shares."""
    per_lane = converged.float().mean(dim=1)
    return float((per_lane >= 0.95).float().mean()), per_lane


def counted(fn):
    """Run ``fn`` with the kernel's launch count set to 0 just before and
    read just after: (result, launches, wall seconds)."""
    torch.cuda.synchronize()
    knot_ip.launches = 0
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, knot_ip.launches, time.time() - t0


def spanned(fn):
    """Run ``fn`` with host-synchronised spans on: ({name: (s, n)}, wall)."""
    torch.cuda.synchronize()
    spans.start()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    return spans.stop(), wall


def print_spans(path, what, got, wall, tag):
    parts = ", ".join(f"{k} {v[0]:.3f} s in {v[1]} entries"
                      for k, v in sorted(got.items()))
    print(f"{path} spans ({what}, synchronised; newton holds kkt_solve and "
          f"knot_ip): wall {wall:.3f} s; {parts} {tag}", flush=True)


def quadruped_path(path, cfg, steps, dev, tag):
    """A quadruped rollout through ``make_quadruped_rollout`` with the
    health checks of tests/test_hotpath.py; returns the launches."""
    rollout, ref, model, _, _ = make_quadruped_rollout(
        cfg, steps, torch.float32, device=dev)
    q1s, v1s = conf_initial_states(model, ref)
    lanes = q1s.shape[0]
    short, *_ = make_quadruped_rollout(cfg, 2 * cfg.n_sample, torch.float32,
                                       device=dev)
    t0 = time.time()
    short(q1s, v1s)
    torch.cuda.synchronize()
    print(f"{path}: warm-up (2 periods) {time.time() - t0:.2f} s {tag}",
          flush=True)

    res, launches, wall = counted(lambda: rollout(q1s, v1s))
    check_outputs(res)
    n_ctrl = steps // cfg.n_sample
    assert launches >= n_ctrl, (launches, n_ctrl)
    assert bool(res.sim_converged[0].all()), "nominal lane sim failed"
    errs = [float(e) for e in tracking_errors(
        ref, res.q[0], res.u[0], res.gamma[0], res.b[0], cfg.n_sample)]
    for e, bound in zip(errs, (0.0201, 0.0437, 0.374, 0.0789)):
        assert e < 1.5 * bound, errs
    success, per_lane = lane_success(res.sim_converged)
    print(f"{path} ({cfg.newton_mode}): {lanes} lanes x {steps} steps in "
          f"{wall:.2f} s = {lanes * steps / wall:.1f} lane-steps/s {tag}",
          flush=True)
    print(f"{path}: success {success:.3f} (per-lane min "
          f"{float(per_lane.min()):.3f}), nominal q/u/gamma/b errors "
          f"{errs}, mean Newton iterations "
          f"{float(res.newton_iterations.float().mean()):.3f}, largest "
          f"final Newton residual {float(res.mpc_r_norm.max()):.4g}, mean "
          f"sim iterations {float(res.sim_iterations.float().mean()):.3f}, "
          f"knot_ip launches {launches} {tag}", flush=True)
    assert success >= 0.9, per_lane.tolist()
    got, span_wall = spanned(lambda: short(q1s, v1s))
    print_spans(path, f"{lanes} lanes x {2 * cfg.n_sample} steps", got,
                span_wall, tag)
    return launches


def hopper_rollout(dev):
    """The general path on the 2D hopper, the configuration of
    examples/hopper_monte_carlo.py: (roll, ref, n_sample, lanes) with
    ``roll(n_steps)`` the ``simulate`` + ``ci_mpc_policy`` (direct) rollout
    of the 16 lanes of ``HOPPER_OFFSETS``."""
    model, env = hopper_2d, flat_2d_lc
    dims = dims_of(model, env)
    dtype = torch.float32
    n_sample, h_mpc, kappa = 5, 10, 1.0e-4
    ref = from_gait(model, env, load_gait("hopper_2D", "gait_in_place"),
                    kappa=kappa, dtype=dtype, device=dev)
    # monte_carlo.jl:33-38 weights
    qw = np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    qw[-2:] = 1e-1 * np.array([0.1, 3, 1, 3])
    vw = np.tile(1e-3 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    vw[:2] = 1e1 * np.array([0.1, 3, 1, 3])
    obj = tracking_velocity_objective(
        dims, h_mpc, q=qw, v=vw, u=np.tile([3e-3, 1e0], (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, 1)), b=1e-100 * np.ones((h_mpc, 2)),
        dtype=dtype, device=dev)
    policy = pt.ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION, newton_mode="direct",
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, fixed_ip_iters=8),
        ip_opts=default_mpc_ip_options(kappa))
    sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                         undercut=float("inf"), max_ls=6)
    q1, v1 = initial_conditions(ref)
    with np.load(HOPPER_OFFSETS) as f:
        offsets = torch.as_tensor(f["offsets"], dtype=dtype, device=dev)
    q1s = q1[None, :] + offsets
    v1s = v1.expand_as(q1s).contiguous()
    h_sim = float(ref.h) / n_sample

    def roll(n_steps):
        return pt.simulate(model, env, n_steps, h_sim, q1s, v1s,
                           policy=policy, opts=sim_opts)

    return roll, ref, n_sample, q1s.shape[0]


def hopper_path(dev, tag):
    """Path B: ``hopper_rollout`` for 100 steps with its health checks;
    returns the launches."""
    roll, ref, n_sample, lanes = hopper_rollout(dev)
    steps = 100
    t0 = time.time()
    roll(2 * n_sample)
    torch.cuda.synchronize()
    print(f"path B: warm-up (2 periods) {time.time() - t0:.2f} s {tag}",
          flush=True)

    traj, launches, wall = counted(lambda: roll(steps))
    check_outputs(traj)
    assert launches >= steps // n_sample, launches
    ok = pt.status(traj)
    assert bool(ok[0]), "nominal lane sim failed"
    errs = [float(e) for e in tracking_errors(
        ref, traj.q[0], traj.u[0], traj.gamma[0], traj.b[0], n_sample)]
    final = traj.q[0, -1].tolist()
    hopping = (traj.q[:, -1, 1] - 0.5).abs() < 0.5
    print(f"path B (hopper_2d, simulate + ci_mpc_policy direct): {lanes} "
          f"lanes x {steps} steps in {wall:.2f} s = "
          f"{lanes * steps / wall:.1f} lane-steps/s {tag}", flush=True)
    print(f"path B: lanes that converged every step {int(ok.sum())}/{lanes}, "
          f"hopping at the end {int(hopping.sum())}/{lanes}, nominal "
          f"q/u/gamma/b errors {errs}, nominal final q {final}, mean sim "
          f"iterations {float(traj.iterations.float().mean()):.3f}, knot_ip "
          f"launches {launches} {tag}", flush=True)
    assert errs[0] < 0.05 and errs[1] < 0.5, errs
    assert abs(final[0]) < 0.5 and 0.0 < final[1] < 1.0, final
    # the JAX package converges every step of all 16 lanes; one may tip
    assert int(ok.sum()) >= lanes - 1, ok.tolist()
    got, span_wall = spanned(lambda: roll(2 * n_sample))
    print_spans("path B", f"{lanes} lanes x {2 * n_sample} steps", got,
                span_wall, tag)
    return launches


def centroidal_options(kappa):
    """examples/centroidal_trot.py's float32 knot and sim options, and its
    Newton options with fixed 8-iteration knot solves (the kernel's form)."""
    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=30,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3,
                       refine=1)
    sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                         undercut=float("inf"), max_ls=6, refine=1)
    return mpc_ip, sim_opts, NewtonOptions(r_tol=3e-5, max_iter=5,
                                           fixed_ip_iters=8)


def centroidal_rollout(dev):
    """Path D's rollout, examples/centroidal_trot.py's configuration:
    (roll, ref, n_sample, lanes) with ``roll(n_steps)`` the ``mpc_rollout``
    (direct-mode Newton, configuration mode, warm-start floor 1e-2) of the
    16 lanes of ``CENTROIDAL_OFFSETS``."""
    model, env = centroidal_quadruped, flat_3d_lc
    dims = dims_of(model, env)
    dtype = torch.float32
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4
    ref = from_gait(model, env, load_gait("centroidal_quadruped",
                                          "inplace_trot_v2"),
                    update_friction=True, dtype=dtype, device=dev)
    # flat_trot.jl:38-42, diagonal form of relative_state_cost
    v_w = 1e-3 * np.concatenate([np.ones(3), 1e3 * np.ones(3), np.ones(12)])
    q_body = np.array([1e-2, 1e-2, 1.0]) + 4.0 * np.array([0.2, 0.2, 1.0])
    q_w = np.concatenate([q_body, 0.3 * np.ones(3),
                          np.tile([0.2, 0.2, 1.0], 4)])
    obj = tracking_velocity_objective(dims, h_mpc, q=q_w, v=v_w,
                                      u=3e-3 * np.ones(dims.nu), dtype=dtype,
                                      device=dev)
    mpc_ip, sim_opts, n_opts = centroidal_options(kappa)
    q1, v1 = initial_conditions(ref)
    with np.load(CENTROIDAL_OFFSETS) as f:
        offsets = torch.as_tensor(f["offsets"], dtype=dtype, device=dev)
    q1s = q1[None, :] + offsets
    v1s = v1.expand_as(q1s).contiguous()

    def roll(n_steps):
        return mpc_rollout(model, env, ref, obj, n_steps, h_mpc, n_sample,
                           kappa, CONFIGURATION, q1s, v1s, n_opts=n_opts,
                           ip_opts=mpc_ip, sim_opts=sim_opts,
                           warm_start_floor=1e-2)

    return roll, ref, n_sample, q1s.shape[0]


def centroidal_path(dev, tag):
    """Path D: ``centroidal_rollout`` for 50 steps with its health checks;
    returns the launches."""
    roll, ref, n_sample, lanes = centroidal_rollout(dev)
    steps = 50
    t0 = time.time()
    roll(2 * n_sample)
    torch.cuda.synchronize()
    print(f"path D: warm-up (2 periods) {time.time() - t0:.2f} s {tag}",
          flush=True)

    res, launches, wall = counted(lambda: roll(steps))
    check_outputs(res)
    assert launches >= steps // n_sample, launches
    ok = res.sim_converged.all(dim=1)
    errs = [float(e) for e in tracking_errors(
        ref, res.q[0], res.u[0], res.gamma[0], res.b[0], n_sample)]
    low = res.q[:, :, 2].amin(dim=1)
    ref_low = float(ref.q[:, 2].min())
    print(f"path D (centroidal_quadruped, mpc_rollout direct): {lanes} "
          f"lanes x {steps} steps in {wall:.2f} s = "
          f"{lanes * steps / wall:.1f} lane-steps/s {tag}", flush=True)
    print(f"path D: lanes that converged every step {int(ok.sum())}/{lanes} "
          f"(JAX: {CENTROIDAL_JAX_OK}/{lanes}), nominal q/u/gamma/b errors "
          f"{errs}, lowest body height nominal {float(low[0]):.4f} / all "
          f"lanes {float(low.min()):.4f} (reference {ref_low:.4f}), mean "
          f"Newton iterations {float(res.newton_iterations.float().mean()):.3f}"
          f", largest final Newton residual {float(res.mpc_r_norm.max()):.4g}"
          f", mean sim iterations "
          f"{float(res.sim_iterations.float().mean()):.3f}, knot_ip launches "
          f"{launches} {tag}", flush=True)
    assert bool(ok[0]), "nominal lane sim failed"
    assert errs[0] < 0.05, errs
    assert float(low[0]) > 0.5 * ref_low, (float(low[0]), ref_low)
    assert int(ok.sum()) >= CENTROIDAL_JAX_OK - 1, ok.tolist()
    got, span_wall = spanned(lambda: roll(2 * n_sample))
    print_spans("path D", f"{lanes} lanes x {2 * n_sample} steps", got,
                span_wall, tag)
    return launches


def main():
    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name_power = card()
    print(name_power, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    tag = f"[{name_power}]"
    dev = torch.device("cuda")
    t_start = time.time()

    # ---- 2. build ----------------------------------------------------------
    t0 = time.time()
    lib = knot_mod.build(verbose=True)
    print(f"build: {lib} in {time.time() - t0:.1f} s", flush=True)

    # ---- 3. the quadruped's instantiation ----------------------------------
    cfg = HotPathConfig()
    opts, iters = cfg.mpc_ip_options(), cfg.fixed_ip_iters
    stages, trials = cfg.h_mpc - 1, cfg.newton_max_ls + 1
    knots = cfg.h_mpc
    err_q, times_q = kernel_phase(
        "quadruped", quadruped, load_gait("quadruped", "gait2"),
        cfg.kappa_mpc, opts, iters,
        shapes=[(16, trials, stages), (16, 1, stages), (1, 1, 3),
                (256, trials, stages), (16, trials, knots), (16, 1, knots)],
        shares=QUADRUPED_SHARES,
        timed=[(16, 1, stages), (16, trials, stages), (256, trials, stages),
               (16, 1, knots), (16, trials, knots)],
        tag=tag, update_friction=True)
    per_period = (times_q[(144, stages)][0]
                  + cfg.newton_iters * times_q[(1008, stages)][0])
    print(f"knot_ip per structure-mode control period (1 launch at N=144, "
          f"{cfg.newton_iters} at N=1008): {per_period:.4f} ms {tag}",
          flush=True)

    # ---- 4. the hopper's instantiation, and a model without one -------------
    h_opts = default_mpc_ip_options(1.0e-4)
    err_h, times_h = kernel_phase(
        "hopper_2d", hopper_2d, load_gait("hopper_2D", "gait_in_place"),
        1.0e-4, h_opts, 8,
        shapes=[(16, 7, 10), (16, 1, 10), (1, 1, 3), (37, 7, 10)],
        shares=HOPPER_SHARES, timed=[(16, 1, 10), (16, 7, 10), (37, 7, 10)],
        tag=tag, converged_only=False)
    particle = Dims(nq=2, nu=2, nw=2, nc=1, nf=2, ne=2)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    before = knot_ip.launches
    try:
        knot_ip(particle, zeros(3, particle.nz), zeros(3, particle.ntheta),
                zeros(3, particle.nz), zeros(3, particle.nz, particle.nz),
                zeros(3, particle.nz, particle.ntheta), zeros(2, 3, 1),
                zeros(2, 3, particle.ntheta), zeros(2, 3, 2), h_opts, 3)
    except RuntimeError as e:
        assert "unsupported dims" in str(e), e
        print(f"a model without an instantiation raises: {e}", flush=True)
    else:
        raise AssertionError("a model without an instantiation did not raise")
    assert knot_ip.launches == before

    # ---- 5. the centroidal quadruped's, a block a problem ---------------------
    c_opts = centroidal_options(2.0e-4)[0]
    err_c, times_c = kernel_phase(
        "centroidal_quadruped", centroidal_quadruped,
        load_gait("centroidal_quadruped", "inplace_trot_v2"), 2.0e-4, c_opts,
        8, shapes=[(16, 7, 10), (16, 1, 10), (1, 1, 3), (64, 7, 10)],
        shares=CENTROIDAL_SHARES,
        timed=[(16, 1, 10), (16, 7, 10), (64, 7, 10)], tag=tag,
        update_friction=True, env=flat_3d_lc)

    # ---- 6-10. the four paths, each with its spans ---------------------------
    launches = {
        "A": quadruped_path("path A", cfg, 50, dev, tag),
        "B": hopper_path(dev, tag),
        "C": quadruped_path("path C", HotPathConfig(newton_mode="direct"),
                            25, dev, tag),
        "D": centroidal_path(dev, tag)}

    bounds = [{"model": model, "n": n, "knots": k, "ms": t[0],
               "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
               "share": t[2] / t[0]}
              for model, times in (("quadruped", times_q),
                                   ("hopper_2d", times_h),
                                   ("centroidal_quadruped", times_c))
              for (n, k), t in times.items()]
    print(json.dumps({"knot_ip_bound": bounds,
                      "peak_flops": knot_mod.PEAK_FLOPS,
                      "peak_bytes_per_s": knot_mod.PEAK_BYTES,
                      "card": name_power}))
    main_q, main_h = times_q[(1008, stages)], times_h[(1120, 10)]
    main_c = times_c[(1120, 10)]
    print(json.dumps({"kernels": [{
        "name": "knot_ip", "route": "cuda",
        "source": "contactimplicitmpc_tpu_torch/csrc/knot_ip.cu",
        "replaces": "contactimplicitmpc_tpu/ops/pallas_ip.py:310",
        "launches": sum(launches.values()),
        "max_abs_err": max(err_q, err_h, err_c),
        "ms": main_q[0], "plain_ms": main_q[1], "bound_ms": main_q[2],
        "bound_by": main_q[3], "library_ms": None,
        "launches_by_path": launches,
        "hopper_n": 1120, "hopper_ms": main_h[0],
        "hopper_plain_ms": main_h[1], "hopper_bound_ms": main_h[2],
        "hopper_bound_by": main_h[3],
        "centroidal_n": 1120, "centroidal_ms": main_c[0],
        "centroidal_plain_ms": main_c[1], "centroidal_bound_ms": main_c[2],
        "centroidal_bound_by": main_c[3]}]}))
    print(f"chip_smoke: every phase after the device check in "
          f"{time.time() - t_start:.1f} s {tag}", flush=True)
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
