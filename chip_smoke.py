"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device — require CUDA, print the card's name and power limit, pin full
   float32 products;
2. build — compile the knot interior-point kernel (csrc/knot_ip.cu) from
   this checkout with nvcc;
3. kernel against its plain version — the gait2 knots linearized on the
   card, θ perturbed by 0.003·N(0, 1) from numpy.random.default_rng(0),
   at the main path's two shapes (16 lanes × 7 line-search trials × 9
   stages = 1008 problems, and 16 × 1 × 9 = 144, the first launch of every
   period), at N = 3 and at N = 256 × 63 = 16128 (past 2048 problems a
   block holds 8 warps, not 1): every problem after 1 and 3 iterations
   (``max_abs_err`` below is the largest |Δz| there), and shares of
   agreeing problems after the main path's 8; the kernel's per-knot
   prologue against the plain packing of the same constants; then warm
   times of both at N = 144, N = 1008 and N = 256 × 63 = 16128 (CUDA
   events; the kernel's launches queued behind a spin on the device so
   that the events bracket kernels, not the host's enqueueing), and the
   kernel's bound at each (``ops/knot_ip.py::bound_ms``): the larger of
   its operations over 67 TFLOP/s (float32 outside the tensor cores) and
   its bytes over 3.35 TB/s, both counted by ``work`` from the shapes;
4. main path — the flat-ground quadruped closed-loop MPC rollout at the
   HotPathConfig defaults, float32, 16 lanes × 100 sim steps, with the
   kernel's launch counter read around it and the closed-loop health
   checked as tests/test_hotpath.py checks the JAX package: the same 16
   lanes (``hotpath.conf_initial_states``: lane 0 the gait's initial
   condition, lanes 1-15 bench.py's "conf" poses drawn by JAX from
   PRNGKey(0), committed as numpy), the nominal lane inside the reference
   CI thresholds, at least 90% of lanes with ≥ 95% converged sim steps.
   On these lanes the JAX package (float32, CPU) converges every sim step
   of every lane.

A JSON line gives the bound and the kernel's share of it at each timed
shape; the line before the card's name is a JSON object with the kernel's
comparison, launches, times and bound at the main path's N = 1008; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from contactimplicitmpc_tpu_torch.control.linearized import \
    linearize_trajectory
from contactimplicitmpc_tpu_torch.control.trajectory import (from_gait,
                                                             tracking_errors)
from contactimplicitmpc_tpu_torch.env import flat_2d_lc
from contactimplicitmpc_tpu_torch.hotpath import (HotPathConfig,
                                                  conf_initial_states,
                                                  make_quadruped_rollout)
from contactimplicitmpc_tpu_torch.models.base import dims_of
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.ops import knot_ip as knot_mod
from contactimplicitmpc_tpu_torch.ops.fixed_ip import linearized_ip_fixed
from contactimplicitmpc_tpu_torch.ops.knot_ip import knot_ip
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


def knot_problems(lin, ref, lanes, trials, stages, rng, dims):
    """The main path's layout: lin of ``stages`` knots, per-problem
    tensors (lanes, trials, stages, ·) with θ perturbed per problem."""
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


def compare_full(dims, out, ref):
    """The main path's iteration count: shares of agreeing problems."""
    both = out.converged & ref.converged
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
        "rvio_max": float(out.rvio[out.converged].max()),
    }
    print("kernel vs plain, main path iterations:", json.dumps(stats),
          flush=True)
    assert torch.isfinite(out.z).all() and torch.isfinite(out.dz).all()
    assert stats["conv_agree"] >= CONV_AGREE, stats
    assert stats["q2_share"] >= Q2_SHARE, stats
    assert stats["z_share"] >= Z_SHARE, stats
    assert stats["dz_share"] >= DZ_SHARE, stats
    return stats


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

    # ---- 2. build ----------------------------------------------------------
    t0 = time.time()
    lib = knot_mod.build(verbose=True)
    print(f"build: {lib} in {time.time() - t0:.1f} s", flush=True)

    # ---- 3. kernel against its plain version -------------------------------
    cfg = HotPathConfig()
    opts, iters = cfg.mpc_ip_options(), cfg.fixed_ip_iters
    dims = dims_of(quadruped, flat_2d_lc)
    dev = torch.device("cuda")
    ref = from_gait(quadruped, flat_2d_lc, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=torch.float32, device=dev)
    lin = linearize_trajectory(quadruped, flat_2d_lc, ref, cfg.kappa_mpc)
    rng = np.random.default_rng(0)
    stages, trials = cfg.h_mpc - 1, cfg.newton_max_ls + 1

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

    main_shape = knot_problems(lin, ref, 16, trials, stages, rng, dims)
    first_shape = knot_problems(lin, ref, 16, 1, stages, rng, dims)
    small = knot_problems(lin, ref, 1, 1, 3, rng, dims)
    large = knot_problems(lin, ref, 256, trials, stages, rng, dims)
    max_err = 0.0
    for problems in (main_shape, first_shape, small, large):
        for n_iter in EXACT_ITERS:
            max_err = max(max_err, compare_exact(*run(problems, n_iter),
                                                 n_iter))
    compare_full(dims, *run(main_shape, iters))
    compare_pack(dims, main_shape[0])

    times, bounds = {}, []
    for lanes, n_trials in ((16, 1), (16, trials), (256, trials)):
        k_fn, p_fn = pair(knot_problems(lin, ref, lanes, n_trials, stages,
                                        rng, dims))
        n = lanes * n_trials * stages
        p1 = cuda_ms(p_fn, 3)
        k1 = cuda_ms(k_fn, 20, spin=True)
        k2 = cuda_ms(k_fn, 20, spin=True)
        p2 = cuda_ms(p_fn, 3)
        times[n] = (min(k1, k2), min(p1, p2))
        bound, which = knot_mod.bound_ms(dims, n, stages, iters, opts)
        bounds.append({"n": n, "ms": times[n][0], "bound_ms": bound,
                       "bound_by": which, "share": bound / times[n][0]})
        print(f"knot_ip N={n}: kernel {times[n][0]:.4f} ms, plain "
              f"{times[n][1]:.4f} ms, bound {bound:.4f} ms by {which} "
              f"{tag}", flush=True)
    per_period = times[144][0] + cfg.newton_iters * times[1008][0]
    print(f"knot_ip per control period (1 launch at N=144, "
          f"{cfg.newton_iters} at N=1008): {per_period:.4f} ms {tag}",
          flush=True)

    # ---- 4. main path --------------------------------------------------------
    steps = 100
    rollout, ref_r, model, env, dims = make_quadruped_rollout(
        cfg, steps, torch.float32, device=dev)
    q1s, v1s = conf_initial_states(model, ref_r)
    lanes = q1s.shape[0]

    warm_roll, *_ = make_quadruped_rollout(cfg, cfg.n_sample, torch.float32,
                                           device=dev)
    t0 = time.time()
    warm_roll(q1s, v1s)
    torch.cuda.synchronize()
    print(f"warm-up period: {time.time() - t0:.2f} s {tag}", flush=True)

    knot_ip.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res = rollout(q1s, v1s)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = knot_ip.launches

    for name, x in res._asdict().items():
        assert x.is_cuda, name
        if x.is_floating_point():
            assert torch.isfinite(x).all(), name
    n_ctrl = steps // cfg.n_sample
    assert launches >= n_ctrl, (launches, n_ctrl)
    assert bool(res.sim_converged[0].all()), "nominal lane sim failed"
    errs = [float(e) for e in tracking_errors(
        ref_r, res.q[0], res.u[0], res.gamma[0], res.b[0], cfg.n_sample)]
    for e, bound in zip(errs, (0.0201, 0.0437, 0.374, 0.0789)):
        assert e < 1.5 * bound, errs
    per_lane = res.sim_converged.float().mean(dim=1)
    success = float((per_lane >= 0.95).float().mean())
    print(f"main path: {lanes} lanes x {steps} steps in {wall:.2f} s = "
          f"{lanes * steps / wall:.1f} lane-steps/s {tag}", flush=True)
    print(f"main path: success {success:.3f} (per-lane min "
          f"{float(per_lane.min()):.3f}), nominal q/u/gamma/b errors "
          f"{errs}, mean Newton iterations "
          f"{float(res.newton_iterations.float().mean()):.3f}, mean sim "
          f"iterations {float(res.sim_iterations.float().mean()):.3f}, "
          f"knot_ip launches {launches} {tag}", flush=True)
    assert success >= 0.9, per_lane.tolist()

    print(json.dumps({"knot_ip_bound": bounds,
                      "peak_flops": knot_mod.PEAK_FLOPS,
                      "peak_bytes_per_s": knot_mod.PEAK_BYTES,
                      "card": name_power}))
    main_bound = next(b for b in bounds if b["n"] == 1008)
    print(json.dumps({"kernels": [{
        "name": "knot_ip", "route": "cuda",
        "source": "contactimplicitmpc_tpu_torch/csrc/knot_ip.cu",
        "replaces": "contactimplicitmpc_tpu/ops/pallas_ip.py:310",
        "launches": launches, "max_abs_err": max_err,
        "ms": times[1008][0], "plain_ms": times[1008][1],
        "bound_ms": main_bound["bound_ms"], "bound_by": main_bound["bound_by"],
        "library_ms": None}]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
