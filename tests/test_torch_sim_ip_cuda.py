"""The quadruped's sim kernel (``csrc/sim_ip.cu``) against its plain version
on the card: ``sim.interior_point.ip_program``'s replayed CUDA graphs
(``SimSolve._graphed``) of the same solve on the same problems.

The problems are the sim steps of a plain run of path A (the hot path's
16 lanes, ``STEPS`` steps, every sim solve a graph replay), recorded as
float32 (``record_states``; chip_smoke.py's phase S takes them from here).

- float64 (the states cast): converged flags equal on every problem and
  |Δz| ≤ ``F64_Z`` on every converged one, with the hot path's options
  (24 masked trips), phase L's (adaptive, 40 trips, 6 halvings) and
  ``simulate``'s defaults (adaptive, 100 trips, 25 halvings: 52
  candidates, two rounds of the warp);
- float32, the hot path's and phase L's options: the kernel (float64
  inside) against the graphs within ``F32_LIMITS``, limits set from the
  spread of two correct solves of the same float32 problems
  (tools/sim_ip_spread.py; PERF.md records the measured spread);
- a θ poisoned with NaN in one problem stays in that problem;
- ``quadruped_payload``; adaptive solves with cold restarts (``retries``)
  and refinement; the largest max_ls and 1024 problems; a model or
  terrain the kernel does not take goes through the graphs; a bad input
  raises before any launch; ``simulate`` and ``mpc_rollout`` launch the
  kernel once a sim step;
- the sim step of phase L's closed loop where float32 arithmetic stalls
  (``contactimplicitmpc_tpu_torch/assets/sim_ip_f32_stall.npz``,
  ``tools/sim_ip_f32_stall.py``): the kernel converges on it, the build in
  float32 arithmetic does not.

The tests are marked ``cuda`` and skip where CUDA is absent. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_sim_ip_cuda.py
"""

import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch.control.trajectory import (
    from_gait, initial_conditions)
from contactimplicitmpc_tpu_torch.hotpath import (HotPathConfig,
                                                  conf_initial_states,
                                                  make_quadruped_rollout)
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d
from contactimplicitmpc_tpu_torch.models.quadruped import (quadruped,
                                                           quadruped_payload)
from contactimplicitmpc_tpu_torch.ops import sim_ip as sim_mod
from contactimplicitmpc_tpu_torch.sim import graphs
from contactimplicitmpc_tpu_torch.sim.graphs import SimSolve
from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
from contactimplicitmpc_tpu_torch.sim.simulator import default_sim_options
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

CFG = HotPathConfig()
STEPS = 10
STALL = os.path.join(os.path.dirname(pt.__file__), "assets",
                     "sim_ip_f32_stall.npz")
# phase L's sim options (tests/test_torch_contracts_cuda.py::sim_options)
PHASE_L = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                    undercut=float("inf"), max_ls=6)
OPTIONS = {"hot_path": CFG.sim_ip_options(), "phase_L": PHASE_L,
           "simulate": default_sim_options()}
F64_Z = 1e-8
# float32, the kernel (which computes in float64) against the graphs over
# path A's recorded sim steps: the least share of problems whose converged
# flags agree, the least share of the problems both flag converged whose z
# agree within ``z_tol``, and the largest |Δz| on those. Set from the spread
# of two correct solves of the same float32 problems on the CPU, over the
# 160 sim steps of path A's first 10 steps (tools/sim_ip_spread.py, the hot
# path's and phase L's options alike): the JAX package's float32 ip_solve
# against the port's plain version in float32, flags 100% (all converge),
# z 98.75% within 1e-3, largest |Δz| 0.118; the plain version in float64
# against itself in float32, flags 100%, z 95.0%, largest 0.114 (problems
# whose weakly determined cone slacks land elsewhere in the κ_tol = 1e-5
# tolerance set). The limits sit under the smaller shares and over twice
# the larger |Δz|.
F32_LIMITS = {"conv_agree": 0.97, "z_share": 0.90, "z_tol": 1e-3,
              "z_max": 0.25}


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
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def record_states(dev, steps=STEPS):
    """(z0, θ) float32, (steps × 16, ·): every sim step of a plain run of
    path A (its solves the replayed graphs, never the kernel)."""
    rollout, ref, model, _, _ = make_quadruped_rollout(CFG, steps,
                                                       torch.float32,
                                                       device=dev)
    q1s, v1s = conf_initial_states(model, ref)
    seen = []

    def plain(self, z0, theta):
        seen.append((z0.clone(), theta.clone()))
        return SimSolve._graphed(self, z0, theta)

    before = sim_mod.sim_ip.launches
    with mock.patch.object(SimSolve, "_kernel", plain):
        rollout(q1s, v1s)
    assert sim_mod.sim_ip.launches == before and len(seen) == steps
    return (torch.cat([z for z, _ in seen]).contiguous(),
            torch.cat([t for _, t in seen]).contiguous())


@pytest.fixture(scope="module")
def states(card):
    return record_states(card)


def both(model, z0, theta, opts):
    """(kernel, plain): the kernel's solve and the replayed graphs'."""
    solve = SimSolve(model, pt.flat_2d_lc, opts)
    assert solve.route(z0) == "kernel"
    before = sim_mod.sim_ip.launches
    got = solve(z0, theta)
    assert sim_mod.sim_ip.launches == before + 1
    want = solve._graphed(z0, theta)
    torch.cuda.synchronize()
    return got, want


def f64_gaps(got, want):
    """(flags equal everywhere, largest |Δz| over the converged)."""
    same = bool(torch.equal(got.converged, want.converged))
    conv = want.converged
    dz = (got.z - want.z).abs().amax(dim=1)
    return same, float(dz[conv].max()) if bool(conv.any()) else 0.0


def f32_spread(got, want, z_tol):
    """Shares of agreeing flags and, among the problems both flag
    converged, of z within ``z_tol``, and the largest |Δz| there."""
    agree = float((got.converged == want.converged).float().mean())
    both_ok = got.converged & want.converged
    dz = (got.z - want.z).abs().amax(dim=1)[both_ok]
    share = float((dz <= z_tol).float().mean()) if dz.numel() else 1.0
    return {"conv_agree": agree, "z_share": share,
            "z_max": float(dz.max()) if dz.numel() else 0.0}


def check_f32(got, want):
    spread = f32_spread(got, want, F32_LIMITS["z_tol"])
    assert spread["conv_agree"] >= F32_LIMITS["conv_agree"], spread
    assert spread["z_share"] >= F32_LIMITS["z_share"], spread
    assert spread["z_max"] <= F32_LIMITS["z_max"], spread
    return spread


@pytest.mark.cuda
@pytest.mark.parametrize("options", list(OPTIONS))
def test_float64_matches_plain(card, states, options):
    z0, theta = (x.double() for x in states)
    got, want = both(quadruped, z0, theta, OPTIONS[options])
    same, gap = f64_gaps(got, want)
    assert same, (got.converged.tolist(), want.converged.tolist())
    assert gap <= F64_Z, gap
    assert bool(want.converged.any())


@pytest.mark.cuda
@pytest.mark.parametrize("options", ["hot_path", "phase_L"])
def test_float32_within_spread(card, states, options):
    got, want = both(quadruped, *states, OPTIONS[options])
    check_f32(got, want)
    assert torch.isfinite(got.z).all()


@pytest.mark.cuda
def test_nan_stays_in_its_problem(card, states):
    z0, theta = (x[:16].double().clone() for x in states)
    opts = OPTIONS["hot_path"]
    clean = sim_mod.sim_ip(quadruped, pt.flat_2d_lc, z0, theta, opts)
    theta[5, 3] = float("nan")
    got = sim_mod.sim_ip(quadruped, pt.flat_2d_lc, z0, theta, opts)
    want = SimSolve(quadruped, pt.flat_2d_lc, opts)._graphed(z0, theta)
    others = torch.arange(16, device=card) != 5
    for a, b in zip(got[:5], clean[:5]):
        assert torch.equal(a[others], b[others])
    assert not bool(got.converged[5]) and torch.equal(got.z[5], z0[5])
    assert int(got.iterations[5]) == int(want.iterations[5]) == 0
    assert not bool(want.converged[5]) and torch.equal(want.z[5], z0[5])


@pytest.mark.cuda
def test_payload_matches_plain(card, states):
    z0, theta = (x.double() for x in states)
    got, want = both(quadruped_payload, z0, theta, OPTIONS["hot_path"])
    same, gap = f64_gaps(got, want)
    assert same and gap <= F64_Z, gap


@pytest.mark.cuda
def test_adaptive_retries_and_refine_match_plain(card, states):
    """Tight tolerances and few trips, so that problems fail and restart
    cold twice, with a refinement pass a solve: flags and iteration counts
    equal, z within F64_Z on every problem."""
    z0, theta = (x[:32].double() for x in states)
    opts = IPOptions(r_tol=1e-7, kappa_tol=1e-7, max_iter=8,
                     undercut=float("inf"), max_ls=6, retries=2, refine=1)
    got, want = both(quadruped, z0, theta, opts)
    assert torch.equal(got.converged, want.converged)
    assert torch.equal(got.iterations, want.iterations)
    assert float((got.z - want.z).abs().max()) <= F64_Z
    assert not bool(want.converged.all())


@pytest.mark.cuda
def test_shared_memory_and_batch_limits(card, states):
    """The kernel's limits against the graphs, float64: the largest max_ls
    (128 candidates a trip in one round, 105 KB of shared memory a block)
    on the first 16 recorded steps with phase L's options, and 1024
    problems (the recorded steps repeated; two blocks an SM, so the blocks
    run in waves) with the hot path's: flags equal and |Δz| ≤ F64_Z, and
    a repeated problem's solution the same bit for bit."""
    z0, theta = (x.double() for x in states)
    wide = dataclasses.replace(PHASE_L, max_ls=sim_mod.MAX_LS)
    got, want = both(quadruped, z0[:16], theta[:16], wide)
    same, gap = f64_gaps(got, want)
    assert same and gap <= F64_Z, gap
    n = z0.shape[0]
    reps = -(-1024 // n)
    zb, tb = (x.repeat(reps, 1)[:1024].contiguous() for x in (z0, theta))
    got, want = both(quadruped, zb, tb, OPTIONS["hot_path"])
    same, gap = f64_gaps(got, want)
    assert same and gap <= F64_Z, gap
    assert torch.equal(got.z[:n], got.z[n:2 * n])


@pytest.mark.cuda
def test_other_models_and_terrains_take_the_graphs(card, states):
    before = sim_mod.sim_ip.launches
    graphs.reset_stats()
    z0, theta = states[0][:16], states[1][:16]
    terrain = SimSolve(quadruped, pt.piecewise1_2d_lc, OPTIONS["hot_path"])
    assert terrain.route(z0) == "graphs"
    terrain(z0, theta)
    hopper = pt.dims_of(hopper_2d, pt.flat_2d_lc)
    q = torch.tensor([[0.0, 0.5, 0.0, 0.5]] * 4, device=card)
    th = pt.pack_theta(q, q, torch.zeros((4, hopper.nu), device=card),
                       torch.zeros((4, hopper.nw), device=card), 0.8, 0.01)
    solve = SimSolve(hopper_2d, pt.flat_2d_lc, PHASE_L)
    assert solve.route(q) == "graphs"
    solve(pt.z_initialize(hopper, q), th)
    torch.cuda.synchronize()
    assert sim_mod.sim_ip.launches == before
    assert graphs.stats["replays"] == 2


@pytest.mark.cuda
def test_bad_inputs_raise_before_a_launch(card, states):
    z0, theta = states[0][:4], states[1][:4]
    before = sim_mod.sim_ip.launches
    bad = [(quadruped, pt.flat_2d_lc, z0.half(), theta.half(), PHASE_L),
           (quadruped, pt.flat_2d_lc, z0, theta.double(), PHASE_L),
           (quadruped, pt.flat_2d_lc, z0, theta[:3], PHASE_L),
           (quadruped, pt.flat_2d_lc, z0, theta,
            dataclasses.replace(PHASE_L, max_ls=64)),
           (quadruped, pt.flat_2d_lc, z0, theta,
            dataclasses.replace(PHASE_L, diff_sol=True)),
           (hopper_2d, pt.flat_2d_lc, z0, theta, PHASE_L)]
    for args in bad:
        with pytest.raises(ValueError):
            sim_mod.sim_ip(*args)
    with pytest.raises(ValueError, match="for float32 tensors"):
        sim_mod.sim_ip(quadruped, pt.flat_2d_lc, z0.double(), theta.double(),
                       PHASE_L, arithmetic="float32")
    assert sim_mod.sim_ip.launches == before


@pytest.mark.cuda
def test_simulate_and_mpc_rollout_launch_once_a_step(card):
    ref = from_gait(quadruped, pt.flat_2d_lc, load_gait("quadruped", "gait2"),
                    dtype=torch.float32, device=card)
    q1, v1 = initial_conditions(ref)
    graphs.reset_stats()
    before = sim_mod.sim_ip.launches
    traj = pt.simulate(quadruped, pt.flat_2d_lc, 5, float(ref.h) / 5,
                       q1[None], v1[None], opts=PHASE_L)
    assert sim_mod.sim_ip.launches == before + 5
    rollout, ref, model, _, _ = make_quadruped_rollout(CFG, 5, torch.float32,
                                                       device=card)
    q1s, v1s = conf_initial_states(model, ref)
    out = rollout(q1s[:2], v1s[:2])
    torch.cuda.synchronize()
    assert sim_mod.sim_ip.launches == before + 10
    assert graphs.stats["replays"] == 0
    assert bool(traj.converged.all()) and bool(out.sim_converged.all())


@pytest.mark.cuda
def test_f32_stall_state(card):
    """The float32 problem at which phase L's closed loop through the
    kernel in float32 arithmetic stopped converging: the kernel as the sim
    steps run it (float64 inside) converges; the float32-arithmetic build
    ends its trips above κ_tol, as ``csrc/sim_ip.cu`` records."""
    data = np.load(STALL)
    opts = IPOptions(**json.loads(str(data["options"])))
    z0 = torch.as_tensor(data["z0"], device=card)
    theta = torch.as_tensor(data["theta"], device=card)
    assert z0.dtype == torch.float32
    got = SimSolve(quadruped, pt.flat_2d_lc, opts)(z0, theta)
    f32 = sim_mod.sim_ip(quadruped, pt.flat_2d_lc, z0, theta, opts,
                         arithmetic="float32")
    torch.cuda.synchronize()
    assert bool(got.converged.all())
    assert not bool(f32.converged.any())
    assert int(f32.iterations[0]) == opts.max_iter
    assert float(f32.kvio[0]) > opts.kappa_tol
