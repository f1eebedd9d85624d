"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device — require CUDA, print the card's name and power limit, pin full
   float32 products;
2. build — compile the port's four kernels from this checkout with nvcc,
   all at once (one nvcc a source): the quadruped's sim step
   (csrc/sim_ip.cu, float32 and float64), the Newton's two KKT solves
   (csrc/structure_kkt.cu, the structure mode's whole structured solve, and
   csrc/ldl.cu, the direct mode's unpivoted LDLᵀ; float32 and float64) and
   the knot interior-point kernel (csrc/knot_ip.cu), whose one build holds
   the ten instantiations,
   one for the dimensions of each model of the JAX package (ops/knot_ip.py's
   KNOT_IP_MODELS, a warp a problem: quadruped, 2D hopper, flamingo, 2D
   particle, pushbot, walled cartpole; KNOT_IP_WIDE_MODELS, a block a
   problem: centroidal quadruped, 3D particle, 3D hopper, centroidal
   quadruped at the wall);
3. kernel against its plain version, at the quadruped's dimensions — the
   gait2 knots linearized on the card, θ perturbed by 0.003·N(0, 1) from
   numpy.random.default_rng(0), at the structure path's two shapes (16
   lanes × 7 line-search trials × 9 stages = 1008 problems, and 16 × 1 × 9
   = 144, the first launch of every period), at the direct path's two
   (K = 10 knots: 1120 and 160), at N = 3 and at N = 256 × 63 = 16128
   (past 2048 problems a block holds 8 warps, not 1): every problem after
   1 and 3 iterations (``max_abs_err`` below is the largest |Δz| there,
   over every instantiation), and shares of agreeing problems after the
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
   37 × 7 × 10 = 2590; and dimensions the build does not hold (the 2D
   particle on the nonlinear cone) raise;
5. the same at each of the other paths' instantiations, on the path's own
   knots and N = 16 × 7 × K, 16 × 1 × K, 3 and 64 × 7 × K: the centroidal
   quadruped's (block template, K = 10, the in-place trot), the flamingo's
   (warp template, nx 9, ny 16, nθ 28, nc 4, K = 15, gait_forward_36_4
   with examples/flamingo_slope.py's knot options) and the 3D hopper's
   (block template, nx 7, ny 6, nθ 22, nc 1, K = 20, gait_forward with
   tests/test_mpc_hopper_3d.py's knot options);
6. the same at the instantiations no path runs — pushbot (K = 40),
   walled cartpole, 2D and 3D particle, centroidal quadruped at the wall
   (K = 10), K their examples' horizons — on the knots of a short float64
   simulate of the model from its example's or test's initial state
   (``PATHLESS``, committed by tools/knot_states.py), N = 16 × 7 × K,
   16 × 1 × K and 3;
7. path A — the flat-ground quadruped closed-loop MPC rollout at the
   HotPathConfig defaults (structure-mode Newton), float32, 16 lanes × 100
   sim steps (tests/test_hotpath.py's depth), run as a Monte-Carlo sweep
   through ``parallel.make_sharded_mpc_rollouts`` on ``make_mesh()`` (a
   process group of one rank, NCCL), with the kernel's launch counter read
   around it and the closed-loop health checked as tests/test_hotpath.py
   checks the JAX package: the same 16 lanes
   (``hotpath.conf_initial_states``), the nominal lane inside the reference
   CI thresholds, at least 90% of lanes with ≥ 95% converged sim steps; the
   sweep's ``MPCSweepStats`` equal the same quantities taken from its lanes
   (within 1e-6 of max(1, |x|)), and ``plot_runs_2d`` draws the 16 lanes
   (CUDA tensors) into a temporary PNG (where matplotlib is not installed,
   as on the card's machine, its skeleton lines only);
8. path B — the general path on the 2D hopper, the configuration of
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
9. path C — the quadruped through ``mpc_rollout`` with
   ``HotPathConfig(newton_mode="direct")`` (a 300 × 300 KKT a lane), 16
   lanes × 100 sim steps (tests/test_hotpath.py's depth), the health of
   path A;
10. path D — the centroidal quadruped (18 DoF, 3D) through ``mpc_rollout``
   in examples/centroidal_trot.py's configuration (direct-mode Newton in
   configuration mode, a 480 × 480 KKT a lane, fixed 8-iteration knot
   solves on the wide template, adaptive float32 sim solves, a warm-start
   floor of 1e-2), 16 lanes × 50 sim steps: lane 0 nominal, lanes 1-15 the
   body moved by 0.02 in position and 0.05 in Euler angles
   (assets/centroidal_offsets16.npz, tools/centroidal_lanes_reference.py).
   The nominal lane converges every step with q error < 0.05 and a lowest
   body height above half the reference's; at most one lane fewer than the
   JAX package's 16 converges every step;
11. path E — the flamingo up the smooth slope through ``mpc_rollout`` in
   examples/flamingo_slope.py's configuration as
   tests/test_mpc_flamingo_slope.py checks it (the controller on
   flat_2d_lc, the physics on slope_smooth_2d_lc, configuration mode, a
   360 × 360 KKT a lane, fixed 8-iteration knot solves on the warp
   template, altitude update at 0.02, a warm-start floor of 1e-2, adaptive
   float32 sim solves: r_tol 1e-3, κ_tol 1e-5, 40 iterations, as the
   example's 1e-8 is out of float32's reach), 16 lanes ×
   ``E_STEPS`` sim steps: lane 0 nominal, lanes 1-15 the torso moved and
   tilted (assets/flamingo_offsets16.npz, tools/flamingo_lanes_reference.py).
   The nominal lane converges every step, moves up the slope, keeps its
   torso 0.4 above the terrain and its |angle| under 0.5; at most one lane
   fewer than the JAX package's 16 converges every step;
12. path F — the 3D hopper hopping forward: ``simulate`` driven by
   ``ci_mpc_policy`` in tests/test_mpc_hopper_3d.py's configuration
   (gait_forward on flat_3d_lc, configuration mode, a 340 × 340 KKT a
   lane, fixed 8-iteration knot solves on the block template, altitude
   update at 0.05, float32 adaptive sim solves with the test's line-search
   floor eps_min 0.25), 16 lanes × 100 sim steps
   (assets/hopper3d_offsets16.npz, tools/hopper3d_lanes_reference.py). The
   nominal lane converges every step and travels forward more than half
   the reference's stride over the same knots; at most one lane fewer
   than the JAX package's 16 converges every step;
13. path I — the point-foot quadruped (18 DoF, 3D) standing under a lateral
   push: ``mpc_rollout`` in tests/test_mpc_point_foot.py's push-recovery
   configuration (stand_v0 on flat_3d_lc, configuration mode, a 480 × 480
   KKT a lane, fixed 8-iteration knot solves on the block template's
   (18, 24, 53, 4) instantiation, the push w[40:45] = (0, 5, 1) / 5, path
   D's float32 sim options), 16 lanes × 80 sim steps
   (assets/point_foot_offsets16.npz, tools/point_foot_lanes_reference.py):
   the nominal lane converges every step and ends within 0.05 of the
   reference's height and 0.1 of its lateral position; at most one lane
   fewer than the JAX package's 16 converges every step;
14. path K — the centroidal quadruped's box variant standing beside the
   box step under a push toward it: ``mpc_rollout`` in
   tests/test_mpc_box.py's configuration (centroidal_quadruped_box,
   stand_v0 on flat_3d_lc, configuration mode, a 480 × 480 KKT a lane,
   fixed 8-iteration knot solves on the (18, 24, 53, 4) instantiation,
   the push w[40:45] = (3, 0, 0) / 5, path D's float32 sim options), 16
   lanes × 80 sim steps (assets/box_offsets16.npz,
   tools/box_lanes_reference.py): the nominal lane converges every step
   with a q tracking error < 0.05 and its feet stay above the box surface
   (``BOX_GAP_BOUND``); at most one lane fewer than the JAX package's
   converges every step;
15. path G — the nonlinear (second-order) friction cone: the 3D particle on
   flat_3d_nc through ``simulate`` (the dense LU of the exact Jacobian),
   float64, 16 lanes × 150 steps sliding from height 1
   (``cone_path``: every step converges, every lane comes to rest on the
   ground and keeps to its slide's line);
16. path H — the Raibert baseline: ``raibert_policy`` on the 2D hopper
   through ``simulate``, float64, 16 lanes × 100 steps (``raibert_path``:
   every step converges, the nominal lane lands and takes off), and one
   TVLQR ``reference_gains`` on the card held to the CPU's;
17. phase J — two processes (this script with ``--sweep-worker``) share
   the card, joined by gloo (NCCL refuses two ranks on one GPU), and run
   ``parallel.sharded_rollout_stats`` on the 2D particle
   (tests/test_parallel.py's 16 lanes, 30 steps of 0.01, float64), held to
   ``monte_carlo_rollouts`` of the same lanes in this process: 16
   rollouts, every one a success, the mean final q within 1e-10. A
   worker's failure fails the script. G, H and J use no MPC and launch no
   knot kernel;
18. phase L — tests/test_mpc_quadruped.py's contract at its full 1000 sim
   steps (``simulate`` + ``ci_mpc_policy``, one lane, float32), run and
   held as tests/test_torch_contracts_cuda.py runs and holds it: every
   step converges, the tracking errors under 1.5 × the reference's;
19. graphs — the sim solve's replayed CUDA graphs (``sim/graphs.py``)
   against its eager body (``SimSolve._eager``) on one sim step each of the
   quadruped on the piecewise slope (a terrain the sim kernel does not
   take; fixed iterations, float32, the quadruped's residual), path B
   (adaptive, float32) and path G (the nonlinear cone's dense LU,
   float64), and on a 20-step ``simulate`` of path B: bit for bit, with
   each step's replayed and eager time and its graphs' warm-up, capture
   and pool memory;
20. phase S — the sim kernel (csrc/sim_ip.cu over csrc/sim_ip.cuh,
   ``ops/sim_ip.py``) against its
   plain version, ``ip_program``'s replayed graphs of the same solve
   (``SimSolve._graphed``), on every sim step of a plain run of path A
   (16 lanes × 10 steps, recorded by tests/test_torch_sim_ip_cuda.py's
   ``record_states``): in float64 with the hot path's options, phase L's
   and ``simulate``'s (25 halvings, 52 candidates), converged flags equal
   on every problem and |Δz| ≤ 1e-8 on every converged one; in float32
   with the hot path's and phase L's, within the limits the test file sets
   from the spread of two correct float32 solves (``F32_LIMITS``,
   tools/sim_ip_spread.py); then the kernel's registers and spill bytes
   a thread as ptxas reported them at the build, and a sim step's time at
   16 lanes and at 1 lane, kernel against graph replay (CUDA events), the
   time a trip (the step's time over the slowest problem's trips), and the
   kernel's bound (``ops/sim_ip.py::bound_ms``) from the trips the
   problems took, at float32's rate (the tensors' type; the kernel
   computes in float64), with the Jacobian counted in its closed form and,
   beside it for comparison, as the earlier warp kernel's dual numbers;
21. newton — the MPC's Newton solve as replayed CUDA graphs
   (``control/graphs.py``) against its eager route on one solve each of
   path A (structure mode), C (direct, n = 300) and D (direct, n = 480),
   and on a 20-step rollout of path A run both ways: bit for bit, the
   knot kernel's and the KKT kernels' launches through replays equal to
   the eager route's, with each solve's replayed and eager time and its
   graphs' warm-up, capture and pool memory (``newton_phase``);
22. kkt — the Newton's two KKT kernels against their plain versions on the
   paths' own first KKTs (``kkt_phase``): the structured solve on A's and
   the structure-mode hopper's, the LDLᵀ on B, C, D, E and F's (n = 100,
   300, 480, 360, 340), float64 within 1e-9 of the plain version's largest
   entry, float32 with a residual no worse than twice the plain version's,
   the LDLᵀ's L and d equal to the plain version's bit for bit in both
   types; their times against the plain version, one library call and the bound,
   ptxas's registers and spills, the LDLᵀ's cluster geometry (a cluster of 4,
   8 or 16 CTAs a matrix by the source's rule) with how many such clusters
   the card runs at once, and the structured solve's chunk of stages.

Every sim step of paths A, C and L is one launch of the sim kernel, and
every sim step of every other path a replay of the sim solve's CUDA
graphs; every Newton solve of the nine MPC paths is one replay of its
graphs (in direct mode a start and a trip a Newton iteration): each
counted run resets the counts and requires it, and the script prints them
a path. The knot kernel's launches are counted through the replays, and
include those of the Newton graphs' warm-ups (a set a rollout, once a
policy). So are the KKT kernels': each counted run requires path A's
Newton solves to launch the structured-solve kernel a whole number of
times a solve and no LDLᵀ, and every direct-mode path's to launch the
LDLᵀ kernel once a trip replay (besides the warm-ups) and no structured
solve.

The spans and device traces of one control period of each MPC path are
tools/torch_profile_paths.py's.

JSON lines give the bound and the knot kernel's share of it at each timed
shape, and the KKT kernels' at theirs; the line before the card's name is
a JSON object with the four kernels:
the knot kernel's comparison, launches (summed over the nine MPC paths,
and by path, and those of the Newton graphs' warm-ups by path), times and bound at path A's N = 1008 and, in
``instantiations``, each of the ten with its dimensions, template, models,
paths and launches and its time, plain time, bound and share at its path's
N; the sim kernel's largest float64 |Δz|, launches on A, C and L, and its
time, the graph replay's and its bound for a sim step of path A's 16
lanes; the structured solve's largest float64 |Δ|, launches by path and
its time, plain time, library time and bound at path A's KKT; the LDLᵀ's
the same at path C's n = 300, and in ``shapes`` at each direct path's n.
The last line is ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import dataclasses
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch.control import graphs as newton_graphs
from contactimplicitmpc_tpu_torch.control.gains import reference_gains
from contactimplicitmpc_tpu_torch.control.graphs import NewtonSolve
from contactimplicitmpc_tpu_torch.control.implicit_dynamics import (
    CONFIGURATION, default_mpc_ip_options)
from contactimplicitmpc_tpu_torch.control.linearized import \
    linearize_trajectory
from contactimplicitmpc_tpu_torch.control.newton import NewtonOptions
from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
from contactimplicitmpc_tpu_torch.control import structure_solver as ss
from contactimplicitmpc_tpu_torch.control.objective import (
    tracking_objective, tracking_velocity_objective)
from contactimplicitmpc_tpu_torch.control.policy import CIMPCOptions
from contactimplicitmpc_tpu_torch.control.raibert import raibert_policy
from contactimplicitmpc_tpu_torch.control.trajectory import (
    ContactTraj, from_gait, initial_conditions, tracking_errors)
from contactimplicitmpc_tpu_torch.device import describe
from contactimplicitmpc_tpu_torch.env import (flat_2d_lc, flat_2d_nc,
                                              flat_3d_lc, flat_3d_nc,
                                              slope_smooth_2d_lc)
from contactimplicitmpc_tpu_torch.hotpath import (HotPathConfig,
                                                  conf_initial_states,
                                                  make_quadruped_rollout)
from contactimplicitmpc_tpu_torch.models import MODELS
from contactimplicitmpc_tpu_torch.models.base import dims_of
from contactimplicitmpc_tpu_torch.models.centroidal_quadruped import \
    centroidal_quadruped
from contactimplicitmpc_tpu_torch.models.flamingo import flamingo
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d
from contactimplicitmpc_tpu_torch.models.hopper_3d import hopper_3d
from contactimplicitmpc_tpu_torch.models.particle import particle
from contactimplicitmpc_tpu_torch.models.particle_2d import particle_2d
from contactimplicitmpc_tpu_torch.models.point_foot_quadruped import \
    point_foot_quadruped
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.ops import knot_ip as knot_mod
from contactimplicitmpc_tpu_torch.ops.fixed_ip import linearized_ip_fixed
from contactimplicitmpc_tpu_torch.ops.knot_ip import knot_ip
from contactimplicitmpc_tpu_torch.ops import cuda_build
from contactimplicitmpc_tpu_torch.ops import ldl as ldl_mod
from contactimplicitmpc_tpu_torch.ops import sim_ip as sim_mod
from contactimplicitmpc_tpu_torch.ops import structure_kkt as sk_mod
from contactimplicitmpc_tpu_torch.ops.ldl import ldl
from contactimplicitmpc_tpu_torch.ops.linsolve import ldl_solve
from contactimplicitmpc_tpu_torch.ops.structure_kkt import structure_kkt
from contactimplicitmpc_tpu_torch.parallel import (distributed, make_mesh,
                                                   make_sharded_mpc_rollouts,
                                                   monte_carlo_rollouts,
                                                   sharded_rollout_stats)
from contactimplicitmpc_tpu_torch.sim import graphs
from contactimplicitmpc_tpu_torch.sim.graphs import SimSolve
from contactimplicitmpc_tpu_torch.sim.interior_point import (IPOptions,
                                                             z_initialize)
from contactimplicitmpc_tpu_torch.sim.residual import pack_theta
from contactimplicitmpc_tpu_torch.sim.simulator import default_sim_options
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait
from contactimplicitmpc_tpu_torch.utils.visuals import (plot_runs_2d,
                                                       runs_2d_lines,
                                                       skeleton_2d)

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
# The instantiations this slice adds, after 8 iterations, set the same way
# (tools/knot_ip_spread.py MODEL on the CPU, 16 lanes × 7 trials × K knots),
# against the JAX package and against the plain version with the line
# search's equality rows in the kernel's form (``kernel_form``):
# - flamingo (K = 15; the example's r_tol 1e-8: no float32 solve flags a
#   problem converged, shares over all problems): against JAX flags 100%,
#   q2 99.88%, z 97.98%, dz 98.27%; against the kernel's form flags 100%,
#   q2 99.40%, z 89.88%, dz 85.77%. Its residual sits at the float32 floor
#   through all 8 iterations, where r − α Rza d and the residual at the
#   candidate round apart and pick other candidates: the kernel parts from
#   the plain version as far as that form does, so its bounds sit under
#   the kernel form's;
# - hopper_3D (K = 20, r_tol 1e-4): 81.6% converge in both, flags agree on
#   100%, and on the problems both flag, q2, z and dz 100%, in both;
# - pushbot (K = 40): flags ≥ 99.98%, q2 100%, z ≥ 99.24%, dz ≥ 99.82%;
#   walledcartpole, particle, the wall (K = 10): 100% on all four;
#   particle_2D (K = 10): flags 98.93%, q2 100%, z 99.73%, dz 99.55%.
# The other bounds are the hopper's: over all problems where r_tol 1e-8
# leaves none converged, over the converged ones for the 3D hopper.
SHARES = {name: dict(HOPPER_SHARES) for name in (
    "hopper_3D", "pushbot", "walledcartpole", "particle_2D", "particle",
    "centroidal_quadruped_wall")}
SHARES["flamingo"] = {"conv_agree": 0.97, "q2_share": 0.97, "z_share": 0.85,
                      "dz_share": 0.80}
# Paths E's and F's lanes in the JAX package (float32 on the CPU, the same
# 16 lanes and steps with fixed 8-iteration knot solves):
# tools/flamingo_lanes_reference.py: all 16 converge every sim step, up the
# slope by 0.0305-0.0486 (nominal 0.0376), torso clearance ≥ 0.792, |torso
# angle| ≤ 0.0198, 3.01 Newton iterations a period;
# tools/hopper3d_lanes_reference.py: all 16 converge every sim step, the
# nominal lane travels 0.00370 against half the reference's stride 0.00174
# (13 of 16 lanes past it), nominal q/u/γ/b errors 0.00490 / 0.195 / 0.446
# / 0.134. The port may lose one lane.
FLAMINGO_JAX_OK = 16
HOPPER3D_JAX_OK = 16
# Path I's lanes in the JAX package (tools/point_foot_lanes_reference.py,
# float32 on the CPU, the same 16 lanes × 80 steps, push and fixed
# 8-iteration knot solves): all 16 converge every sim step; the nominal
# lane ends 0.00024 from the reference's height and 0.0725 from its lateral
# position (tests/test_mpc_point_foot.py's bounds 0.05 and 0.1), 2.20
# Newton iterations a period, 2.73 sim iterations a step. The port may lose
# one lane.
POINT_FOOT_JAX_OK = 16
I_STEPS = 80
# Path K's lanes in the JAX package (tools/box_lanes_reference.py, float32
# on the CPU, the same 16 lanes × 80 steps, push and fixed 8-iteration knot
# solves): all 16 converge every sim step; q tracking errors 0.00140 nominal
# and ≤ 0.00826 over the lanes (the test's bound 0.05); lowest foot gaps to
# the box surface −7.78e-7 nominal and ≥ −1.08e-6 over the lanes, inside
# the test's bound −1e-4, which K holds; 1.125 Newton iterations a period,
# 2.56 sim iterations a step. The port may lose one lane.
BOX_JAX_OK = 16
BOX_JAX_Q_ERR = 0.00140
BOX_JAX_GAP = -7.78e-7
BOX_GAP_BOUND = -1e-4
K_STEPS = 80
QUADRUPED_SHARES = {"conv_agree": CONV_AGREE, "q2_share": Q2_SHARE,
                    "z_share": Z_SHARE, "dz_share": DZ_SHARE}
# The prologue's products and inverse against the plain packing: both sum
# 11 float32 terms in another order, ~1e-7 of the block's largest entry
# measured; copies are exact.
PACK_TOL = 1e-5
PACK_EXACT = ("rza", "dy1", "ry1d", "ry2", "z0", "r0", "theta0", "rtheta0")

# Path E's depth: the 50 steps of path D, now that the flamingo's and the 3D
# hopper's derivatives are written out (PERF.md §6)
E_STEPS = 50

# Path C's depth: tests/test_hotpath.py's 100 steps, now that the sim steps
# are replayed graphs
C_STEPS = 100
# the sim graphs' counts, the sim kernel's launches and the Newton graphs'
# counts of each path's counted run (``counted``)
GRAPHS = {}
SIM_LAUNCHES = {}
NEWTON = {}
KKT = {}
# the paths whose sim steps the sim kernel takes (the quadruped on flat
# ground); every other path's are graph replays
KERNEL_PATHS = ("path A", "path C", "phase L")
TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")

SPIN_CYCLES = 60_000_000   # ≈ 35 ms of device spin ahead of timed launches


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


ASSETS = os.path.join(os.path.dirname(os.path.abspath(pt.__file__)), "assets")
HOPPER_OFFSETS = os.path.join(ASSETS, "hopper_offsets16.npz")
CENTROIDAL_OFFSETS = os.path.join(ASSETS, "centroidal_offsets16.npz")
FLAMINGO_OFFSETS = os.path.join(ASSETS, "flamingo_offsets16.npz")
HOPPER3D_OFFSETS = os.path.join(ASSETS, "hopper3d_offsets16.npz")
POINT_FOOT_OFFSETS = os.path.join(ASSETS, "point_foot_offsets16.npz")
BOX_OFFSETS = os.path.join(ASSETS, "box_offsets16.npz")
KNOT_STATES = os.path.join(ASSETS, "knot_states.npz")


def _wall_stance():
    """examples/centroidal_wall_sim.py's stance, the feet launched at the
    wall at 10 m/s: (q1, v1)."""
    q1 = np.zeros(18)
    q1[2] = 0.3
    for i, (fx, fy) in enumerate([[0.1, 0.1], [0.1, -0.1], [-0.1, 0.1],
                                  [-0.1, -0.1]]):
        q1[6 + 3 * i:9 + 3 * i] = [fx, fy, 0.05]
    v1 = np.zeros(18)
    v1[6::3] = 10.0
    return q1.tolist(), v1.tolist()


# The instantiations that no path runs, and their knots: the last K steps
# of a float64 ``simulate`` of one lane from the example's or the test's
# initial state, at the example's MPC time step (tools/knot_states.py runs
# it and commits the states as KNOT_STATES); N = lanes × trials × K, K the
# example's horizon. Knot options: the examples' default_mpc_ip_options (κ
# of examples/pushbot_push_recovery.py and examples/cartpole_wall.py); the
# particles and the wall have no MPC example and take κ = 1e-4. Rows:
# (registry name, terrain, q1, v1, h, steps, K, κ, source of the state).
PATHLESS = (
    ("pushbot", flat_2d_lc, [0.3, 0.0], [0.0, 0.0], 0.04, 60, 40, 1e-4,
     "examples/pushbot_push_recovery.py (h, H), tests/test_models_more.py"),
    ("walledcartpole", flat_2d_lc, [0.2, 0.0, 0.0, 0.0], [0.0] * 4, 0.04, 20,
     10, 2e-4, "examples/cartpole_wall.py (h, H), tests/test_models_more.py"),
    ("particle_2D", flat_2d_lc, [0.0, 1.0], [1.0, 0.0], 0.01, 60, 10, 1e-4,
     "tests/test_simulator.py (the slide)"),
    ("particle", flat_3d_lc, [0.0, 0.0, 1.0], [1.0, 2.0, 0.0], 0.01, 60, 10,
     1e-4, "tests/test_simulator.py (the slide)"),
    ("centroidal_quadruped_wall", flat_3d_lc, *_wall_stance(), 0.01, 10, 10,
     1e-4, "examples/centroidal_wall_sim.py"),
)


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
            rel = float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
            assert rel <= PACK_TOL, (name, rel)
            worst = max(worst, rel)
    # zeros of the plain packing that the kernel must keep: padding and
    # the copies' (a computed entry may sum to a tiny value where the plain
    # version's terms cancel exactly; the relative bound covers it)
    zero = want == 0
    for name, (off, rows, stride, cols) in knot_mod.pack_layout(
            dims).blocks.items():
        if name not in PACK_EXACT:
            for row in range(rows):
                zero[:, off + row * stride:off + row * stride + cols] = False
    assert bool((got[zero] == 0).all()), "padding not zero"
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


def simulate_states(model, env, q1, v1, h, steps, knots):
    """The last ``knots`` steps of a ``simulate`` of one lane from (q1, v1)
    with time step ``h``, float64 on the CPU with the default sim options,
    as numpy arrays: q (knots + 2, nq), u, w, gamma, b, z and θ a knot."""
    f64 = torch.float64
    traj = pt.simulate(model, env, steps, h, torch.tensor([q1], dtype=f64),
                       torch.tensor([v1], dtype=f64))
    assert bool(pt.status(traj).all()), "the knots' simulate failed"
    s = steps - knots
    q, u, w = traj.q[0, s:], traj.u[0, s:], traj.w[0, s:]
    return {"q": q, "u": u, "w": w, "gamma": traj.gamma[0, s:],
            "b": traj.b[0, s:], "z": traj.z[0, s:],
            "theta": pt.pack_theta(q[:-2], q[1:-1], u, w, model.mu_world, h)}


def states_ref(name, h, device="cuda", dtype=torch.float32):
    """The committed knots of a model that no path runs (KNOT_STATES) as a
    ContactTraj of ``dtype`` on ``device``."""
    with np.load(KNOT_STATES) as f:
        t = {k: torch.as_tensor(f[f"{name}/{k}"], dtype=dtype, device=device)
             for k in ContactTraj._fields if k not in ("h", "kappa")}
    scalar = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return ContactTraj(h=scalar(h), kappa=scalar(0.0), **t)


def kernel_phase(name, iters, shapes, shares, timed, tag,
                 converged_only=True):
    """The instantiation of ``name`` against its plain version on the knots
    of ``phase_case(name)``: every problem of ``shapes`` (lanes, trials,
    knots) after 1 and 3 iterations, shares of the first shape after
    ``iters``, the prologue, and times and bounds of the ``timed`` shapes.
    Returns (largest |Δz|, {(N, K): (kernel ms, plain ms, bound ms, bound
    by)})."""
    model, env, ref, kappa, opts, _ = phase_case(name)
    dims = dims_of(model, env)
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


def counted(path, steps, fn, solves=0):
    """Run ``fn``, ``steps`` sim steps and ``solves`` Newton solves of
    ``path``, with the knot kernel's and the sim kernel's launch counts and
    the sim and Newton graphs' counts (``sim.graphs.stats``,
    ``control.graphs.stats``) set to 0 just before and read just after:
    (result, knot launches, wall seconds). Every sim step's solve of the
    ``KERNEL_PATHS`` must be one launch of the sim kernel, and of every
    other path one graph replay; every Newton solve one replay of its
    graphs (the route ``"graphs"``; none eager). The counts go into
    ``GRAPHS[path]``, ``SIM_LAUNCHES[path]`` and ``NEWTON[path]``; the knot
    launches count the replays' and those of the Newton graphs' warm-ups
    (real launches, one set a rollout: ``warmup_launches``)."""
    torch.cuda.synchronize()
    knot_ip.launches = 0
    sim_mod.sim_ip.launches = 0
    structure_kkt.launches = ldl.launches = 0
    graphs.reset_stats()
    newton_graphs.reset_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    GRAPHS[path] = {"steps": steps, **graphs.stats}
    SIM_LAUNCHES[path] = sim_mod.sim_ip.launches
    NEWTON[path] = {"solves": solves, **newton_graphs.stats}
    KKT[path] = check_kkt_launches(path, solves)
    kernel = path in KERNEL_PATHS
    want = (steps, 0) if kernel else (0, steps)
    got = (sim_mod.sim_ip.launches, graphs.stats["replays"])
    assert got == want, (path, "sim kernel launches and graph replays", got,
                         want)
    got = (newton_graphs.stats["replays"], newton_graphs.stats["eager"])
    assert got == (solves, 0), (path, "Newton replays and eager solves", got,
                                solves)
    if solves:
        print(f"{path}: Newton route graphs, {solves} solves replayed "
              f"({newton_graphs.stats['trips']} trip replays), "
              f"{newton_graphs.stats['sets']} graph set(s) captured in "
              f"{newton_graphs.stats['warmup_s']:.3f} s of warm-up and "
              f"{newton_graphs.stats['capture_s']:.3f} s of capture, pool "
              f"{newton_graphs.stats['pool_bytes'] / 2 ** 20:.1f} MiB; knot "
              f"launches {knot_ip.launches}, of them "
              f"{newton_graphs.stats['warmup_launches']} in the warm-ups; KKT "
              f"kernel launches {json.dumps(KKT[path])}", flush=True)
    return out, knot_ip.launches, wall


def check_kkt_launches(path, solves):
    """The KKT kernels' launches of a counted run (``counted``): a
    structure-mode path launches ``csrc/structure_kkt.cu`` a whole number
    of times a Newton solve (once a masked trip) and no LDLᵀ; a direct-mode
    path ``csrc/ldl.cu`` once a trip replay, besides its graphs' warm-ups,
    and no structured solve; a path with no MPC neither."""
    warm = newton_graphs.stats["warmup_kkt_launches"]
    trips = newton_graphs.stats["trips"]
    counts = {"structure_kkt": structure_kkt.launches, "ldl": ldl.launches,
              "warmup": warm}
    if not solves:
        assert counts == {"structure_kkt": 0, "ldl": 0, "warmup": 0}, (
            path, counts)
    elif structure_kkt.launches:
        replayed = structure_kkt.launches - warm
        assert ldl.launches == trips == 0 and replayed > 0 and \
            replayed % solves == 0, (path, counts, trips, solves)
    else:
        assert ldl.launches - warm == trips > 0, (path, counts, trips)
    return counts


def sweep_stats_direct(res, ref, n_sample):
    """``MPCSweepStats``'s quantities computed from the lanes ``res`` on
    the host in float64, over every lane (the tracking errors and the
    residual over the lanes that converged every step)."""
    ok = res.sim_converged.all(dim=1).cpu().numpy()
    errs = [e.double().cpu().numpy() for e in tracking_errors(
        ref, res.q, res.u, res.gamma, res.b, n_sample, (0,))]
    n_ok = max(int(ok.sum()), 1)
    per_lane = lambda x: x.double().mean(dim=1).cpu().numpy()
    return {"n_rollouts": float(len(ok)), "success_rate": float(ok.mean()),
            **{k: float((e * ok).sum() / n_ok) for k, e in zip(
                ("q_err", "u_err", "gamma_err", "b_err"), errs)},
            "mean_newton_iters": float(per_lane(res.newton_iterations).mean()),
            "mean_sim_iters": float(per_lane(res.sim_iterations).mean()),
            "mean_r_norm": float((per_lane(res.mpc_r_norm) * ok).sum() / n_ok)}


def check_sweep(stats, res, ref, n_sample, path, tag):
    """The sweep's ``MPCSweepStats`` (float32 sums over the mesh) against
    the same quantities taken from its lanes: within 1e-6 of max(1, |x|)."""
    want = sweep_stats_direct(res, ref, n_sample)
    got = {k: float(v) for k, v in stats._asdict().items()}
    print(f"{path}: MPCSweepStats {json.dumps(got)}; from the lanes "
          f"{json.dumps(want)} {tag}", flush=True)
    assert got["n_rollouts"] == res.q.shape[0] == 16, got
    for k, x in want.items():
        assert abs(got[k] - x) <= 1e-6 * max(1.0, abs(x)), (k, got[k], x)


def plot_lanes(model, res, steps, path, tag):
    """``plot_runs_2d`` of the lanes (CUDA tensors) into a temporary PNG.
    Where matplotlib is not installed (the card's machine has none), the
    figure's geometry only: the skeletons it would draw, from the same
    CUDA tensors, finite and one set a drawn pose."""
    t0 = time.time()
    stride = max(1, steps // 8)
    if importlib.util.find_spec("matplotlib") is None:
        lines = runs_2d_lines(model, res.q, stride)
        poses = res.q.shape[0] * len(range(0, res.q.shape[1], stride))
        per_pose = len(skeleton_2d(model, res.q[0, 0]))
        print(f"{path}: matplotlib is not installed: no PNG; the "
              f"{len(lines)} skeleton lines plot_runs_2d draws for "
              f"{poses} poses of the {res.q.shape[0]} lanes in "
              f"{time.time() - t0:.2f} s {tag}", flush=True)
        assert len(lines) == per_pose * poses, (len(lines), poses)
        assert all(np.isfinite(line).all() for _, line in lines)
        return
    with tempfile.TemporaryDirectory() as tmp:
        png = plot_runs_2d(model, res.q, env=flat_2d_lc,
                           path=os.path.join(tmp, "runs.png"), stride=stride)
        size = os.path.getsize(png)
    print(f"{path}: plot_runs_2d of the {res.q.shape[0]} lanes, {size} bytes "
          f"in {time.time() - t0:.2f} s {tag}", flush=True)
    assert size > 0


def quadruped_path(path, cfg, steps, dev, tag, sweep=False):
    """A quadruped rollout through ``make_quadruped_rollout`` with the
    health checks of tests/test_hotpath.py; returns the launches. With
    ``sweep`` the rollout runs through ``parallel.make_sharded_mpc_rollouts``
    on ``make_mesh()`` (a process group of one rank, NCCL), its
    ``MPCSweepStats`` are held to the lanes', and the lanes are plotted."""
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

    if sweep:
        run = make_sharded_mpc_rollouts(make_mesh(), rollout, ref,
                                        cfg.n_sample)
        (res, stats), launches, wall = counted(
            path, steps, lambda: run(q1s, v1s), steps // cfg.n_sample)
    else:
        res, launches, wall = counted(path, steps,
                                      lambda: rollout(q1s, v1s),
                                      steps // cfg.n_sample)
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
    if sweep:
        check_sweep(stats, res, ref, cfg.n_sample, path, tag)
        plot_lanes(model, res, steps, path, tag)
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

    traj, launches, wall = counted("path B", steps, lambda: roll(steps),
                                   steps // n_sample)
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

    res, launches, wall = counted("path D", steps, lambda: roll(steps),
                                  steps // n_sample)
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
    return launches


def flamingo_options(kappa):
    """examples/flamingo_slope.py's knot options; float32 adaptive sim
    options (path D's); its Newton options with fixed 8-iteration knot
    solves (the kernel's form)."""
    mpc_ip = IPOptions(r_tol=1e-8, kappa_tol=kappa, max_iter=100,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                         undercut=float("inf"), max_ls=6, refine=1)
    return mpc_ip, sim_opts, NewtonOptions(r_tol=3e-4, max_iter=5,
                                           fixed_ip_iters=8)


def hopper3d_knot_options(kappa):
    """tests/test_mpc_hopper_3d.py's knot options (3D_flat.jl:73-80)."""
    return IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=100, undercut=5.0,
                     gamma_reg=0.1, diff_sol=True)


def phase_case(name, device="cuda", dtype=torch.float32):
    """What the kernel phase of the instantiation ``name`` compares on:
    (model, terrain, reference on ``device``, κ, knot options, K knots a
    path's horizon). A path's model takes the path's gait and options; a
    model no path runs its committed knot states (``PATHLESS``)."""
    pathless = {row[0]: row for row in PATHLESS}
    if name in pathless:
        _, env, _, _, h, _, k, kappa, _ = pathless[name]
        return (MODELS[name], env, states_ref(name, h, device, dtype), kappa,
                default_mpc_ip_options(kappa, max_iter=30), k)
    model = MODELS[name]

    def gait(env, gait_name, **kw):
        return from_gait(model, env, load_gait(name, gait_name), dtype=dtype,
                         device=device, **kw)

    if name == "quadruped":
        cfg = HotPathConfig()
        return (model, flat_2d_lc, gait(flat_2d_lc, "gait2",
                                         update_friction=True),
                cfg.kappa_mpc, cfg.mpc_ip_options(), cfg.h_mpc - 1)
    if name == "hopper_2D":
        return (model, flat_2d_lc, gait(flat_2d_lc, "gait_in_place",
                                        kappa=1.0e-4),
                1.0e-4, default_mpc_ip_options(1.0e-4), 10)
    if name == "centroidal_quadruped":
        return (model, flat_3d_lc, gait(flat_3d_lc, "inplace_trot_v2",
                                        update_friction=True),
                2.0e-4, centroidal_options(2.0e-4)[0], 10)
    if name == "flamingo":
        return (model, flat_2d_lc, gait(flat_2d_lc, "gait_forward_36_4"),
                2.0e-4, flamingo_options(2.0e-4)[0], 15)
    if name == "hopper_3D":
        return (model, flat_3d_lc, gait(flat_3d_lc, "gait_forward",
                                        kappa=1.0e-4),
                1.0e-4, hopper3d_knot_options(1.0e-4), 20)
    raise ValueError(f"no kernel phase for {name!r}")


def lanes_of(q1, v1, asset):
    """The 16 lanes of ``asset``: q1 + the committed offsets, v1 each."""
    with np.load(asset) as f:
        offsets = torch.as_tensor(f["offsets"], dtype=q1.dtype,
                                  device=q1.device)
    q1s = q1[None, :] + offsets
    return q1s, v1.expand_as(q1s).contiguous()


def flamingo_rollout(dev):
    """Path E's rollout, examples/flamingo_slope.py's configuration as
    tests/test_mpc_flamingo_slope.py checks it: (roll, ref, n_sample,
    sim_env, lanes) with ``roll(n_steps)`` the ``mpc_rollout`` (direct-mode
    Newton in configuration mode, the controller on flat_2d_lc, the physics
    on slope_smooth_2d_lc, altitude update at 0.02, warm-start floor 1e-2,
    fixed 8-iteration knot solves) of the 16 lanes of ``FLAMINGO_OFFSETS``.
    The sim solves are float32 adaptive ones (r_tol 1e-3, κ_tol 1e-5, 40
    iterations): the example's 1e-8 is out of float32's reach."""
    model, env, sim_env = flamingo, flat_2d_lc, slope_smooth_2d_lc
    dims = dims_of(model, env)
    dtype = torch.float32
    n_sample, h_mpc, kappa = 5, 15, 2.0e-4
    ref = from_gait(model, env, load_gait("flamingo", "gait_forward_36_4"),
                    dtype=dtype, device=dev)
    # slope.jl:31-36
    obj = tracking_velocity_objective(
        dims, h_mpc,
        v=1e-3 * np.array([1e0, 1, 1e4, 1, 1, 1, 1, 1e4, 1e4]),
        q=1e-1 * np.array([3e2, 1e-6, 3e2, 1, 1, 1, 1, 0.1, 0.1]),
        u=3e-1 * np.array([0.1, 0.1, 0.3, 0.3, 2.0, 2.0]),
        gamma=1e-100 * np.ones(dims.nc), b=1e-100 * np.ones(dims.nb),
        dtype=dtype, device=dev)
    mpc_ip, sim_opts, n_opts = flamingo_options(kappa)
    q1s, v1s = lanes_of(*initial_conditions(ref), FLAMINGO_OFFSETS)

    def roll(n_steps):
        return mpc_rollout(model, env, ref, obj, n_steps, h_mpc, n_sample,
                           kappa, CONFIGURATION, q1s, v1s, n_opts=n_opts,
                           ip_opts=mpc_ip, sim_opts=sim_opts,
                           warm_start_floor=1e-2,
                           mpc_opts=CIMPCOptions(
                               altitude_update=True,
                               altitude_impact_threshold=0.02),
                           sim_env=sim_env)

    return roll, ref, n_sample, sim_env, q1s.shape[0]


def hopper3d_rollout(dev):
    """Path F's rollout, tests/test_mpc_hopper_3d.py's configuration
    (examples/hopper3d_flat.py): (roll, ref, n_sample, lanes) with
    ``roll(n_steps)`` ``simulate`` driven by ``ci_mpc_policy`` (direct-mode
    Newton in configuration mode, gait_forward on flat_3d_lc, the test's
    knot options, altitude update at 0.05, fixed 8-iteration knot solves)
    of the 16 lanes of ``HOPPER3D_OFFSETS``. The sim solves are float32
    adaptive ones (r_tol 1e-3, κ_tol 1e-5, 40 iterations) with the test's
    line-search floor eps_min = 0.25."""
    model, env = hopper_3d, flat_3d_lc
    dims = dims_of(model, env)
    dtype = torch.float32
    n_sample, h_mpc, kappa = 10, 20, 1.0e-4
    ref = from_gait(model, env, load_gait("hopper_3D", "gait_forward"),
                    kappa=kappa, dtype=dtype, device=dev)
    # 3D_flat.jl:38-42
    obj = tracking_objective(
        dims, h_mpc, q=1e-1 * np.array([3, 3, 0.1, 50, 50, 50, 10]),
        u=np.array([0.1, 0.1, 10.0]), gamma=1e-100 * np.ones(dims.nc),
        b=1e-100 * np.ones(dims.nb), dtype=dtype, device=dev)
    mpc_ip = hopper3d_knot_options(kappa)
    policy = pt.ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, fixed_ip_iters=8),
        ip_opts=mpc_ip,
        mpc_opts=CIMPCOptions(altitude_update=True,
                              altitude_impact_threshold=0.05))
    sim_opts = dataclasses.replace(default_sim_options(), r_tol=1e-3,
                                   kappa_tol=1e-5, max_iter=40, eps_min=0.25)
    q1s, v1s = lanes_of(*initial_conditions(ref), HOPPER3D_OFFSETS)
    h_sim = float(ref.h) / n_sample

    def roll(n_steps):
        return pt.simulate(model, env, n_steps, h_sim, q1s, v1s,
                           policy=policy, opts=sim_opts)

    return roll, ref, n_sample, q1s.shape[0]


def flamingo_path(dev, tag, steps):
    """Path E: ``flamingo_rollout`` for ``steps`` sim steps with the health
    tests/test_mpc_flamingo_slope.py checks; returns the launches."""
    roll, ref, n_sample, sim_env, lanes = flamingo_rollout(dev)
    res, launches, wall = counted("path E", steps, lambda: roll(steps),
                                  steps // n_sample)
    check_outputs(res)
    assert launches >= steps // n_sample, launches
    ok = res.sim_converged.all(dim=1)
    dx = res.q[:, -1, 0] - res.q[:, 1, 0]
    clearance = (res.q[:, :, 1] - sim_env.surf(res.q[:, :, :1])).amin(dim=1)
    angle = res.q[:, 2:, 2].abs().amax(dim=1)
    print(f"path E (flamingo up the smooth slope, mpc_rollout direct): "
          f"{lanes} lanes x {steps} steps in {wall:.2f} s = "
          f"{lanes * steps / wall:.1f} lane-steps/s {tag}", flush=True)
    print(f"path E: lanes that converged every step {int(ok.sum())}/{lanes} "
          f"(JAX: {FLAMINGO_JAX_OK}/{lanes}), up the slope nominal "
          f"{float(dx[0]):.4f} / least {float(dx.min()):.4f}, torso "
          f"clearance nominal {float(clearance[0]):.4f} / least "
          f"{float(clearance.min()):.4f}, largest |torso angle| nominal "
          f"{float(angle[0]):.4f} / all {float(angle.max()):.4f}, mean "
          f"Newton iterations {float(res.newton_iterations.float().mean()):.3f}"
          f", mean sim iterations "
          f"{float(res.sim_iterations.float().mean()):.3f}, knot_ip launches "
          f"{launches} {tag}", flush=True)
    assert bool(ok[0]), "nominal lane sim failed"
    assert float(dx[0]) > 0.0, float(dx[0])
    assert float(clearance[0]) > 0.4, float(clearance[0])
    assert float(angle[0]) < 0.5, float(angle[0])
    assert int(ok.sum()) >= FLAMINGO_JAX_OK - 1, ok.tolist()
    return launches


def hopper3d_path(dev, tag, steps):
    """Path F: ``hopper3d_rollout`` for ``steps`` sim steps with the health
    of tests/test_mpc_hopper_3d.py's forward-travel check; returns the
    launches."""
    roll, ref, n_sample, lanes = hopper3d_rollout(dev)
    t0 = time.time()
    roll(n_sample)
    torch.cuda.synchronize()
    print(f"path F: warm-up (1 period) {time.time() - t0:.2f} s {tag}",
          flush=True)

    traj, launches, wall = counted("path F", steps, lambda: roll(steps),
                                   steps // n_sample)
    check_outputs(traj)
    assert launches >= steps // n_sample, launches
    ok = pt.status(traj)
    travel = traj.q[:, -1, 0] - traj.q[:, 1, 0]
    n_knots = steps // n_sample
    half_stride = 0.5 * float(ref.q[n_knots, 0] - ref.q[0, 0])
    errs = [float(e) for e in tracking_errors(
        ref, traj.q[0], traj.u[0], traj.gamma[0], traj.b[0], n_sample,
        idx_shift=(0,))]
    print(f"path F (hopper_3d, simulate + ci_mpc_policy direct): {lanes} "
          f"lanes x {steps} steps in {wall:.2f} s = "
          f"{lanes * steps / wall:.1f} lane-steps/s {tag}", flush=True)
    print(f"path F: lanes that converged every step {int(ok.sum())}/{lanes} "
          f"(JAX: {HOPPER3D_JAX_OK}/{lanes}), forward travel nominal "
          f"{float(travel[0]):.5f} (half the reference's stride "
          f"{half_stride:.5f}), lanes past it "
          f"{int((travel > half_stride).sum())}/{lanes}, nominal "
          f"q/u/gamma/b errors {errs}, mean sim iterations "
          f"{float(traj.iterations.float().mean()):.3f}, knot_ip launches "
          f"{launches} {tag}", flush=True)
    assert bool(ok[0]), "nominal lane sim failed"
    assert float(travel[0]) > half_stride, (float(travel[0]), half_stride)
    assert int(ok.sum()) >= HOPPER3D_JAX_OK - 1, ok.tolist()
    return launches


def stand_push_rollout(dev, model, gaits, offsets, force):
    """A quadruped of the centroidal family standing (``gaits``'s
    stand_v0 on flat_3d_lc) under a push over five sim steps, w[40:45] =
    ``force`` / 5: (roll, ref, n_sample, lanes) with ``roll(n_steps)`` the
    ``mpc_rollout`` (direct-mode Newton in configuration mode, the tests'
    knot options with fixed 8-iteration knot solves, a warm-start floor of
    1e-2) of the 16 lanes of ``offsets``. The sim solves are path D's
    float32 adaptive ones (r_tol 1e-3, κ_tol 1e-5, 40 iterations): the
    tests' 1e-8 is out of float32's reach. Paths I and K."""
    env = flat_3d_lc
    dims = dims_of(model, env)
    dtype = torch.float32
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4
    ref = from_gait(model, env, load_gait(gaits, "stand_v0"),
                    update_friction=True, dtype=dtype, device=dev)
    # flat_trot.jl:38-42, diagonalized (the tests' weights)
    v_w = 1e-3 * np.concatenate([np.ones(3), 1e3 * np.ones(3), np.ones(12)])
    q_body = np.array([1e-2, 1e-2, 1.0]) + 4.0 * np.array([0.2, 0.2, 1.0])
    q_w = np.concatenate([q_body, 0.3 * np.ones(3),
                          np.tile([0.2, 0.2, 1.0], 4)])
    obj = tracking_velocity_objective(dims, h_mpc, q=q_w, v=v_w,
                                      u=3e-3 * np.ones(dims.nu), dtype=dtype,
                                      device=dev)
    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=30,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    _, sim_opts, n_opts = centroidal_options(kappa)
    q1s, v1s = lanes_of(*initial_conditions(ref), offsets)

    def roll(n_steps):
        w = np.zeros((n_steps, dims.nw))
        w[40:45] = np.asarray(force) / 5.0
        return mpc_rollout(model, env, ref, obj, n_steps, h_mpc, n_sample,
                           kappa, CONFIGURATION, q1s, v1s, n_opts=n_opts,
                           ip_opts=mpc_ip, sim_opts=sim_opts,
                           warm_start_floor=1e-2, w=w)

    return roll, ref, n_sample, q1s.shape[0]


def point_foot_rollout(dev):
    """Path I's rollout: ``stand_push_rollout`` of the point-foot quadruped
    under tests/test_mpc_point_foot.py's lateral push (0, 5, 1) on the lanes
    of ``POINT_FOOT_OFFSETS``."""
    return stand_push_rollout(dev, point_foot_quadruped,
                              "point_foot_quadruped", POINT_FOOT_OFFSETS,
                              (0.0, 5.0, 1.0))


def point_foot_path(dev, tag):
    """Path I: ``point_foot_rollout`` for ``I_STEPS`` sim steps with
    tests/test_mpc_point_foot.py::test_point_foot_stand_push_recovery's
    three checks on the nominal lane (every step converged, the last
    configuration's height within 0.05 and lateral position within 0.1 of
    the reference's ``q[1]``); at most one lane fewer than the JAX
    package's converges every step; returns the launches."""
    roll, ref, n_sample, lanes = point_foot_rollout(dev)
    t0 = time.time()
    roll(n_sample)
    torch.cuda.synchronize()
    print(f"path I: warm-up (1 period) {time.time() - t0:.2f} s {tag}",
          flush=True)

    res, launches, wall = counted("path I", I_STEPS, lambda: roll(I_STEPS),
                                  I_STEPS // n_sample)
    check_outputs(res)
    ok = res.sim_converged.all(dim=1)
    q_end = res.q[:, -1]
    dz = (q_end[:, 2] - ref.q[1, 2]).abs()
    dy = (q_end[:, 1] - ref.q[1, 1]).abs()
    print(f"path I (point_foot_quadruped stand, lateral push, mpc_rollout "
          f"direct): {lanes} lanes x {I_STEPS} steps in {wall:.2f} s = "
          f"{lanes * I_STEPS / wall:.1f} lane-steps/s {tag}", flush=True)
    print(f"path I: lanes that converged every step {int(ok.sum())}/{lanes} "
          f"(JAX: {POINT_FOOT_JAX_OK}/{lanes}), nominal |height error| "
          f"{float(dz[0]):.5f} (< 0.05; JAX float32 0.00024), nominal "
          f"|lateral error| {float(dy[0]):.5f} (< 0.1; JAX float32 0.0725), "
          f"largest over the lanes {float(dz.max()):.5f} / "
          f"{float(dy.max()):.5f}, mean Newton iterations "
          f"{float(res.newton_iterations.float().mean()):.3f}, mean sim "
          f"iterations {float(res.sim_iterations.float().mean()):.3f}, "
          f"knot_ip launches {launches} {tag}", flush=True)
    assert launches >= I_STEPS // n_sample, launches
    assert bool(ok[0]), "nominal lane sim failed"
    assert float(dz[0]) < 0.05, float(dz[0])
    assert float(dy[0]) < 0.1, float(dy[0])
    assert int(ok.sum()) >= POINT_FOOT_JAX_OK - 1, ok.tolist()
    return launches


def box_rollout(dev):
    """Path K's rollout: ``stand_push_rollout`` of the box variant beside
    its step under tests/test_mpc_box.py's push toward it (3, 0, 0) on the
    lanes of ``BOX_OFFSETS``."""
    return stand_push_rollout(dev, MODELS["centroidal_quadruped_box"],
                              "centroidal_quadruped", BOX_OFFSETS,
                              (3.0, 0.0, 0.0))


def box_gaps(res):
    """Each lane's lowest foot height above the box surface
    (``model.elevation``) over the rollout, (B,)."""
    feet = res.q[:, :, 6:].reshape(res.q.shape[0], -1, 4, 3)
    model = MODELS["centroidal_quadruped_box"]
    return (feet[..., 2] - model.elevation(feet[..., 0])).flatten(1).amin(1)


def box_path(dev, tag):
    """Path K: ``box_rollout`` for ``K_STEPS`` sim steps with
    tests/test_mpc_box.py::test_box_stand_mpc_push's checks on the nominal
    lane (every step converged, q tracking error < 0.05, the lowest foot
    gap to the box surface > ``BOX_GAP_BOUND``); at most one lane fewer
    than the JAX package's converges every step; returns the launches."""
    roll, ref, n_sample, lanes = box_rollout(dev)
    t0 = time.time()
    roll(n_sample)
    torch.cuda.synchronize()
    print(f"path K: warm-up (1 period) {time.time() - t0:.2f} s {tag}",
          flush=True)

    res, launches, wall = counted("path K", K_STEPS, lambda: roll(K_STEPS),
                                  K_STEPS // n_sample)
    check_outputs(res)
    ok = res.sim_converged.all(dim=1)
    q_err = tracking_errors(ref, res.q, res.u, res.gamma, res.b, n_sample)[0]
    gaps = box_gaps(res)
    print(f"path K (centroidal_quadruped_box stand, push toward the step, "
          f"mpc_rollout direct): {lanes} lanes x {K_STEPS} steps in "
          f"{wall:.2f} s = {lanes * K_STEPS / wall:.1f} lane-steps/s {tag}",
          flush=True)
    print(f"path K: lanes that converged every step {int(ok.sum())}/{lanes} "
          f"(JAX: {BOX_JAX_OK}/{lanes}), nominal q error "
          f"{float(q_err[0]):.5f} (< 0.05; JAX float32 {BOX_JAX_Q_ERR}), "
          f"nominal lowest foot gap {float(gaps[0]):+.3e} (> "
          f"{BOX_GAP_BOUND:.0e}; JAX float32 {BOX_JAX_GAP:+.3e}), largest q "
          f"error over the lanes {float(q_err.max()):.5f}, lowest gap "
          f"{float(gaps.min()):+.3e}, mean Newton iterations "
          f"{float(res.newton_iterations.float().mean()):.3f}, mean sim "
          f"iterations {float(res.sim_iterations.float().mean()):.3f}, "
          f"knot_ip launches {launches} {tag}", flush=True)
    assert launches >= K_STEPS // n_sample, launches
    assert bool(ok[0]), "nominal lane sim failed"
    assert float(q_err[0]) < 0.05, float(q_err[0])
    assert float(gaps[0]) > BOX_GAP_BOUND, float(gaps[0])
    assert int(ok.sum()) >= BOX_JAX_OK - 1, ok.tolist()
    return launches


def particle_lanes(dev):
    """tests/test_parallel.py's 16 lanes of the 2D particle, float64: x
    spread over [−1, 1] at height 1, at rest."""
    xs = torch.linspace(-1.0, 1.0, 16, dtype=torch.float64, device=dev)
    return torch.stack([xs, torch.ones_like(xs)], dim=1), \
        torch.zeros((16, 2), dtype=torch.float64, device=dev)


def sweep_worker():
    """One rank of phase J (``chip_smoke.py --sweep-worker`` with the
    CIMPC_* variables set): join the gloo group on the card, run
    ``sharded_rollout_stats`` of the particle's lanes and print them as one
    JSON line."""
    assert distributed.initialize(device="cuda", backend="gloo")
    mesh = make_mesh()
    q1, v1 = particle_lanes(torch.device("cuda"))
    stats = sharded_rollout_stats(mesh, particle_2d, flat_2d_lc, 30, 0.01,
                                  q1, v1)
    assert stats.mean_final_q.is_cuda
    print(json.dumps({"rank": torch.distributed.get_rank(),
                      "mesh": list(mesh.shape),
                      **{k: v.tolist() for k, v in stats._asdict().items()}}),
          flush=True)
    torch.distributed.destroy_process_group()


def two_process_phase(dev, tag):
    """Phase J: two processes share the card, joined by gloo (NCCL refuses
    two ranks on one GPU), and run ``sharded_rollout_stats`` on the 2D
    particle (16 lanes, 30 steps of 0.01, float64), held to
    ``monte_carlo_rollouts`` of the same lanes here: 16 rollouts, every
    one a success, the mean final q within 1e-10. A worker's failure fails
    the phase."""
    t0 = time.time()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in (
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
        env.update(CIMPC_COORDINATOR=f"127.0.0.1:{port}",
                   CIMPC_NUM_PROCESSES="2", CIMPC_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sweep-worker"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"phase J rank {rank} failed:\n{text}"
    got = [json.loads(next(line for line in text.splitlines()
                           if line.startswith('{"rank"'))) for text in outs]
    local = monte_carlo_rollouts(particle_2d, flat_2d_lc, 30, 0.01,
                                 *particle_lanes(dev))
    want = local.q[:, -1].mean(dim=0).cpu().numpy()
    wall = time.time() - t0
    err = max(float(np.abs(np.asarray(g["mean_final_q"]) - want).max())
              for g in got)
    print(f"phase J (2 processes on the card, gloo, sharded_rollout_stats of "
          f"the 2D particle, 16 lanes x 30 steps, float64): meshes "
          f"{[g['mesh'] for g in got]}, n_rollouts "
          f"{[g['n_rollouts'] for g in got]}, success "
          f"{[g['success_rate'] for g in got]}, mean final q "
          f"{got[0]['mean_final_q']} against one process {want.tolist()} "
          f"(largest difference {err:.3g}), in {wall:.2f} s {tag}",
          flush=True)
    for g in got:
        assert g["mesh"] == [2, 1], g
        assert g["n_rollouts"] == 16.0 and g["success_rate"] == 1.0, g
    assert bool(local.converged.all())
    assert err < 1e-10, err
    return wall


def cone_path(dev, tag):
    """Path G: the 3D particle on flat_3d_nc (the nonlinear friction cone)
    through ``simulate`` with tests/test_nonlinear_cone.py's default
    options, float64, 16 lanes × 150 steps of 0.01 from height 1. Lane 0 is
    that test's slide at v = (1, 2, 0); lanes 1-15 slide at horizontal
    velocities of |v| ≤ 2 from numpy.random.default_rng(7). Every step of
    every lane converges; each lane comes to rest on the ground (height
    within 1e-6, the last step's velocity within 1e-5), and the isotropic
    cone keeps each slide on its line: the end point lies within 1e-3 of
    its scale of the line along the lane's velocity."""
    f64 = torch.float64
    rng = np.random.default_rng(7)
    speed, heading = rng.uniform(0.0, 2.0, 15), rng.uniform(0, 2 * np.pi, 15)
    vxy = np.concatenate([[[1.0, 2.0]], np.stack(
        [speed * np.cos(heading), speed * np.sin(heading)], axis=1)])
    v1 = torch.tensor(np.concatenate([vxy, np.zeros((16, 1))], axis=1),
                      dtype=f64, device=dev)
    q1 = torch.tensor([[0.0, 0.0, 1.0]] * 16, dtype=f64, device=dev)
    steps, h = 150, 0.01
    traj, _, wall = counted("path G", steps, lambda: pt.simulate(
        particle, flat_3d_nc, steps, h, q1, v1))
    check_outputs(traj)
    q_end, v_end = traj.q[:, -1], (traj.q[:, -1] - traj.q[:, -2]) / h
    vn = torch.as_tensor(vxy, dtype=f64, device=dev)
    off_line = (q_end[:, 0] * vn[:, 1] - q_end[:, 1] * vn[:, 0]).abs() / \
        vn.norm(dim=1)
    scale = torch.clamp(q_end[:, :2].norm(dim=1), min=1.0)
    print(f"path G (particle on flat_3d_nc, simulate, float64): 16 lanes x "
          f"{steps} steps in {wall:.2f} s, steps converged "
          f"{int(traj.converged.sum())}/{traj.converged.numel()}, mean sim "
          f"iterations {float(traj.iterations.float().mean()):.3f}, largest "
          f"|height| at the end {float(q_end[:, 2].abs().max()):.3g}, "
          f"largest end speed {float(v_end.abs().max()):.3g}, largest "
          f"distance from the slide's line {float(off_line.max()):.3g}, "
          f"nominal end point {q_end[0].tolist()} {tag}", flush=True)
    assert bool(traj.converged.all()), traj.converged.all(dim=1).tolist()
    assert float(q_end[:, 2].abs().max()) < 1e-6
    assert float(v_end.abs().max()) < 1e-5
    assert bool((off_line < 1e-3 * scale).all()), off_line.tolist()
    assert abs(float(q_end[0, 0]) * 2.0 - float(q_end[0, 1])) < 1e-3
    return wall


def raibert_path(dev, tag):
    """Path H: ``raibert_policy`` on the 2D hopper through ``simulate`` with
    tests/test_raibert.py's options (h_sim 0.02, v0 0.2, r_tol and κ_tol
    1e-8, 100 iterations, 25 halvings), float64, 16 lanes × 100 steps. Lane
    0 is that test's q1 = [0, 0.5, 0, 0.5]; lanes 1-15 add 0.02 ·
    uniform(−1, 1) from numpy.random.default_rng(8). Every step of every
    lane converges, and lane 0 lands and takes off again. Then one
    ``reference_gains`` for the hopper's in-place gait (tests/test_gains.py)
    on the card, held to the same call on CPU tensors to 1e-8."""
    f64 = torch.float64
    h = 0.02
    offsets = 0.02 * np.random.default_rng(8).uniform(-1.0, 1.0, (15, 4))
    q1 = torch.tensor(np.concatenate([np.zeros((1, 4)), offsets])
                      + [0.0, 0.5, 0.0, 0.5], dtype=f64, device=dev)
    opts = IPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=100,
                     undercut=float("inf"), max_ls=25)
    traj, _, wall = counted("path H", 100, lambda: pt.simulate(
        hopper_2d, flat_2d_lc, 100, h, q1, torch.zeros_like(q1),
        policy=raibert_policy(hopper_2d, h=h, v0=0.2), opts=opts))
    check_outputs(traj)
    gamma0 = traj.gamma[0, :, 0]
    landed = gamma0 > 1.5e-2
    took_off = bool(landed.any()) and bool(
        (gamma0[int(landed.nonzero()[0, 0]):] < 1.5e-3).any())
    print(f"path H (hopper_2D raibert_policy, simulate, float64): 16 lanes x "
          f"100 steps in {wall:.2f} s, steps converged "
          f"{int(traj.converged.sum())}/{traj.converged.numel()}, mean sim "
          f"iterations {float(traj.iterations.float().mean()):.3f}, lane 0 "
          f"in contact on {int(landed.sum())} steps and takes off after "
          f"landing: {took_off}, x travelled nominal "
          f"{float(traj.q[0, -1, 0] - traj.q[0, 1, 0]):.4f} {tag}",
          flush=True)
    assert bool(traj.converged.all()), traj.converged.all(dim=1).tolist()
    assert took_off

    gait = load_gait("hopper_2D", "gait_in_place")
    dims = dims_of(hopper_2d, flat_2d_lc)
    gains = {}
    t1 = time.time()
    for d in (dev, torch.device("cpu")):
        ref = from_gait(hopper_2d, flat_2d_lc, gait, kappa=1e-4, device=d)
        obj = tracking_velocity_objective(
            dims, ref.horizon,
            q=np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (ref.horizon, 1)),
            v=np.tile(1e-3 * np.ones(4), (ref.horizon, 1)),
            u=np.tile(np.array([3e-3, 1.0]), (ref.horizon, 1)), device=d)
        gains[d.type] = reference_gains(hopper_2d, flat_2d_lc, ref, obj,
                                        periods=3)
        if d.type == "cuda":
            torch.cuda.synchronize()
            t_card = time.time() - t1
    assert gains["cuda"].is_cuda
    err = float((gains["cuda"].cpu() - gains["cpu"]).abs().max())
    print(f"path H: reference_gains (hopper_2D gait_in_place, 3 periods) on "
          f"the card in {t_card:.2f} s, {tuple(gains['cuda'].shape)}, "
          f"largest |gain| {float(gains['cpu'].abs().max()):.4g}, against "
          f"CPU tensors {err:.3g} {tag}", flush=True)
    assert err < 1e-8, err
    return wall


def sim_step_problem(dev, name, dtype):
    """One sim step of 16 lanes of a path's model: (model, terrain, z0, θ,
    options). ``Q``: the quadruped at tests/test_hotpath.py's lanes on the
    piecewise slope (piecewise1_2d_lc, a terrain the sim kernel does not
    take) with the hot path's sim options (24 fixed iterations, float32);
    ``B``:
    the 2D hopper at path B's lanes with its adaptive float32 options;
    ``G``: the 3D particle on flat_3d_nc at path G's slide velocities, 0.02
    above the ground and falling at 1, with the simulator's defaults
    (adaptive, 25 halvings, the dense LU; float64). The controls are
    0.1 · N(0, 1) from numpy.random.default_rng(11)."""
    rng = np.random.default_rng(11)
    kw = dict(dtype=dtype, device=dev)
    if name == "Q":
        cfg = HotPathConfig()
        _, ref, model, _, dims = make_quadruped_rollout(cfg, 5, dtype,
                                                        device=dev)
        env = pt.piecewise1_2d_lc
        q1, v1 = conf_initial_states(model, ref)
        h, opts = float(ref.h) / cfg.n_sample, cfg.sim_ip_options()
    elif name == "B":
        _, ref, n_sample, _ = hopper_rollout(dev)
        model, env = hopper_2d, flat_2d_lc
        dims = dims_of(model, env)
        q1, v1 = initial_conditions(ref)
        with np.load(HOPPER_OFFSETS) as f:
            q1 = q1[None] + torch.as_tensor(f["offsets"], **kw)
        v1 = v1.expand_as(q1)
        h = float(ref.h) / n_sample
        opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                         undercut=float("inf"), max_ls=6)
    else:
        model, env = particle, flat_3d_nc
        dims = dims_of(model, env)
        speed, heading = (rng.uniform(0.0, 2.0, 16),
                          rng.uniform(0, 2 * np.pi, 16))
        v1 = torch.as_tensor(np.stack([speed * np.cos(heading),
                                       speed * np.sin(heading),
                                       -np.ones(16)], axis=1), **kw)
        q1 = torch.tensor([[0.0, 0.0, 0.02]] * 16, **kw)
        h, opts = 0.01, default_sim_options()
    u = torch.as_tensor(0.1 * rng.standard_normal((16, dims.nu)), **kw)
    theta = pack_theta(q1 - h * v1, q1, u, torch.zeros((16, dims.nw), **kw),
                       model.mu_world, h)
    z0 = z_initialize(dims, q1, cone=env.cone)
    return model, env, z0, theta, opts


def graph_phase(dev, tag):
    """The sim solve's replayed graphs against its eager body
    (``SimSolve._eager``, ``ip_solve``) on the card: one sim step each of
    the quadruped's solve on the piecewise slope (24 fixed iterations,
    float32; on flat ground the sim kernel takes it), path B's (adaptive,
    float32) and path G's (the nonlinear cone's dense LU, float64), and a
    20-step ``simulate`` of path B's rollout, its sim steps run both ways.
    Every output agrees bit for bit: the graphs replay the same kernels on
    the same inputs, and the dense LU takes the same cuSOLVER/cuBLAS
    routines eagerly as under capture
    (``interior_point._capturable_linalg``)."""
    def equal(name, got, want):
        diff = {k: (bool(torch.equal(a, b)) if a is not None else None)
                for k, a, b in zip(got._fields, got, want)}
        assert all(v is not False for v in diff.values()), (name, diff)

    for name, dtype in (("Q", torch.float32), ("B", torch.float32),
                        ("G", torch.float64)):
        model, env, z0, theta, opts = sim_step_problem(dev, name, dtype)
        solve = SimSolve(model, env, opts)
        assert solve.route(z0) == "graphs", name
        graphs.reset_stats()
        got = solve(z0, theta)
        stats = dict(graphs.stats)
        step_graph = cuda_ms(lambda: solve(z0, theta), 10)
        step_eager = cuda_ms(lambda: solve._eager(z0, theta), 2)
        want = solve._eager(z0, theta)
        equal(name, got, want)
        print(f"graphs: {'the quadruped on the piecewise slope' if name == 'Q' else 'path ' + name}'s sim step (16 lanes, {dtype}, "
              f"{'fixed ' + str(opts.fixed_iters) if opts.fixed_iters else 'adaptive'}"
              f" iterations; mean {float(got.iterations.float().mean()):.3f}, "
              f"{int(got.converged.sum())}/16 converged) replayed = eager "
              f"bit for bit; {step_graph:.3f} ms replayed against "
              f"{step_eager:.3f} ms eager; warm-up {stats['warmup_s']:.3f} s,"
              f" capture and instantiation {stats['capture_s']:.3f} s, pool "
              f"{stats['pool_bytes'] / 2 ** 20:.1f} MiB {tag}", flush=True)

    roll, _, _, _ = hopper_rollout(dev)
    t0 = time.time()
    got = roll(20)
    torch.cuda.synchronize()
    t1 = time.time()
    with mock.patch.object(SimSolve, "_graphed", SimSolve._eager):
        want = roll(20)
        torch.cuda.synchronize()
    t2 = time.time()
    equal("simulate", got, want)
    print(f"graphs: path B's simulate, 16 lanes x 20 steps, replayed = "
          f"eager bit for bit; {t1 - t0:.2f} s replayed (captures included) "
          f"against {t2 - t1:.2f} s eager {tag}", flush=True)


def newton_phase(dev, tag):
    """The Newton solve's replayed CUDA graphs (``control/graphs.py``)
    against its eager route (``NewtonSolve._eager``) on the card: the second
    Newton solve of a two-period run of path A (structure mode, one graph a
    solve), path C (direct, n = 300) and path D (direct, n = 480), solved
    again by a fresh ``NewtonSolve``, with the replay's and the eager
    route's times (CUDA events), the set's warm-up and capture seconds and
    pool memory, and the knot kernel's and the KKT kernels' launches of one
    solve each way; then a 20-step rollout of path A with its Newton solves
    run both ways (``mock.patch``, as the graph phase does for B's sim
    steps). Every output agrees bit for bit, and the launches through
    replays equal the eager route's (the rollout's less its set's
    warm-up)."""
    sys.path.insert(0, TESTS)
    import test_torch_newton_graphs_cuda as newton_tests

    def launches_of(fn):
        """(knot kernel, KKT kernels) launches of ``fn()``."""
        torch.cuda.synchronize()
        knot_ip.launches = structure_kkt.launches = ldl.launches = 0
        fn()
        torch.cuda.synchronize()
        return knot_ip.launches, newton_graphs.kkt_launches()

    calls = {"A": lambda: newton_tests.path_call("A", dev),
             "C": lambda: newton_tests.path_call("C", dev),
             "D": lambda: newton_tests.recorded_call(
                 lambda: centroidal_rollout(dev)[0](10))}
    for name, record in calls.items():
        solve, args = record()
        assert solve.route(args[-1]) == "graphs", name
        newton_graphs.reset_stats()
        got = solve(*args)
        torch.cuda.synchronize()
        stats = dict(newton_graphs.stats)
        replayed = cuda_ms(lambda: solve(*args), 5)
        eager = cuda_ms(lambda: solve._eager(*args), 2)
        want = solve._eager(*args)
        same = newton_tests.equal(got, want)
        counts = (launches_of(lambda: solve(*args)),
                  launches_of(lambda: solve._eager(*args)))
        kind = ("structure" if solve.structure else
                f"direct, n = {solve.assembler.ind.ntot}")
        print(f"newton: path {name}'s solve (16 lanes, float32, {kind}; "
              f"iterations {want.iterations.tolist()}) replayed = eager bit "
              f"for bit: {all(same)}; {replayed:.3f} ms replayed against "
              f"{eager:.3f} ms eager; warm-up {stats['warmup_s']:.3f} s, "
              f"capture and instantiation {stats['capture_s']:.3f} s, pool "
              f"{stats['pool_bytes'] / 2 ** 20:.1f} MiB; trip replays "
              f"{stats['trips']}; knot and KKT kernel launches replayed / "
              f"eager {counts} {tag}", flush=True)
        assert all(same), (name, same)
        assert counts[0] == counts[1] and min(counts[0]) > 0, (name, counts)

    cfg = HotPathConfig()
    roll, ref, model, _, _ = make_quadruped_rollout(cfg, 20, torch.float32,
                                                    device=dev)
    q1s, v1s = conf_initial_states(model, ref)
    t0 = time.time()
    newton_graphs.reset_stats()
    n_graphs, kkt_graphs = launches_of(lambda: roll(q1s, v1s))
    warm = newton_graphs.stats["warmup_launches"]
    kkt_warm = newton_graphs.stats["warmup_kkt_launches"]
    got = roll(q1s, v1s)
    torch.cuda.synchronize()
    t1 = time.time()
    with mock.patch.object(NewtonSolve, "_graphed", NewtonSolve._eager):
        n_eager, kkt_eager = launches_of(lambda: roll(q1s, v1s))
        want = roll(q1s, v1s)
        torch.cuda.synchronize()
    t2 = time.time()
    same = newton_tests.equal(got, want)
    print(f"newton: path A's rollout, 16 lanes x 20 steps, Newton replayed "
          f"= eager bit for bit: {all(same)}; knot launches {n_graphs} "
          f"replayed ({warm} of them the set's warm-up) against {n_eager} "
          f"eager, KKT kernel launches {kkt_graphs} ({kkt_warm}) against "
          f"{kkt_eager}; two rollouts each way in {t1 - t0:.2f} s replayed "
          f"(captures included) against {t2 - t1:.2f} s eager {tag}",
          flush=True)
    assert all(same), same
    assert n_graphs - warm == n_eager > 0, (n_graphs, warm, n_eager)
    assert kkt_graphs - kkt_warm == kkt_eager > 0, (kkt_graphs, kkt_warm,
                                                    kkt_eager)


def sim_kernel_phase(dev, tag):
    """Phase S: the sim kernel against its plain version (the replayed
    graphs of ``ip_program``) on every sim step of a plain run of path A,
    float64 and float32, then a sim step's time (the module's docstring);
    returns the kernel's largest float64 |Δz| and its time, the graph
    replay's and its bound for a sim step of path A's 16 lanes."""
    sys.path.insert(0, TESTS)
    import test_torch_sim_ip_cuda as sim_tests
    t0 = time.time()
    z32, th32 = sim_tests.record_states(dev)
    print(f"phase S: the {z32.shape[0]} sim steps of a plain run of path A "
          f"(16 lanes x {sim_tests.STEPS} steps) recorded in "
          f"{time.time() - t0:.2f} s {tag}", flush=True)
    err = 0.0
    for name, opts in sim_tests.OPTIONS.items():
        got, want = sim_tests.both(quadruped, z32.double(), th32.double(),
                                   opts)
        same, gap = sim_tests.f64_gaps(got, want)
        print(f"phase S: float64, {name} options: converged "
              f"{int(got.converged.sum())} / {int(want.converged.sum())} "
              f"(kernel / plain), flags equal {same}, largest |dz| over the "
              f"converged {gap:.3g}, iterations "
              f"{float(got.iterations.float().mean()):.3f} / "
              f"{float(want.iterations.float().mean()):.3f} {tag}",
              flush=True)
        assert same and gap <= sim_tests.F64_Z, (name, same, gap)
        err = max(err, gap)
    for name in ("hot_path", "phase_L"):
        got, want = sim_tests.both(quadruped, z32, th32,
                                   sim_tests.OPTIONS[name])
        spread = sim_tests.f32_spread(got, want,
                                      sim_tests.F32_LIMITS["z_tol"])
        print(f"phase S: float32, {name} options: {json.dumps(spread)} "
              f"against the limits {json.dumps(sim_tests.F32_LIMITS)}, "
              f"converged {int(got.converged.sum())} / "
              f"{int(want.converged.sum())} {tag}", flush=True)
        sim_tests.check_f32(got, want)
    for r in cuda_build.resources(sim_mod.build()):
        print(f"phase S: ptxas, {r['kernel']}: {r.get('registers')} "
              f"registers, {r['spill_stores']} bytes of spill stores, "
              f"{r['spill_loads']} of spill loads a thread {tag}", flush=True)
    times = {}
    for lanes, name in ((16, "hot_path"), (1, "hot_path"), (1, "phase_L")):
        opts = sim_tests.OPTIONS[name]
        z0, theta = z32[:lanes].contiguous(), th32[:lanes].contiguous()
        solve = SimSolve(quadruped, flat_2d_lc, opts)
        kernel = cuda_ms(lambda: solve(z0, theta), 20, spin=True)
        plain = cuda_ms(lambda: solve._graphed(z0, theta), 5)
        iters = solve(z0, theta).iterations
        trips, slowest = int(iters.sum()), int(iters.max())
        bound, by = sim_mod.bound_ms(lanes, trips, opts, 4)
        dual, _ = sim_mod.bound_ms(lanes, trips, opts, 4, jacobian="dual")
        times[lanes, name] = (kernel, plain, bound, by)
        print(f"phase S: a sim step of {lanes} lane(s), float32, {name} "
              f"options ({trips} trips in all, the slowest problem "
              f"{slowest}): kernel {kernel:.4f} ms, "
              f"{1e3 * kernel / slowest:.2f} us a trip, graph replay "
              f"{plain:.4f} ms, bound {bound:.7f} ms "
              f"({by}), {bound / kernel:.3%} of it (the dual-number "
              f"Jacobian's count: {dual:.7f} ms, {dual / kernel:.3%}) {tag}",
              flush=True)
        print(json.dumps({"sim_ip_bound": {
            "lanes": lanes, "options": name, "trips": trips,
            "slowest_trips": slowest, "ms": kernel,
            "us_a_trip": 1e3 * kernel / slowest, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "bound_ms_dual_count": dual,
            "card": tag[1:-1]}}), flush=True)
    kernel, plain, bound, by = times[16, "hot_path"]
    return {"max_abs_err": err, "ms": kernel, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by}


def dense_tridiag(yii, yij):
    """The block-tridiagonal Y of ``compute_y_blocks``' blocks as a dense
    (..., T·n, T·n) matrix."""
    t, n = yii.shape[-3], yii.shape[-1]
    dense = yii.new_zeros(yii.shape[:-3] + (t * n, t * n))
    for i in range(t):
        dense[..., i * n:(i + 1) * n, i * n:(i + 1) * n] = yii[..., i, :, :]
        if i + 1 < t:
            dense[..., i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n] = \
                yij[..., i, :, :]
            dense[..., (i + 1) * n:(i + 2) * n, i * n:(i + 1) * n] = \
                yij[..., i, :, :].mT
    return dense


def kkt_phase(dev, tag):
    """Phase kkt: the Newton's two KKT kernels against their plain versions
    on the paths' own first KKTs (tests/test_torch_kkt_cuda.py's
    ``structure_case`` and ``ldl_case``: the first KKT a path's run solves,
    recorded where its Newton solve calls the wrapper): the structured solve
    (``csrc/structure_kkt.cu``) on path A's (16 lanes, nq 11, nu 8, H 10)
    and the structure-mode hopper's (tests/test_torch_contracts_cuda.py's
    ``"structure"``), the LDLᵀ (``csrc/ldl.cu``) on paths B, C, D, E and F's
    (n = 100, 300, 480, 360, 340; 16 lanes). Float64 (the float32 KKT cast
    up) within 1e-9 of the plain version's largest entry; float32 with a
    relative residual no worse than twice the plain version's; the LDLᵀ's
    factor (L, d) equal to the plain ``ldl_factor``'s bit for bit in both
    types (what holds its float32 build on E, whose float32 KKT neither
    version solves to any accuracy). Then each
    kernel's time at the path's shape in float32 against its plain version
    and one library call (CUDA events): for the structured solve
    ``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve`` of the dense Y
    (16, 198, 198) at A; for the LDLᵀ ``torch.linalg.ldl_factor_ex`` +
    ``torch.linalg.ldl_solve`` (pivoted); its bound
    (``ops/structure_kkt.py``/``ops/ldl.py::bound_ms``), ptxas's registers
    and spills, the LDLᵀ's cluster geometry at every path's n in both types
    with how many such clusters the card runs at once
    (``cudaOccupancyMaxActiveClusters``), and the structured solve's chunk
    of stages at A's and the hopper's shapes. Returns the two kernels'
    entries for the JSON line (the structured solve at A, the LDLᵀ at C's
    n = 300)."""
    sys.path.insert(0, TESTS)
    import test_torch_kkt_cuda as kkt_tests
    for mod in (sk_mod, ldl_mod):
        for r in cuda_build.resources(mod.build()):
            print(f"kkt: ptxas, {r['kernel']}: {r.get('registers')} "
                  f"registers, {r['spill_stores']} bytes of spill stores, "
                  f"{r['spill_loads']} of spill loads a thread {tag}",
                  flush=True)
    for n in (100, 300, 340, 360, 480):
        for elem in (4, 8):
            g = ldl_mod.geometry(n, elem)
            print(f"kkt: ldl geometry at n = {n}, {elem}-byte values: "
                  f"clusters of {g['cluster']} CTAs of {g['threads']} "
                  f"threads, {g['rows']} rows and {g['shared_bytes']} shared "
                  f"bytes a CTA; the card runs "
                  f"{ldl_mod.max_active_clusters(n, elem)} such clusters at "
                  f"once {tag}", flush=True)
    for nq, nu in ((11, 8), (4, 2)):
        for elem in (4, 8):
            print(f"kkt: structure_kkt at nq {nq}, nu {nu}, H 10, {elem}-byte "
                  f"values: chunks of {sk_mod.chunk_stages(nq, nu, 10, elem)} "
                  f"of 9 stages, {sk_mod.shared_bytes(nq, nu, 10, elem)} "
                  f"shared bytes a block {tag}", flush=True)
    rows, errs = [], {"structure_kkt": 0.0, "ldl": 0.0}
    for path in ("A", "hopper_structure"):
        dims, obj, xs, beta, h = kkt_tests.structure_case(path, dev)
        obj64, xs64 = kkt_tests.cast(obj, xs, torch.float64)
        got = structure_kkt(dims, obj64, *xs64, beta, h)
        want = ss.structure_kkt_solve(dims, obj64, *xs64, beta, h)
        rel = kkt_tests.rel(got, want)
        gap = max(float((g - w).abs().max()) for g, w in zip(got, want))
        res = [kkt_tests.reduced_residual(dims, obj, xs, beta, h, fn(
            dims, obj, *xs, beta, h)) for fn in (structure_kkt,
                                                 ss.structure_kkt_solve)]
        lanes = xs[0].shape[0]
        print(f"kkt: structure_kkt on {path}'s first KKT ({lanes} lanes, nq "
              f"{dims.nq}, nu {dims.nu}, H {h}): float64 largest |diff| "
              f"{gap:.3g} ({rel:.3g} of the largest entry), float32 reduced "
              f"residual {res[0]:.3g} against the plain version's "
              f"{res[1]:.3g} {tag}", flush=True)
        assert rel <= kkt_tests.F64_REL, (path, rel)
        assert res[0] <= kkt_tests.F32_RESIDUAL_RATIO * res[1], (path, res)
        errs["structure_kkt"] = max(errs["structure_kkt"], gap)
        if path != "A":
            continue
        kernel = cuda_ms(lambda: structure_kkt(dims, obj, *xs, beta, h), 50,
                         spin=True)
        plain = cuda_ms(lambda: ss.structure_kkt_solve(dims, obj, *xs, beta,
                                                       h), 5)
        yii, yij = ss.compute_y_blocks(obj, *xs[:3], beta, h)
        dense = dense_tridiag(yii, yij)
        rhs = ss.structure_beta(obj, *xs, h).flatten(-2)[..., None]
        library = cuda_ms(lambda: torch.cholesky_solve(
            rhs, torch.linalg.cholesky_ex(dense)[0]), 20, spin=True)
        bound, by = sk_mod.bound_ms(dims.nq, dims.nu, h, lanes, 4)
        rows.append({"kernel": "structure_kkt", "path": path,
                     "shape": [lanes, h, dims.nq, dims.nu],
                     "dense_y": list(dense.shape), "ms": kernel,
                     "plain_ms": plain, "library_ms": library,
                     "bound_ms": bound, "bound_by": by})
    for path in "BCDEF":
        a, b = kkt_tests.ldl_case(path, dev)
        a64, b64 = a.double(), b.double()
        got, want = ldl(a64, b64), ldl_solve(a64, b64)
        rel = kkt_tests.rel([got], [want])
        gap = float((got - want).abs().max())

        def residual(x):
            r = (a64 @ x.double()[..., None])[..., 0] - b64
            return float(torch.linalg.norm(r) / torch.linalg.norm(b64))

        x32 = [ldl(a, b), ldl_solve(a, b)]
        res = [residual(x) for x in x32]
        fwd = [float(torch.linalg.norm(x.double() - want)
                     / torch.linalg.norm(want)) for x in x32]
        same = [kkt_tests.factors_equal(m, v) for m, v in ((a, b), (a64, b64))]
        n, lanes = a.shape[-1], a.shape[0]
        print(f"kkt: ldl on path {path}'s first KKT ({lanes} lanes, n = {n}): "
              f"float64 largest |diff| {gap:.3g} ({rel:.3g} of the largest "
              f"entry), float32 relative residual {res[0]:.3g} against the "
              f"plain version's {res[1]:.3g} (error against float64's x "
              f"{fwd[0]:.3g} and {fwd[1]:.3g}); L and d equal to the plain "
              f"version's bit for bit in float32 and float64: {same} {tag}",
              flush=True)
        assert rel <= kkt_tests.F64_REL, (path, rel)
        assert res[0] <= kkt_tests.F32_RESIDUAL_RATIO * res[1], (path, res)
        assert all(same), (path, same)
        errs["ldl"] = max(errs["ldl"], gap)
        kernel = cuda_ms(lambda: ldl(a, b), 20, spin=True)
        plain = cuda_ms(lambda: ldl_solve(a, b), 3)

        def library_call():
            fac, piv, _ = torch.linalg.ldl_factor_ex(a)
            return torch.linalg.ldl_solve(fac, piv, b[..., None])

        library = cuda_ms(library_call, 10, spin=True)
        bound, by = ldl_mod.bound_ms(n, lanes, 4)
        rows.append({"kernel": "ldl", "path": path, "shape": [lanes, n, n],
                     "ms": kernel, "plain_ms": plain, "library_ms": library,
                     "bound_ms": bound, "bound_by": by})
    for r in rows:
        print(f"kkt: {r['kernel']} at path {r['path']}'s {r['shape']}, "
              f"float32: kernel {r['ms']:.4f} ms, plain version "
              f"{r['plain_ms']:.3f} ms, library call {r['library_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.2%} of it {tag}", flush=True)
    print(json.dumps({"kkt_bound": rows, "card": tag[1:-1]}), flush=True)
    entry = lambda name, path: dict(
        {k: v for k, v in next(r for r in rows if r["kernel"] == name
                               and r["path"] == path).items()
         if k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        max_abs_err=errs[name])
    return {"structure_kkt": entry("structure_kkt", "A"),
            "ldl": entry("ldl", "C"), "rows": rows}


def contract_path(dev, tag):
    """Phase L: tests/test_mpc_quadruped.py's contract at its full 1000 sim
    steps on the card, as tests/test_torch_contracts_cuda.py runs and holds
    it (``simulate`` + ``ci_mpc_policy`` direct, gait2, one lane from the
    gait's initial state, float32, fixed 8-iteration knot solves): every
    step converges and the four tracking errors stay under 1.5 × the
    reference's, which the JAX package's float32 run also meets
    (tools/contracts_reference.py); returns the launches."""
    sys.path.insert(0, TESTS)
    import test_torch_contracts_cuda as contracts
    got, launches, wall = counted(
        "phase L", 1000, lambda: contracts.CONTRACTS["quadruped"](dev),
        1000 // 5)
    print(f"phase L (tests/test_mpc_quadruped.py at 1000 steps, simulate + "
          f"ci_mpc_policy direct): {json.dumps(got)} (JAX float32: "
          f"{json.dumps(contracts.JAX_F32['quadruped'])}) in {wall:.2f} s, "
          f"knot_ip launches {launches} {tag}", flush=True)
    contracts.check("quadruped", got)
    assert launches >= 1000 // 5, launches
    return launches


def main():
    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name_power = describe("cuda")
    print(name_power, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    tag = f"[{name_power}]"
    dev = torch.device("cuda")
    t_start = time.time()

    # ---- 2. build: one nvcc a source, all at once --------------------------
    t0 = time.time()
    kernels = (knot_mod, sim_mod, sk_mod, ldl_mod)
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        libs = list(pool.map(lambda mod: mod.build(verbose=True), kernels))
    print(f"build: {', '.join(libs)} in {time.time() - t0:.1f} s",
          flush=True)

    # ---- 3. the quadruped's instantiation ----------------------------------
    cfg = HotPathConfig()
    stages, trials = cfg.h_mpc - 1, cfg.newton_max_ls + 1
    knots = cfg.h_mpc
    phases = {}   # instantiation: (largest |Δz|, times, the path's (N, K))
    err, times = kernel_phase(
        "quadruped", cfg.fixed_ip_iters,
        shapes=[(16, trials, stages), (16, 1, stages), (1, 1, 3),
                (256, trials, stages), (16, trials, knots), (16, 1, knots)],
        shares=QUADRUPED_SHARES,
        timed=[(16, 1, stages), (16, trials, stages), (256, trials, stages),
               (16, 1, knots), (16, trials, knots)], tag=tag)
    phases["quadruped"] = (err, times, (16 * trials * stages, stages))
    per_period = (times[(144, stages)][0]
                  + cfg.newton_iters * times[(1008, stages)][0])
    print(f"knot_ip per structure-mode control period (1 launch at N=144, "
          f"{cfg.newton_iters} at N=1008): {per_period:.4f} ms {tag}",
          flush=True)

    # ---- 4. the 2D hopper's, and dimensions the build does not hold --------
    err, times = kernel_phase(
        "hopper_2D", 8,
        shapes=[(16, 7, 10), (16, 1, 10), (1, 1, 3), (37, 7, 10)],
        shares=HOPPER_SHARES, timed=[(16, 1, 10), (16, 7, 10), (37, 7, 10)],
        tag=tag, converged_only=False)
    phases["hopper_2D"] = (err, times, (1120, 10))
    # the 2D particle on the nonlinear cone (ny 3): no model of the JAX
    # package on a linearized-cone terrain gives these dimensions
    nc_dims = dims_of(particle_2d, flat_2d_nc)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    nz, nt = nc_dims.nz, nc_dims.ntheta
    before = knot_ip.launches
    try:
        knot_ip(nc_dims, zeros(3, nz), zeros(3, nt), zeros(3, nz),
                zeros(3, nz, nz), zeros(3, nz, nt), zeros(2, 3, nc_dims.nc),
                zeros(2, 3, nt), zeros(2, 3, nc_dims.nq),
                default_mpc_ip_options(1.0e-4), 3)
    except RuntimeError as e:
        assert "unsupported dims" in str(e), e
        print(f"dimensions the build does not hold raise: {e}", flush=True)
    else:
        raise AssertionError("dimensions the build does not hold did not "
                             "raise")
    assert knot_ip.launches == before

    # ---- 5-7. the block template: the centroidal quadruped's, the 3D
    # hopper's (path F's H = 20); the flamingo's warp (path E's H = 15) -----
    for name, k, shares, converged_only in (
            ("centroidal_quadruped", 10, CENTROIDAL_SHARES, True),
            ("flamingo", 15, SHARES["flamingo"], False),
            ("hopper_3D", 20, SHARES["hopper_3D"], True)):
        err, times = kernel_phase(
            name, 8, shapes=[(16, 7, k), (16, 1, k), (1, 1, 3), (64, 7, k)],
            shares=shares, timed=[(16, 1, k), (16, 7, k), (64, 7, k)],
            tag=tag, converged_only=converged_only)
        phases[name] = (err, times, (16 * 7 * k, k))

    # ---- 8. the instantiations no path runs, N from their examples' H ---------
    for name, _, _, _, _, _, k, *_ in PATHLESS:
        err, times = kernel_phase(
            name, 8, shapes=[(16, 7, k), (16, 1, k), (1, 1, 3)],
            shares=SHARES[name], timed=[(16, 1, k), (16, 7, k)], tag=tag,
            converged_only=False)
        phases[name] = (err, times, (16 * 7 * k, k))

    walls = {}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        walls[name] = time.time() - t0
        return out

    # ---- 9-15, 18. the nine MPC paths ------------------------------------------
    launches = {
        "A": timed("A", quadruped_path, "path A", cfg, 100, dev, tag, True),
        "B": timed("B", hopper_path, dev, tag),
        "C": timed("C", quadruped_path, "path C",
                   HotPathConfig(newton_mode="direct"), C_STEPS, dev, tag),
        "D": timed("D", centroidal_path, dev, tag),
        "E": timed("E", flamingo_path, dev, tag, E_STEPS),
        "F": timed("F", hopper3d_path, dev, tag, 100),
        "I": timed("I", point_foot_path, dev, tag),
        "K": timed("K", box_path, dev, tag),
        "L": timed("L", contract_path, dev, tag)}
    # ---- 16-18. the nonlinear cone, the Raibert baseline and the
    # two-process sweep: no MPC, no knot kernel ------------------------------
    timed("G", cone_path, dev, tag)
    timed("H", raibert_path, dev, tag)
    timed("J", two_process_phase, dev, tag)
    timed("graphs", graph_phase, dev, tag)
    timed("newton", newton_phase, dev, tag)
    # ---- 20. the sim kernel against its plain version ------------------------
    sim_entry = timed("S", sim_kernel_phase, dev, tag)
    # ---- 22. the KKT kernels against their plain versions --------------------
    kkt_entry = timed("kkt", kkt_phase, dev, tag)
    print("sim graphs of each counted run (one replay a sim step but on "
          "A, C and L; sets captured, their warm-up and capture seconds and "
          "pool bytes): " + json.dumps(GRAPHS) + f" {tag}", flush=True)
    print("sim kernel launches of each counted run (one a sim step on A, C "
          "and L, none elsewhere): " + json.dumps(SIM_LAUNCHES) + f" {tag}",
          flush=True)
    print("Newton graphs of each counted run (one replay a solve, trip "
          "replays in direct mode, sets captured, their warm-up and capture "
          "seconds, pool bytes and warm-up knot launches): "
          + json.dumps({k: v for k, v in NEWTON.items() if v["solves"]})
          + f" {tag}", flush=True)
    print("KKT kernel launches of each counted run (structure_kkt on A, ldl "
          "on the direct paths; warm-up: the Newton graphs' warm-ups'): "
          + json.dumps(KKT) + f" {tag}", flush=True)
    print("phase walls (s, each with its warm-up and checks): "
          + json.dumps({k: round(v, 2) for k, v in walls.items()})
          + f" {tag}", flush=True)
    paths_of = {"quadruped": "ACL", "hopper_2D": "B",
                "centroidal_quadruped": "D", "flamingo": "E",
                "hopper_3D": "F", "point_foot_quadruped": "I",
                "centroidal_quadruped_box": "K"}

    bounds = [{"model": name, "n": n, "knots": k, "ms": t[0],
               "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
               "share": t[2] / t[0]}
              for name, (_, times, _) in phases.items()
              for (n, k), t in times.items()]
    print(json.dumps({"knot_ip_bound": bounds,
                      "peak_flops": knot_mod.PEAK_FLOPS,
                      "peak_bytes_per_s": knot_mod.PEAK_BYTES,
                      "card": name_power}))
    instantiations = []
    for table, template in ((knot_mod.KNOT_IP_MODELS, "warp"),
                            (knot_mod.KNOT_IP_WIDE_MODELS, "block")):
        for dims, models in table.items():
            name = next(m for m in models if m in phases)
            err, times, main_nk = phases[name]
            t = times[main_nk]
            paths = "".join(paths_of.get(m, "") for m in models)
            instantiations.append({
                "dims": list(dims), "template": template,
                "models": list(models), "n": main_nk[0], "knots": main_nk[1],
                "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                "bound_ms": t[2], "bound_by": t[3], "share": t[2] / t[0],
                "paths": list(paths),
                "launches": sum(launches[p] for p in paths)})
    main_q = phases["quadruped"][1][(1008, stages)]
    sim_launches = {p[-1]: SIM_LAUNCHES[p] for p in KERNEL_PATHS}
    kkt_launches = {name: {p[-1]: KKT[p][name] for p in KKT if KKT[p][name]}
                    for name in ("structure_kkt", "ldl")}
    print(json.dumps({"kernels": [{
        "name": "knot_ip", "route": "cuda",
        "source": "contactimplicitmpc_tpu_torch/csrc/knot_ip.cu",
        "replaces": "contactimplicitmpc_tpu/ops/pallas_ip.py:310",
        "launches": sum(launches.values()),
        "max_abs_err": max(e for e, _, _ in phases.values()),
        "ms": main_q[0], "plain_ms": main_q[1], "bound_ms": main_q[2],
        "bound_by": main_q[3], "library_ms": None,
        "launches_by_path": launches,
        "newton_warmup_launches_by_path": {
            p[-1]: v["warmup_launches"] for p, v in NEWTON.items()
            if v["solves"]},
        "instantiations": instantiations}, {
        "name": "sim_ip", "route": "cuda",
        "source": "contactimplicitmpc_tpu_torch/csrc/sim_ip.cu",
        "replaces": "contactimplicitmpc_tpu/sim/interior_point.py:432",
        "launches": sum(sim_launches.values()), **sim_entry,
        "library_ms": None, "launches_by_path": sim_launches}, {
        "name": "structure_kkt", "route": "cuda",
        "source": "contactimplicitmpc_tpu_torch/csrc/structure_kkt.cu",
        "replaces": "contactimplicitmpc_tpu/control/structure_solver.py:202",
        "launches": sum(kkt_launches["structure_kkt"].values()),
        **kkt_entry["structure_kkt"],
        "launches_by_path": kkt_launches["structure_kkt"]}, {
        "name": "ldl", "route": "cuda",
        "source": "contactimplicitmpc_tpu_torch/csrc/ldl.cu",
        "replaces": "contactimplicitmpc_tpu/ops/linsolve.py:167",
        "launches": sum(kkt_launches["ldl"].values()), **kkt_entry["ldl"],
        "launches_by_path": kkt_launches["ldl"],
        "shapes": [r for r in kkt_entry["rows"] if r["kernel"] == "ldl"]}]}))
    print(f"chip_smoke: every phase after the device check in "
          f"{time.time() - t_start:.1f} s {tag}", flush=True)
    torch.distributed.destroy_process_group()
    print(describe("cuda"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--sweep-worker"]:
        sys.exit(sweep_worker())
    sys.exit(main())
