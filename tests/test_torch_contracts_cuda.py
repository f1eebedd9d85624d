"""The JAX package's full-length closed-loop MPC contracts, held on the card.

Eleven runs, one a JAX contract test's rollout, each at the test's full
length on the port's sim step (replayed CUDA graphs, ``sim/graphs.py``):

| run | JAX test | port path, length |
| --- | --- | --- |
| quadruped | tests/test_mpc_quadruped.py (both) | ``simulate`` + ``ci_mpc_policy``, gait2, 1000 steps |
| flamingo | tests/test_mpc_flamingo.py (both) | gait_forward_36_4, CONFIGURATION_FORCE, H 15, 1000 |
| terrain | tests/test_mpc_terrain.py::test_quadruped_piecewise_mpc | ``mpc_rollout`` direct, piecewise slope, 250 |
| altitude | tests/test_mpc_terrain.py::test_altitude_update_discovers_height | ``mpc_rollout`` structure, 50 |
| hopper | tests/test_mpc_hopper.py (both) | 2D hopper in place, 500 |
| structure | tests/test_mpc_structure_mode.py | the same, structure-mode Newton, 500 |
| hopper_sine, hopper_piecewise | tests/test_hopper_terrain.py | examples/torch_hopper_terrain.py's ``run_case``, 500 |
| parkour | tests/test_mpc_parkour_structure.py | hard stairs, structure mode, N_sample 10, 2400 |
| centroidal_stand, centroidal_trot | tests/test_mpc_centroidal.py | ``mpc_rollout`` direct, 50 and 100 |

The form is the card's: float32, fixed 8-iteration knot solves (the
kernel's form), the tests' knot options, and the chip paths' float32 sim
options (r_tol 1e-3, κ_tol 1e-5, 40 iterations, 6 halvings; one refinement
pass for the flamingo and the centroidal quadruped), from the gaits'
``initial_conditions`` (no random draw). The yardstick is the JAX package
in the same form, ``tools/contracts_reference.py`` (float32 on the CPU;
its outputs are ``JAX_F32`` below). Where that run meets a test's bound,
the port is held to the bound. Where it misses one, the port is held to
its outcome within ``STEPS_SLACK``: JAX's float32 hopper, in place and in
structure mode, converges 480 of its 500 sim steps (the tests ask for
all), so the port must converge at least 480 − 10 of them; every other
bound of those two runs JAX meets, and the port is held to it.

The tests are marked ``cuda`` and skip where CUDA is absent. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda -s tests/test_torch_contracts_cuda.py

Each test prints its quantities, its wall and the card's name and power
limit. chip_smoke.py's phase L runs the quadruped contract through this
module's ``CONTRACTS`` and ``check``.
"""

import time

import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch.control.implicit_dynamics import (
    CONFIGURATION, CONFIGURATION_FORCE, default_mpc_ip_options)
from contactimplicitmpc_tpu_torch.control.newton import NewtonOptions
from contactimplicitmpc_tpu_torch.control.objective import (
    tracking_objective, tracking_velocity_objective)
from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
from contactimplicitmpc_tpu_torch.control.trajectory import (
    from_gait, initial_conditions, tracking_error)
from contactimplicitmpc_tpu_torch.device import describe
from contactimplicitmpc_tpu_torch.models.centroidal_quadruped import \
    centroidal_quadruped
from contactimplicitmpc_tpu_torch.models.flamingo import flamingo
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait
from test_torch_examples import example

F32 = torch.float32
FIXED = dict(fixed_ip_iters=8)

# tools/contracts_reference.py on the CPU (JAX package, float32, fixed
# 8-iteration knot solves, the float32 sim options above), 2026-10-17
JAX_F32 = {
    "quadruped": {"steps": 1000, "converged_steps": 1000,
                  "q_err": 0.01949716918170452, "u_err": 0.043324120342731476,
                  "gamma_err": 0.37675976753234863,
                  "b_err": 0.07919994741678238},
    "flamingo": {"steps": 1000, "converged_steps": 1000,
                 "q_err": 0.0105534503236413, "u_err": 0.0824291855096817,
                 "gamma_err": 0.44084832072257996,
                 "b_err": 0.014909209683537483},
    "terrain": {"steps": 250, "converged_steps": 250,
                "forward": 0.1624011993408203,
                "min_height": 0.2794179320335388,
                "q_err": 0.015318728052079678, "u_err": 0.0422423854470253,
                "gamma_err": 0.36705687642097473,
                "b_err": 0.07330550253391266},
    "altitude": {"steps": 50, "converged_steps": 50},
    "hopper": {"steps": 500, "converged_steps": 480,
               "q_err": 0.01453445479273796, "u_err": 0.09018315374851227,
               "x_final": -2.085416728192513e-09,
               "z_final": 0.5435570478439331},
    "structure": {"steps": 500, "converged_steps": 480,
                  "q_err": 0.015182852745056152,
                  "u_err": 0.08962655067443848,
                  "x_final": -3.674903936712326e-08,
                  "z_final": 0.5949904322624207},
    "hopper_sine": {"steps": 500, "converged_steps": 499,
                    "convergence": 0.9980000257492065,
                    "forward": 0.09507598727941513},
    "hopper_piecewise": {"steps": 500, "converged_steps": 500,
                         "convergence": 1.0, "forward": 0.10422182083129883},
    "parkour": {"steps": 2400, "converged_steps": 2400,
                "x_final": 0.7469600439071655, "z_final": 1.2424874305725098},
    "centroidal_stand": {"steps": 50, "converged_steps": 50,
                         "q_err": 0.0002498184039723128,
                         "height_error": 0.004270225763320923,
                         "min_foot_z": -9.899272299662698e-07},
    "centroidal_trot": {"steps": 100, "converged_steps": 100,
                        "q_err": 0.0002919257676694542,
                        "min_body_z": 0.29917263984680176,
                        "ref_body_z": 0.30000001192092896},
}
# the runs whose status JAX's own float32 form misses (converged steps
# short of all), held to its converged steps less this many
STEPS_SLACK = 10


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
        pytest.skip("needs an NVIDIA GPU: the contracts run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def sim_options(refine=0):
    return IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                     undercut=float("inf"), max_ls=6, refine=refine)


def simulate_lane(model, env, ref, policy, steps, n_sample, sim_env=None,
                  opts=None):
    """``simulate`` of the one lane ``initial_conditions(ref)``."""
    q1, v1 = initial_conditions(ref)
    return pt.simulate(model, sim_env or env, steps,
                       float(ref.h) / n_sample, q1[None], v1[None],
                       policy=policy, opts=opts or sim_options())


def errors(ref, traj, n_sample, idx_shift=()):
    return dict(zip(("q_err", "u_err", "gamma_err", "b_err"), tracking_error(
        ref, traj.q[0], traj.u[0], traj.gamma[0], traj.b[0], n_sample,
        idx_shift)))


def steps_of(converged):
    return {"steps": int(converged.shape[-1]),
            "converged_steps": int(converged[0].sum())}


def quadruped_mpc(dev):
    model, env = quadruped, pt.flat_2d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=F32, device=dev)
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4
    qw = 1e-2 * np.array([1.0, 0.02, 0.25] + [0.25] * (dims.nq - 3))
    obj = tracking_objective(
        dims, h_mpc, q=np.tile(qw, (h_mpc, 1)),
        u=3e-2 * np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=F32, device=dev)
    policy = pt.ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30))
    traj = simulate_lane(model, env, ref, policy, 1000, n_sample)
    return {**steps_of(traj.converged),
            **errors(ref, traj, n_sample, (0,))}


def flamingo_mpc(dev):
    model, env = flamingo, pt.flat_2d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("flamingo", "gait_forward_36_4"),
                    dtype=F32, device=dev)
    n_sample, h_mpc, kappa = 5, 15, 2.0e-4
    obj = tracking_velocity_objective(
        dims, h_mpc,
        v=np.tile(1e-3 * np.array([1e0, 1, 1e4, 1, 1, 1, 1, 1e4, 1e4]),
                  (h_mpc, 1)),
        q=np.tile(1e-1 * np.array([3e2, 1e-6, 3e2, 1, 1, 1, 1, 0.1, 0.1]),
                  (h_mpc, 1)),
        u=np.tile(3e-1 * np.array([0.1, 0.1, 0.3, 0.3, 1.0, 1.0]),
                  (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=F32, device=dev)
    policy = pt.ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION_FORCE,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30))
    traj = simulate_lane(model, env, ref, policy, 1000, n_sample,
                         opts=sim_options(refine=1))
    return {**steps_of(traj.converged),
            **errors(ref, traj, n_sample, (0,))}


def terrain_mpc(dev):
    model, env = quadruped, pt.piecewise1_2d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=F32, device=dev)
    n_sample, h_mpc, kappa = 5, 10, 1.0e-4
    qw = 1e-2 * np.array([5.0, 0.02, 0.10] + [0.25] * 8)
    obj = tracking_objective(
        dims, h_mpc, q=np.tile(qw, (h_mpc, 1)),
        u=3e-2 * np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=F32, device=dev)
    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=100,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    q1, v1 = initial_conditions(ref)
    traj = mpc_rollout(
        model, env, ref, obj, 250, h_mpc, n_sample, kappa, CONFIGURATION,
        q1[None], v1[None],
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        ip_opts=mpc_ip, sim_opts=sim_options(), warm_start_floor=1e-2,
        mpc_opts=pt.CIMPCOptions(altitude_update=True,
                                 altitude_impact_threshold=0.05))
    q = traj.q[0]
    heights = q[:, 1] - env.surf(q[:, :1])
    return {**steps_of(traj.sim_converged),
            "forward": float(q[-1, 0] - q[1, 0]),
            "min_height": float(heights.min()),
            **errors(ref, traj, n_sample, (0,))}


def altitude_mpc(dev):
    model, env = quadruped, pt.flat_2d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=F32, device=dev)
    qw = 1e-2 * np.array([1.0, 0.02, 0.25] + [0.25] * 8)
    obj = tracking_objective(
        dims, 10, q=np.tile(qw, (10, 1)), u=3e-2 * np.ones((10, dims.nu)),
        gamma=1e-100 * np.ones((10, dims.nc)),
        b=1e-100 * np.ones((10, dims.nb)), dtype=F32, device=dev)
    q1, v1 = initial_conditions(ref)
    traj = mpc_rollout(
        model, env, ref, obj, 50, 10, 5, 2e-4, CONFIGURATION, q1[None],
        v1[None], n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        sim_opts=sim_options(), warm_start_floor=1e-2,
        newton_mode="structure",
        mpc_opts=pt.CIMPCOptions(altitude_update=True,
                                 altitude_impact_threshold=0.05))
    return steps_of(traj.sim_converged)


def hopper_mpc(dev, newton_mode):
    model, env = hopper_2d, pt.flat_2d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("hopper_2D", "gait_in_place"),
                    kappa=1.0e-4, dtype=F32, device=dev)
    n_sample, h_mpc, kappa = 5, 10, 1.0e-4
    qw = np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    qw[-2:] = 1e-1 * np.array([0.1, 3, 1, 3])
    vw = np.tile(1e-3 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    vw[:2] = 1e1 * np.array([0.1, 3, 1, 3])
    obj = tracking_velocity_objective(
        dims, h_mpc, q=qw, v=vw,
        u=np.tile(np.array([3e-3, 1e0]), (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=F32, device=dev)
    policy = pt.ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION, newton_mode=newton_mode,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30))
    traj = simulate_lane(model, env, ref, policy, 500, n_sample)
    e = errors(ref, traj, n_sample)
    return {**steps_of(traj.converged), "q_err": e["q_err"],
            "u_err": e["u_err"], "x_final": float(traj.q[0, -1, 0]),
            "z_final": float(traj.q[0, -1, 1])}


def hopper_terrain(dev, sim_env_name):
    _, traj, _ = example("torch_hopper_terrain").run_case(
        "hopper_2D", sim_env_name, 500, F32, dev)
    conv = traj.converged[0]
    return {**steps_of(traj.converged),
            "convergence": float(conv.float().mean()),
            "forward": float(traj.q[0, -1, 0] - traj.q[0, 1, 0])}


def parkour_mpc(dev):
    model, env, sim_env = hopper_2d, pt.flat_2d_lc, pt.stairs3_2d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("hopper_2D", "hopper_stair_ref"),
                    dtype=F32, device=dev)
    n_sample, h_mpc, kappa = 10, 10, 2.0e-4
    q_w = np.concatenate([
        np.tile(1e-0 * np.array([1e1, 1e-1, 1.0, 1.0]), (h_mpc - 5, 1)),
        np.tile(1e-1 * np.array([1.0, 1e-1, 1e1, 0.1]), (5, 1))])
    obj = tracking_velocity_objective(
        dims, h_mpc, v=np.tile(1e-3 * np.array([1e-2, 1, 1, 10]), (h_mpc, 1)),
        q=q_w, u=np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=F32, device=dev)
    q1, v1 = initial_conditions(ref)
    traj = mpc_rollout(
        model, env, ref, obj, 240 * n_sample, h_mpc, n_sample, kappa,
        CONFIGURATION, q1[None], v1[None],
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, **FIXED),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30),
        sim_opts=sim_options(), warm_start_floor=1e-2,
        newton_mode="structure",
        mpc_opts=pt.CIMPCOptions(altitude_update=True,
                                 altitude_impact_threshold=0.1),
        stride_idx=(0, 1), sim_env=sim_env)
    return {**steps_of(traj.sim_converged),
            "x_final": float(traj.q[0, -1, 0]),
            "z_final": float(traj.q[0, -1, 1])}


def centroidal_mpc(dev, gait, steps, q_offset=0.0):
    model, env = centroidal_quadruped, pt.flat_3d_lc
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("centroidal_quadruped", gait),
                    update_friction=True, dtype=F32, device=dev)
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4
    v_w = 1e-3 * np.concatenate([np.ones(3), 1e3 * np.ones(3), np.ones(12)])
    q_body = np.array([1e-2, 1e-2, 1.0]) + 4.0 * np.array([0.2, 0.2, 1.0])
    q_w = np.concatenate([q_body, 0.3 * np.ones(3),
                          np.tile([0.2, 0.2, 1.0], 4)])
    obj = tracking_velocity_objective(dims, h_mpc, q=q_w, v=v_w,
                                      u=3e-3 * np.ones(dims.nu), dtype=F32,
                                      device=dev)
    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=30,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    q1, v1 = initial_conditions(ref)
    q1 = q1.clone()
    q1[2] += q_offset
    traj = mpc_rollout(
        model, env, ref, obj, steps, h_mpc, n_sample, kappa, CONFIGURATION,
        q1[None], v1[None],
        n_opts=NewtonOptions(r_tol=3e-5, max_iter=5, **FIXED),
        ip_opts=mpc_ip, sim_opts=sim_options(refine=1),
        warm_start_floor=1e-2)
    e = errors(ref, traj, n_sample)
    q = traj.q[0]
    return {**steps_of(traj.sim_converged), "q_err": e["q_err"],
            "height_error": abs(float(q[-1, 2] - ref.q[1, 2])),
            "min_foot_z": float(q[:, 8::3].min()),
            "min_body_z": float(q[:, 2].min()),
            "ref_body_z": float(ref.q[1, 2])}


CONTRACTS = {
    "quadruped": quadruped_mpc,
    "flamingo": flamingo_mpc,
    "terrain": terrain_mpc,
    "altitude": altitude_mpc,
    "hopper": lambda dev: hopper_mpc(dev, "direct"),
    "structure": lambda dev: hopper_mpc(dev, "structure"),
    "hopper_sine": lambda dev: hopper_terrain(dev, "sine2_2D_lc"),
    "hopper_piecewise": lambda dev: hopper_terrain(dev, "piecewise1_2D_lc"),
    "parkour": parkour_mpc,
    "centroidal_stand": lambda dev: centroidal_mpc(dev, "stand_v0", 50,
                                                    0.01),
    "centroidal_trot": lambda dev: centroidal_mpc(dev, "inplace_trot_v2",
                                                   100),
}

# each run's bounds: the JAX test's, as (quantity, low, high); None is open
TRACKING = {"quadruped": (0.0201, 0.0437, 0.374, 0.0789),
            "flamingo": (0.0154, 0.0829, 0.444, 0.0169),
            "terrain": (0.0155, 0.0422, 0.367, 0.0733)}
BOUNDS = {
    **{name: [(k, None, 1.5 * b) for k, b in zip(
        ("q_err", "u_err", "gamma_err", "b_err"), nominal)]
       for name, nominal in TRACKING.items()},
    "hopper": [("q_err", None, 0.05), ("u_err", None, 0.5),
               ("abs_x_final", None, 0.5), ("z_final", 0.3, 0.8)],
    "structure": [("q_err", None, 0.0130 * 1.5), ("u_err", None, 0.0894 * 1.5),
                  ("z_final", 0.3, 0.9)],
    "hopper_sine": [("convergence", 0.98, None), ("forward", 0.05, None)],
    "hopper_piecewise": [("convergence", 0.98, None),
                         ("forward", 0.05, None)],
    "parkour": [("x_final", 0.70, None), ("z_final", 1.15, None)],
    "centroidal_stand": [("q_err", None, 0.02), ("height_error", None, 0.03),
                         ("min_foot_z", -1e-4, None)],
    "centroidal_trot": [("q_err", None, 0.05),
                        ("body_over_half_ref", 0.0, None)],
}
BOUNDS["terrain"] += [("forward", 0.13, None), ("min_height", 0.2, None)]
# the runs whose test asks every sim step to converge (the others bound the
# converged share, hopper_sine and hopper_piecewise)
ALL_STEPS = ("quadruped", "flamingo", "terrain", "altitude", "hopper",
             "structure", "parkour", "centroidal_stand", "centroidal_trot")


def check(name, got):
    """Hold ``got`` (a run's quantities) to the test's bounds, and its
    converged steps to all of them, or to JAX's float32 count less
    ``STEPS_SLACK`` where that count falls short (the module's
    docstring)."""
    got = dict(got)
    if "x_final" in got:
        got["abs_x_final"] = abs(got["x_final"])
    if "min_body_z" in got:
        got["body_over_half_ref"] = got["min_body_z"] - 0.5 * got["ref_body_z"]
    jax = JAX_F32[name]
    assert got["steps"] == jax["steps"], (got["steps"], jax["steps"])
    if name in ALL_STEPS:
        want = (jax["steps"] if jax["converged_steps"] == jax["steps"]
                else jax["converged_steps"] - STEPS_SLACK)
        assert got["converged_steps"] >= want, (got["converged_steps"], want)
    for key, low, high in BOUNDS.get(name, ()):
        if low is not None:
            assert got[key] > low, (key, got[key], low)
        if high is not None:
            assert got[key] < high, (key, got[key], high)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONTRACTS))
def test_contract_on_the_card(name, card):
    t0 = time.perf_counter()
    got = CONTRACTS[name](card)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"\n{name}: {got} (JAX float32: {JAX_F32[name]}) in {wall:.2f} s "
          f"[{describe(card)}]", flush=True)
    check(name, got)
