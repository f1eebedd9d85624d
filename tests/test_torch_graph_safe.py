"""The sim solve is safe to capture as a CUDA graph, held on the CPU.

``sim/graphs.py`` captures the pieces of ``interior_point.ip_program``
(``start``, the loop ``trip``, ``restart``, ``finish``) and, for fixed
iterations, a whole ``ip_solve``. Under stream capture an op that reads a
value back to the host, or a tensor made from host data (a copy from
pageable memory), breaks the capture. After one warm-up call (which makes
the models' and terrains' constants), each piece and a whole
fixed-iteration solve run here under a ``TorchDispatchMode`` that records
every op; none may be a host read (``aten::_local_scalar_dense``,
``aten::is_nonzero``, ``aten::nonzero``, ``aten::item``, or an index by a
boolean mask, which reads the mask's count) or a tensor made from host
data (``aten::lift_fresh``, ``aten::lift_fresh_copy``). Cases: the
linearized cone with fixed iterations (the quadruped), adaptive (the 2D
hopper), the nonlinear cone (the 3D particle on flat_3d_nc), a model with
``torch.func`` derivatives (the centroidal quadruped) and the two stairs
terrains (the 2D hopper on each), float64, two lanes from the gaits'
initial states moved by a seeded draw.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch.control.trajectory import (
    from_gait, initial_conditions)
from contactimplicitmpc_tpu_torch.models import MODELS
from contactimplicitmpc_tpu_torch.sim.graphs import SimSolve
from contactimplicitmpc_tpu_torch.sim.interior_point import (
    IPOptions, ip_program, ip_solve, run_program, z_initialize)
from contactimplicitmpc_tpu_torch.sim.residual import pack_theta, residual
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

HOST_READS = {"aten._local_scalar_dense", "aten.is_nonzero", "aten.nonzero",
              "aten.item", "aten.masked_select"}
HOST_DATA = {"aten.lift_fresh", "aten.lift_fresh_copy"}

# float32 sim options of the chip paths (adaptive), and the hot path's
# masked fixed iterations at a depth of two
ADAPTIVE = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                     undercut=float("inf"), max_ls=6, refine=1, retries=1)
FIXED = dataclasses.replace(ADAPTIVE, fixed_iters=2, refine=0)

# (model, terrain, gait folder and name or None, q1 where no gait)
CASES = {
    "quadruped_fixed": ("quadruped", "flat_2D_lc", ("quadruped", "gait2")),
    "hopper_adaptive": ("hopper_2D", "flat_2D_lc",
                        ("hopper_2D", "gait_in_place")),
    "particle_nonlinear_cone": ("particle", "flat_3D_nc", None),
    "centroidal_torch_func": ("centroidal_quadruped", "flat_3D_lc",
                              ("centroidal_quadruped", "stand_v0")),
    "hopper_smoothed_stairs": ("hopper_2D", "smoothed_stairs_2D_lc",
                               ("hopper_2D", "gait_in_place")),
    "hopper_stairs": ("hopper_2D", "stairs3_2D_lc",
                      ("hopper_2D", "gait_in_place")),
}


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


class Recorder(TorchDispatchMode):
    """Every op dispatched, by its overload packet's name; ops that index
    by a boolean mask are recorded as ``aten.nonzero``."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name.startswith("aten.index") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for a in args if isinstance(a, (list, tuple)) for i in a):
            name = "aten.nonzero"
        self.ops.append(name)
        return func(*args, **(kwargs or {}))


def problem(name, lanes=2, seed=0):
    """(dims, residual, z0, θ, cone) of one sim step of ``lanes`` lanes."""
    model_name, env_name, gait = CASES[name]
    model, env = MODELS[model_name], pt.ENVIRONMENTS[env_name]
    dims = pt.dims_of(model, env)
    f64 = dict(dtype=torch.float64, device="cpu")
    if gait is None:
        q1, v1 = (torch.tensor([0.0, 0.0, 0.02], **f64),
                  torch.tensor([1.0, 2.0, -1.0], **f64))
        h = 0.01
    else:
        flat = pt.flat_3d_lc if env.dim == 3 else pt.flat_2d_lc
        ref = from_gait(model, flat, load_gait(*gait), **f64)
        q1, v1 = initial_conditions(ref)
        h = float(ref.h) / 5
    rng = np.random.default_rng(seed)
    q1 = q1 + torch.as_tensor(1e-3 * rng.standard_normal((lanes, dims.nq)),
                              **f64)
    q0 = q1 - h * v1
    u = torch.as_tensor(0.1 * rng.standard_normal((lanes, dims.nu)), **f64)
    w = torch.zeros((lanes, dims.nw), **f64)
    theta = pack_theta(q0, q1, u, w, model.mu_world, h)
    z0 = z_initialize(dims, q1, cone=env.cone)

    def r_fn(z, th, kap):
        return residual(model, env, z, th, kap)

    return dims, r_fn, z0, theta, env.cone


def pieces(dims, r_fn, z0, theta, cone, opts):
    """What ``sim/graphs.py`` captures for ``opts``: the adaptive
    program's four pieces, or the whole solve."""
    if opts.fixed_iters > 0:
        yield "solve", lambda: run_program(
            ip_program(dims, r_fn, z0, theta, opts, cone=cone), z0, opts)
        return
    prog = ip_program(dims, r_fn, z0, theta, opts, cone=cone)
    state = prog.start(z0)
    yield "start", lambda: prog.start(z0)
    yield "trip", lambda: prog.trip(state)
    yield "live", lambda: prog.live(state).any()
    yield "restart", lambda: prog.restart(state)
    yield "finish", lambda: prog.finish(state)


def record(fn):
    fn()                                   # warm-up
    with Recorder() as rec:
        fn()
    return rec.ops


@pytest.mark.parametrize("name", list(CASES))
def test_captured_pieces_read_nothing_from_the_host(name):
    dims, r_fn, z0, theta, cone = problem(name)
    found = {}
    for opts in (ADAPTIVE, FIXED):
        for piece, fn in pieces(dims, r_fn, z0, theta, cone, opts):
            ops = record(fn)
            assert len(ops) > (100 if piece in ("trip", "solve") else 0), \
                (piece, len(ops))
            bad = sorted(set(ops) & (HOST_READS | HOST_DATA))
            if bad:
                found[piece] = bad
    assert not found, found


def test_recorder_sees_host_reads_and_host_data():
    """The recorder finds each kind of fault it is there to find."""
    x = torch.randn(4, dtype=torch.float64)
    faults = [lambda: bool(x.sum() > 0), lambda: float(x[0]),
              lambda: x[x > 0], lambda: torch.nonzero(x),
              lambda: torch.tensor([1.0, 2.0]) * x[:2],
              lambda: torch.as_tensor([1.0, 2.0]) * x[:2]]
    for fault in faults:
        with Recorder() as rec:
            fault()
        assert set(rec.ops) & (HOST_READS | HOST_DATA), rec.ops


@pytest.mark.parametrize("name", ["hopper_adaptive",
                                  "particle_nonlinear_cone"])
def test_sim_solve_on_cpu_tensors_is_ip_solve(name):
    """On CPU tensors ``SimSolve`` is the eager ``ip_solve``: the same
    result bit for bit, and no graph."""
    dims, r_fn, z0, theta, cone = problem(name)
    model_name, env_name, _ = CASES[name]
    solve = SimSolve(MODELS[model_name], pt.ENVIRONMENTS[env_name], ADAPTIVE)
    assert solve.route(z0) == "eager"
    got = solve(z0, theta)
    want = ip_solve(dims, r_fn, z0, theta, ADAPTIVE, cone=cone)
    assert not solve.graph_sets
    for a, b in zip(got, want):
        if a is not None:
            assert torch.equal(a, b)
