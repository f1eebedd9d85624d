"""The MPC's Newton solve as CUDA graphs (``control/graphs.py``), held on
the CPU.

``NewtonSolve`` captures, on the card, the whole structure-mode solve
(``structure_newton_solve``) and the direct mode's ``start`` and ``trip``
(``newton_program``; with ``fixed_newton_iters`` the whole ``run_newton``).
Three groups, float64, two lanes, a horizon of four knots, fixed
two-iteration knot solves (the knot kernel's form):

* graph safety: after one warm-up call, each captured piece runs under
  ``tests/test_torch_graph_safe.py``'s ``Recorder`` and records no host
  read and no tensor made from host data. Cases: the quadruped in
  structure mode, the 2D hopper in direct mode in both decision modes, the
  quadruped in direct mode;
* the same results as before: ``NewtonSolve`` on CPU tensors is
  ``structure_newton_solve`` / ``newton_solve`` exactly (its ``"eager"``
  route, no graph set), and ``newton_solve`` (the pieces driven by
  ``run_newton``) equals ``loop_reference``, the loop it was cut from,
  kept here verbatim, bit for bit, adaptive and with fixed Newton
  iterations;
* the route: ``"graphs"`` for CUDA tensors with fixed knot solves,
  ``"eager"`` for the adaptive knot solve and for CPU tensors.

The JAX parity of both solves stays with ``tests/test_torch_newton.py``
and ``tests/test_torch_structure.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from contactimplicitmpc_tpu_torch.control.graphs import NewtonSolve
from contactimplicitmpc_tpu_torch.control.implicit_dynamics import (
    CONFIGURATION, CONFIGURATION_FORCE, default_mpc_ip_options,
    implicit_dynamics, nd_of)
from contactimplicitmpc_tpu_torch.control.linearized import (
    gather, linearize_trajectory)
from contactimplicitmpc_tpu_torch.control.newton import (
    NewtonOptions, NewtonResult, _where, newton_program, newton_solve,
    run_newton)
from contactimplicitmpc_tpu_torch.control.objective import (
    tracking_velocity_objective)
from contactimplicitmpc_tpu_torch.control.structure_solver import (
    StructureState, state_from_reference, structure_newton_solve)
from contactimplicitmpc_tpu_torch.control.trajectory import (
    ContactTraj, expand_traj, from_gait, slice_horizon, update_theta)
from contactimplicitmpc_tpu_torch.env import flat_2d_lc
from contactimplicitmpc_tpu_torch.hotpath import quadruped_tracking_weights
from contactimplicitmpc_tpu_torch.models.base import dims_of
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.ops.linsolve import ldl_solve
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait
from test_torch_graph_safe import HOST_DATA, HOST_READS, Recorder

F64 = dict(dtype=torch.float64, device="cpu")
H = 4
LANES = 2
KAPPA = 1e-4
N_OPTS = NewtonOptions(r_tol=3e-4, max_iter=2, fixed_ip_iters=2)
# (model, gait, decision mode, Newton mode)
CASES = {
    "quadruped_structure": (quadruped, ("quadruped", "gait2"),
                            CONFIGURATION, "structure"),
    "hopper_direct_configuration": (hopper_2d, ("hopper_2D",
                                                "gait_in_place"),
                                    CONFIGURATION, "direct"),
    "hopper_direct_configurationforce": (hopper_2d, ("hopper_2D",
                                                     "gait_in_place"),
                                         CONFIGURATION_FORCE, "direct"),
    "quadruped_direct": (quadruped, ("quadruped", "gait2"), CONFIGURATION,
                         "direct"),
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


def problem(name, n_opts=N_OPTS, seed=0):
    """(NewtonSolve, its arguments) of one Newton solve of ``name``: the
    gait's first window, the measured configurations the reference's plus
    0.01·N(0, 1) a lane from a numpy seed, a small random altitude, the
    reference as the warm start (structure mode: its stages, moved by
    0.001·N(0, 1)) and zero duals."""
    model, gait, mode, newton_mode = CASES[name]
    env = flat_2d_lc
    dims = dims_of(model, env)
    ref = from_gait(model, env, load_gait(*gait), kappa=KAPPA,
                    update_friction=model is quadruped, **F64)
    if model is quadruped:
        obj = quadruped_tracking_weights(dims, H, **F64)
    else:
        qw = np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (H, 1))
        vw = np.tile(1e-3 * np.array([0.1, 3, 1, 3]), (H, 1))
        obj = tracking_velocity_objective(
            dims, H, q=qw, v=vw, u=np.tile([3e-3, 1e0], (H, 1)),
            gamma=1e-4 * np.ones((H, dims.nc)),
            b=1e-4 * np.ones((H, dims.nb)), **F64)
    rng = np.random.default_rng(seed)
    noise = lambda *shape, s: torch.as_tensor(
        s * rng.standard_normal(shape), **F64)
    q0 = ref.q[0] + noise(LANES, dims.nq, s=0.01)
    q1 = ref.q[1] + noise(LANES, dims.nq, s=0.01)
    alt = noise(LANES, dims.nc, s=1e-3)
    lin = linearize_trajectory(model, env, ref, KAPPA)
    window = slice_horizon(ref, H)
    ip_opts = default_mpc_ip_options(KAPPA)
    solve = NewtonSolve(dims, mode, obj, H, ip_opts, n_opts, newton_mode)
    if newton_mode == "structure":
        q_ref, u_ref = window.q[:H + 1], window.u[:H - 1]
        st = state_from_reference(q_ref, u_ref, dims, H)
        st = StructureState(*(x + noise(LANES, *x.shape, s=1e-3)
                              for x in st))
        args = (gather(lin, np.arange(H - 1)), q_ref, u_ref,
                window.theta[:H - 1], q0, q1, st, alt)
    else:
        nu = torch.zeros((LANES, H, nd_of(dims, mode)), **F64)
        args = (gather(lin, np.arange(H)), window, expand_traj(window, (LANES,)),
                nu, q0, q1, alt)
    return solve, args


def pieces(name):
    """What ``control/graphs.py`` captures for ``name``: the whole
    structure-mode solve, or the direct program's start, trip and live
    flag, and the whole fixed-iteration direct solve."""
    solve, args = problem(name)
    if solve.structure:
        yield "solve", lambda: solve._eager(*args)
        return
    prog = newton_program(solve.dims, solve.mode, solve.assembler, solve.obj,
                          *args, solve.ip_opts, solve.opts)
    state = prog.start()
    yield "start", prog.start
    yield "trip", lambda: prog.trip(state)
    yield "live", lambda: prog.live(state).any()
    fixed = dataclasses.replace(solve.opts, fixed_newton_iters=2)
    prog_fixed = newton_program(solve.dims, solve.mode, solve.assembler,
                                solve.obj, *args, solve.ip_opts, fixed)
    yield "fixed solve", lambda: run_newton(prog_fixed, fixed)


def record(fn):
    fn()                                   # warm-up
    with Recorder() as rec:
        fn()
    return rec.ops


def equal(got, want):
    """Every leaf of two results equal, bit for bit."""
    a, b = tree_leaves(got), tree_leaves(want)
    assert type(got) is type(want) and len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", list(CASES))
def test_captured_newton_pieces_read_nothing_from_the_host(name):
    found = {}
    for piece, fn in pieces(name):
        ops = record(fn)
        assert len(ops) > (100 if piece != "live" else 0), (piece, len(ops))
        bad = sorted(set(ops) & (HOST_READS | HOST_DATA))
        if bad:
            found[piece] = bad
    assert not found, found


@pytest.mark.parametrize("name", list(CASES))
def test_newton_solve_on_cpu_tensors_is_the_eager_solve(name):
    """On CPU tensors ``NewtonSolve`` is ``structure_newton_solve`` /
    ``newton_solve``: the same result bit for bit, and no graph."""
    solve, args = problem(name)
    assert solve.route(args[-1]) == "eager"
    got = solve(*args)
    if solve.structure:
        want = structure_newton_solve(solve.dims, solve.sobj, *args,
                                      solve.ip_opts, solve.opts, H)
    else:
        want = newton_solve(solve.dims, solve.mode, solve.assembler,
                            solve.obj, *args, solve.ip_opts, solve.opts)
    assert not solve.graph_sets
    equal(got, want)
    assert int(got.iterations.max()) > 0


@pytest.mark.parametrize("name", ["hopper_direct_configuration",
                                  "hopper_direct_configurationforce",
                                  "quadruped_direct"])
@pytest.mark.parametrize("fixed_newton", [0, 3])
def test_program_equals_the_loop_it_was_cut_from(name, fixed_newton):
    """``newton_solve``, ``newton_program``'s pieces driven by
    ``run_newton``, equals ``loop_reference`` bit for bit; the second
    lane's warm start holds a NaN (the sanitizing), and the Newton
    budget lets lanes stop at different trips."""
    opts = dataclasses.replace(N_OPTS, max_iter=4,
                               fixed_newton_iters=fixed_newton)
    solve, args = problem(name, opts)
    lin, ref, traj, nu, q0, q1, alt = args
    traj = traj._replace(u=traj.u.clone())
    traj.u[1, 0, 0] = float("nan")
    args = (lin, ref, traj, nu, q0, q1, alt)
    got = newton_solve(solve.dims, solve.mode, solve.assembler, solve.obj,
                       *args, solve.ip_opts, opts)
    want = loop_reference(solve.dims, solve.mode, solve.assembler,
                          solve.obj, *args, solve.ip_opts, opts)
    equal(got, want)
    assert bool(torch.isfinite(got.traj.u).all())


def test_route_follows_the_device_and_the_knot_solve():
    """``"graphs"`` only for CUDA tensors with fixed knot solves; the
    adaptive knot solve reads the device inside a trip and stays eager."""
    solve, _ = problem("hopper_direct_configuration")
    card = types.SimpleNamespace(is_cuda=True)
    assert solve.route(card) == "graphs"
    adaptive, _ = problem("hopper_direct_configuration",
                          dataclasses.replace(N_OPTS, fixed_ip_iters=0))
    assert adaptive.route(card) == "eager"
    assert solve.route(torch.zeros(1)) == "eager"


def loop_reference(dims, mode, assembler, obj, lin, ref, traj, nu, q0, q1,
                   alt, ip_opts, opts):
    """``newton_solve`` as one loop, before it was cut into
    ``newton_program``'s pieces: the reference the pieces are held to bit
    for bit."""
    dtype = traj.q.dtype
    device = traj.q.device
    batch = traj.q.shape[0]
    kappa = ip_opts.kappa_tol

    # sanitize the warm start: any non-finite leaf (a diverged previous
    # float32 solve) falls back to the reference value
    traj = ContactTraj(traj.h, traj.kappa, *(
        torch.where(torch.isfinite(w), w, r)
        for w, r in zip(traj[2:], ref[2:])))
    nu = torch.where(torch.isfinite(nu), nu, torch.zeros_like(nu))

    # reset (newton.jl:130-167): pin the measured configurations
    q = torch.cat([q0[:, None], q1[:, None], traj.q[:, 2:]], dim=1)
    traj = update_theta(dims, traj._replace(q=q))

    def imp_of(tr, alt_):
        return implicit_dynamics(dims, mode, lin, tr, alt_, ip_opts,
                                 fixed_iters=opts.fixed_ip_iters)

    imp = imp_of(traj, alt)
    r = assembler.residual(obj, imp, traj, ref, nu)
    r_norm = torch.sum(torch.abs(r), dim=-1)
    n_total = r.shape[-1]

    n_ls = opts.max_ls + 1
    alphas = 0.5 ** torch.arange(n_ls, dtype=dtype, device=device)
    alt_t = alt[:, None, :].expand(batch, n_ls, dims.nc)
    lane = torch.arange(batch, device=device)
    beta = torch.full((batch,), opts.beta_init, dtype=dtype, device=device)
    it = torch.zeros((batch,), dtype=torch.int32, device=device)
    bounded = np.isfinite(opts.ls_growth_allow)
    # unpivoted LDLᵀ is safe on the quasidefinite KKT only while the primal
    # diagonal stays meaningfully nonzero: in float32 the reference's 1e-100
    # γ/b objective weights (configurationforce) underflow to exactly 0 and
    # the rank-1 trailing update overflows — pivoted LU there
    use_ldl = (opts.kkt_solver == "ldl"
               and not (dtype == torch.float32
                        and mode == CONFIGURATION_FORCE))

    def kkt_solve(jac, r_c):
        if use_ldl:
            return ldl_solve(jac, r_c)
        # nothing is raised and nothing read back: a singular matrix gives
        # a non-finite step, which the guard in the body rejects
        return torch.linalg.solve_ex(jac, r_c[..., None])[0][..., 0]

    def body(traj_c, nu_c, beta_c, imp_c, r_c, r_norm_c):
        jac = assembler.jacobian(obj, imp_c, beta_c, kappa, dtype)
        delta = kkt_solve(jac, r_c)
        # the line search over α ∈ {1, 1/2, …, 2⁻⁶}: one batch (B, n_ls)
        trials = ContactTraj(traj_c.h, traj_c.kappa, *(
            x[:, None].expand((batch, n_ls) + x.shape[1:])
            for x in traj_c[2:]))
        trs, nns = assembler.apply_step(dims, trials, nu_c[:, None],
                                        delta[:, None], alphas[None, :])
        ims = imp_of(trs, alt_t)
        rrs = assembler.residual(obj, ims, trs, ref, nns)
        rns = torch.sum(torch.abs(rrs), dim=-1)                 # (B, n_ls)
        accept = rns ** 2 < (1.0 - 1.0e-3 * alphas) * r_norm_c[:, None] ** 2
        any_ok = accept.any(dim=1)
        # first (largest-α) passing trial; else the fallback: the
        # reference's smallest-α forced step when the growth bound is off,
        # the least-bad finite trial when it is on
        if bounded:
            fallback = torch.where(torch.isfinite(rns), rns,
                                   torch.inf).argmin(dim=1)
        else:
            fallback = torch.full_like(lane, n_ls - 1)
        pick = torch.where(any_ok, accept.to(torch.int8).argmax(dim=1),
                           fallback)
        take = lambda x: x if x.dim() == 0 else x[lane, pick]
        rn_pick = take(rns)
        # keep the current iterate on a non-finite step or (when
        # ls_growth_allow is finite) one growing the residual beyond the
        # bound — stale values and another try next period
        ok = torch.isfinite(rn_pick)
        if bounded:
            ok = ok & (rn_pick <= opts.ls_growth_allow * r_norm_c)
        # regularization update (newton.jl:280)
        beta_n = torch.where(any_ok, torch.clamp(beta_c / 1.3, min=1.0e1),
                             torch.clamp(beta_c * 1.3, max=1.0e2))
        pick_of = lambda xs: type(xs)(*(take(x) for x in xs))
        return (ok, pick_of(trs), take(nns), beta_n, pick_of(ims), take(rrs),
                rn_pick)

    trips = opts.fixed_newton_iters if opts.fixed_newton_iters > 0 else None
    trip = 0
    while True:
        live = ~(r_norm / n_total < opts.r_tol)   # a NaN residual is live
        if trips is None:
            # the adaptive loop's one read from the device a trip
            live = live & (it < opts.max_iter)
            if not bool(live.any()):
                break
        elif trip == trips:
            break
        trip += 1
        ok, traj_n, nu_n, beta_n, imp_n, r_n, rn_n = body(
            traj, nu, beta, imp, r, r_norm)
        upd = live & ok
        traj = _where(upd, traj_n, traj)
        imp = _where(upd, imp_n, imp)
        sel = lambda n, o: torch.where(
            upd.view((-1,) + (1,) * (o.dim() - 1)), n, o)
        nu, r, r_norm = sel(nu_n, nu), sel(r_n, r), sel(rn_n, r_norm)
        beta = torch.where(live, beta_n, beta)
        it = it + live.to(torch.int32)
    return NewtonResult(traj=traj, nu=nu, beta=beta, r_norm=r_norm,
                        iterations=it)
