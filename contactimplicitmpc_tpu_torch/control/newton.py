"""Newton solve over the MPC horizon, direct mode: the dense horizon KKT.

PyTorch counterpart of ``contactimplicitmpc_tpu/control/newton.py``
(newton.jl, newton_indices.jl, newton_residual.jl, newton_jacobian.jl).

Problem: track a reference contact trajectory subject to the smooth
implicit dynamics, with per-knot decision blocks ``[u, (γ, b,) q2]`` and
dynamics multipliers ν. The KKT matrix of every lane is assembled densely
through static index tensors and solved by one batched dense solve: the
unpivoted LDLᵀ, on CUDA tensors one launch of the hand-written kernel
``csrc/ldl.cu`` (``ops/ldl.py``), on CPU tensors ``ops/linsolve.py``'s.

* residual (newton_residual.jl:113-138, 178-281): objective gradient +
  sensitivity-transposed dual terms + dynamics violation − ν
* Jacobian (newton_jacobian.jl:148-248): objective Hessian, −I dual
  coupling, ∂z*/∂(q0,q1,u1) blocks + transposes, dual regularization
  ``−Σ_t β κ`` on the dual diagonal
* damped line search: α halving (≤ 6) on ``‖r‖₁²`` with Armijo constant
  1e-3 (newton.jl:222-269); the 7 trial points of every lane are one
  batched implicit-dynamics solve and the largest passing α is selected
* β update: failures → ×1.3 (cap 1e2), successes → max(1e1, β/1.3)
  (newton.jl:280)
* a fixed iteration budget replaces the wall-clock ``max_time``

Every lane carries its own iterate, β, residual and iteration count. The
adaptive loop runs while any lane is live and reads that one flag from the
device each trip; ``fixed_newton_iters > 0`` runs masked trips and reads
nothing. The loop is a program of pieces (``newton_program``: start, live,
trip, finish) that ``newton_solve`` drives eagerly and
``control/graphs.py`` replays as CUDA graphs on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..dims import Dims
from ..ops.ldl import ldl
from ..sim.interior_point import IPOptions
from ..utils.cuda_graphs import capturable_linalg
from .implicit_dynamics import (CONFIGURATION, CONFIGURATION_FORCE,
                                ImplicitDynamicsResult, implicit_dynamics,
                                nd_of)
from .linearized import LinearizedData
from .objective import TrackingVelocityObjective
from .trajectory import ContactTraj, update_theta, update_z


@dataclasses.dataclass(frozen=True)
class NewtonOptions:
    """NewtonOptions (newton.jl:2-11); ``max_time`` is replaced by the
    ``max_iter`` budget. Field names match the JAX package's."""

    r_tol: float = 1.0e-5
    max_iter: int = 10
    beta_init: float = 1.0e-5
    max_ls: int = 6
    fixed_ip_iters: int = 0  # >0: fixed-iteration knot solves (the knot
    #                          kernel); 0: the adaptive knot solve
    trial_ip_iters: int = 0  # >0 and < fixed_ip_iters: line-search trial
    #                          knot solves run this reduced budget and the
    #                          accepted candidate is solved again at the
    #                          full one (structure mode only)
    fixed_newton_iters: int = 0  # >0: exactly this many masked Newton
    #                              iterations instead of the adaptive loop;
    #                              converged lanes pass through untouched
    kkt_solver: str = "ldl"  # horizon-KKT backend: "ldl" = unpivoted LDLᵀ
    #                          (ops/linsolve.py; the ±β-regularized KKT is
    #                          quasidefinite), "lu" = pivoted LU
    ls_growth_allow: float = float("inf")
    # line-search fallback residual-growth bound when no trial passes
    # Armijo: inf reproduces the reference's unconditional forced step;
    # a finite value rejects steps growing the residual by more than that
    # factor and keeps the stale iterate instead


class NewtonIndices:
    """Static block layout of the KKT system (newton_indices.jl:1-105).

    Per-knot primal block (size nr): ``[u, γ, b, q2]`` (configurationforce)
    or ``[u, q2]`` (configuration); dual blocks (size nd) follow all primal
    blocks.
    """

    def __init__(self, dims: Dims, horizon: int, mode: str):
        nq, nu, nc, nb = dims.nq, dims.nu, dims.nc, dims.nb
        self.mode = mode
        self.horizon = horizon
        self.nd = nd_of(dims, mode)
        if mode == CONFIGURATION_FORCE:
            self.nr = nu + nc + nb + nq
            self.iu = np.arange(nu)
            self.ig = nu + np.arange(nc)
            self.ib = nu + nc + np.arange(nb)
            self.iq = nu + nc + nb + np.arange(nq)
            self.iz = np.concatenate([self.iq, self.ig, self.ib])
        else:
            self.nr = nu + nq
            self.iu = np.arange(nu)
            self.iq = nu + np.arange(nq)
            self.iz = self.iq.copy()
        self.ntot = horizon * (self.nr + self.nd)
        self.primal_off = np.arange(horizon) * self.nr
        self.dual_off = horizon * self.nr + np.arange(horizon) * self.nd

    def q_rows(self, t: int) -> np.ndarray:
        return self.primal_off[t] + self.iq

    def u_rows(self, t: int) -> np.ndarray:
        return self.primal_off[t] + self.iu

    def nu_rows(self, t: int) -> np.ndarray:
        return self.dual_off[t] + np.arange(self.nd)


def _next_rows(x, shift: int):
    """x[t + shift] along the knot axis (-2), zeros past the horizon."""
    return torch.cat([x[..., shift:, :], torch.zeros_like(x[..., :shift, :])],
                     dim=-2)


class NewtonAssembler:
    """Static index tensors for one (dims, horizon, mode), made once; they
    move to the device of the first tensors they meet.

    The Jacobian is filled through flat positions ``row · ntot + col`` of
    the (ntot, ntot) matrix. The sensitivity blocks of the first knots
    reach before the horizon (q0 of knots 0-1, q1 of knot 0): those blocks
    are left out when the positions are built, so no index is out of
    range.
    """

    def __init__(self, dims: Dims, horizon: int, mode: str):
        self.dims = dims
        self.ind = ind = NewtonIndices(dims, horizon, mode)
        h, n = horizon, ind.ntot

        def blocks(rows, cols):
            """Flat positions of the blocks rows[t] × cols[t] and of their
            transposes, each (T · nd · n_col,)."""
            r, c = rows[:, :, None], cols[:, None, :]
            return (r * n + c).reshape(-1), (c * n + r).reshape(-1)

        diag = lambda i: i * n + i
        # objective Hessian and dual diagonals
        self.diag_primal = diag((ind.primal_off[:, None]
                                 + np.arange(ind.nr)[None, :]).reshape(-1))
        self.diag_dual = diag((ind.dual_off[:, None]
                               + np.arange(ind.nd)[None, :]).reshape(-1))
        # −I coupling (IV/ITV): primal rows iz_t against dual columns t
        iv_rows = (ind.primal_off[:, None] + ind.iz[None, :]).reshape(-1)
        iv_cols = (ind.dual_off[:, None]
                   + np.arange(ind.nd)[None, :]).reshape(-1)
        self.coupling = np.concatenate([iv_rows * n + iv_cols,
                                        iv_cols * n + iv_rows])
        # sensitivity blocks: dual rows of knot t against the q2 columns of
        # knots t−2 and t−1 and the u columns of knot t
        nu_rows = np.stack([ind.nu_rows(t) for t in range(h)])
        q_cols = np.stack([ind.q_rows(t) for t in range(h)])
        u_cols = np.stack([ind.u_rows(t) for t in range(h)])
        self.q0_blocks = blocks(nu_rows[2:], q_cols[:max(h - 2, 0)])
        self.q1_blocks = blocks(nu_rows[1:], q_cols[:max(h - 1, 0)])
        self.u_blocks = blocks(nu_rows, u_cols)
        # velocity-objective off-diagonals between q2[t] and q2[t+1]
        vr, vc = q_cols[:max(h - 1, 0)].reshape(-1), q_cols[1:].reshape(-1)
        self.velocity = np.concatenate([vr * n + vc, vc * n + vr])
        self._on = {}

    def _index(self, name: str, device):
        """A position array as an int64 tensor on ``device``, made once."""
        key = (name, torch.device(device))
        if key not in self._on:
            value = getattr(self, name)
            self._on[key] = (tuple(torch.as_tensor(v, device=device)
                                   for v in value)
                             if isinstance(value, tuple)
                             else torch.as_tensor(value, device=device))
        return self._on[key]

    # ------------------------------------------------------------------
    def hessian_diag(self, obj) -> torch.Tensor:
        """Per-knot primal diagonal weights (hessian!, newton_jacobian.jl:
        200-248), including velocity-coupling additions."""
        q_w = obj.q
        if isinstance(obj, TrackingVelocityObjective):
            # obj_q2[t−1] += v[t] (t ≥ 2, 1-based) → knot j gains v[j+1]
            q_w = q_w + obj.v + _next_rows(obj.v, 1)
        if self.ind.mode == CONFIGURATION_FORCE:
            blocks = torch.cat([obj.u, obj.gamma, obj.b, q_w], dim=1)
        else:
            blocks = torch.cat([obj.u, q_w], dim=1)
        return blocks.reshape(-1)

    def jacobian(self, obj, imp: ImplicitDynamicsResult, beta, kappa,
                 dtype) -> torch.Tensor:
        """(B, ntot, ntot) from ``imp`` with leading shape (B, H) and
        ``beta`` (B,); the objective and ``kappa`` are shared."""
        ind = self.ind
        h, n = ind.horizon, ind.ntot
        device = imp.d.device
        batch = imp.d.shape[0]
        at = lambda name: self._index(name, device)

        # the lanes' common part: objective Hessian, velocity couplings
        # −v[t] (newton_jacobian.jl:218-233) and the −I dual coupling
        base = torch.zeros((n * n,), dtype=dtype, device=device)
        base.index_add_(0, at("diag_primal"), self.hessian_diag(obj).to(dtype))
        if isinstance(obj, TrackingVelocityObjective) and h > 1:
            v = -obj.v[1:].reshape(-1).to(dtype)
            base.index_add_(0, at("velocity"), torch.cat([v, v]))
        base.index_add_(0, at("coupling"),
                        -torch.ones_like(at("coupling"), dtype=dtype))

        mat = base.expand(batch, n * n).clone()
        # sensitivity blocks and their transposes
        for name, blk in (("q0_blocks", imp.dq0[:, 2:]),
                          ("q1_blocks", imp.dq1[:, 1:]),
                          ("u_blocks", imp.du1)):
            pos, pos_t = at(name)
            flat = blk.reshape(batch, -1)
            mat.index_add_(1, pos, flat)
            mat.index_add_(1, pos_t, flat)
        # dual regularization: each knot subtracts β·κ from the whole dual
        # diagonal (update_jacobian!, newton_jacobian.jl:183-186)
        dual = at("diag_dual")
        mat.index_add_(1, dual, (-beta * kappa * h)[:, None].expand(
            batch, dual.shape[0]))
        return mat.view(batch, n, n)

    # ------------------------------------------------------------------
    def residual(self, obj, imp: ImplicitDynamicsResult, traj: ContactTraj,
                 ref: ContactTraj, nu) -> torch.Tensor:
        """newton_residual.jl:113-138 + gradient! variants (:178-281), for
        any leading shape of ``imp``, ``traj`` and ``nu``; ``ref`` and the
        objective are shared."""
        ind = self.ind
        h = ind.horizon
        velocity = isinstance(obj, TrackingVelocityObjective)

        dq = traj.q[..., 2:, :] - ref.q[2:h + 2]
        if velocity:
            dq = dq - obj.q_target
        g_q = obj.q * dq
        g_u = obj.u * (traj.u - ref.u)

        if velocity:
            vel = obj.v * (traj.q[..., 2:, :] - traj.q[..., 1:h + 1, :])
            if ind.mode == CONFIGURATION:
                vel = vel - obj.v * obj.v_target
            # res.q2[t−1] −= v[t]·(…) for t ≥ 2 (1-based)
            g_q = g_q + vel - _next_rows(vel, 1)

        # dual terms: res.q2[j] += δq0[j+2]ᵀν[j+2] + δq1[j+1]ᵀν[j+1]
        mtv = lambda m: (m.mT @ nu[..., None])[..., 0]
        g_q = g_q + _next_rows(mtv(imp.dq0), 2) + _next_rows(mtv(imp.dq1), 1)
        g_u = g_u + mtv(imp.du1)

        # −ν on the decision slots (rI)
        if ind.mode == CONFIGURATION_FORCE:
            nq, nc = self.dims.nq, self.dims.nc
            g_q = g_q - nu[..., :nq]
            g_g = obj.gamma * (traj.gamma - ref.gamma) - nu[..., nq:nq + nc]
            g_b = obj.b * (traj.b - ref.b) - nu[..., nq + nc:]
            primal = torch.cat([g_u, g_g, g_b, g_q], dim=-1)
        else:
            primal = torch.cat([g_u, g_q - nu], dim=-1)
        return torch.cat([primal.flatten(-2), imp.d.flatten(-2)], dim=-1)

    # ------------------------------------------------------------------
    def unpack_step(self, delta):
        """Split the flat Newton step (..., ntot) into per-knot
        (Δu, Δγ, Δb, Δq2, Δν)."""
        ind = self.ind
        h = ind.horizon
        lead = delta.shape[:-1]
        primal = delta[..., :h * ind.nr].reshape(lead + (h, ind.nr))
        dnu = delta[..., h * ind.nr:].reshape(lead + (h, ind.nd))
        cut = lambda i: primal[..., int(i[0]):int(i[-1]) + 1]
        if ind.mode == CONFIGURATION_FORCE:
            dg, db = cut(ind.ig), cut(ind.ib)
        else:
            dg = db = None
        return cut(ind.iu), dg, db, cut(ind.iq), dnu

    def apply_step(self, dims: Dims, traj: ContactTraj, nu, delta, alpha):
        """update_traj! (newton_residual.jl:140-176); ``alpha`` is a number
        or a tensor of the leading shape of ``delta``."""
        if isinstance(alpha, torch.Tensor):
            alpha = alpha[..., None, None]
        du, dg, db, dq, dnu = self.unpack_step(delta)
        q = torch.cat([traj.q[..., :2, :], traj.q[..., 2:, :] - alpha * dq],
                      dim=-2)
        out = traj._replace(
            q=q, u=traj.u - alpha * du,
            gamma=traj.gamma if dg is None else traj.gamma - alpha * dg,
            b=traj.b if db is None else traj.b - alpha * db)
        out = update_theta(dims, update_z(dims, out))
        return out, nu - alpha * dnu


class NewtonResult(NamedTuple):
    traj: ContactTraj        # leaves (B, ...)
    nu: torch.Tensor         # (B, H, nd)
    beta: torch.Tensor       # (B,)
    r_norm: torch.Tensor     # (B,)
    iterations: torch.Tensor  # (B,) int32


def _where(mask, new, old):
    """Per-lane selection over a tuple of tensors; 0-d leaves (a
    trajectory's ``h`` and ``kappa``) pass through."""
    return type(old)(*(o if o.dim() == 0 else torch.where(
        mask.view((-1,) + (1,) * (o.dim() - 1)), n, o)
        for n, o in zip(new, old)))


class NewtonState(NamedTuple):
    """The carry of the Newton loop: the iterate and what a trip needs of
    it, leaves (B, ...)."""

    traj: ContactTraj
    nu: torch.Tensor
    beta: torch.Tensor
    imp: ImplicitDynamicsResult
    r: torch.Tensor
    r_norm: torch.Tensor
    it: torch.Tensor


class NewtonProgram(NamedTuple):
    """``newton_solve``'s loop cut at its trips into functions of tensors
    alone, none of which reads a value back to the host: ``start()`` the
    carry at the sanitized, pinned warm start; ``live(s)`` the lanes the
    next trip advances; ``trip(s)`` one masked trip (the KKT assembled and
    solved, the line search, the β update); ``finish(s)`` the
    ``NewtonResult``. ``run_newton`` drives them eagerly;
    ``control/graphs.py`` captures them as CUDA graphs."""

    start: Callable
    live: Callable
    trip: Callable
    finish: Callable


def newton_program(dims: Dims, mode: str, assembler: NewtonAssembler, obj,
                   lin: LinearizedData, ref: ContactTraj, traj: ContactTraj,
                   nu, q0, q1, alt, ip_opts: IPOptions,
                   opts: NewtonOptions) -> NewtonProgram:
    """``newton_solve``'s program (``NewtonProgram``) over the tensors of
    its arguments, which its functions read when they are called."""
    dtype = traj.q.dtype
    device = traj.q.device
    batch = traj.q.shape[0]
    kappa = ip_opts.kappa_tol
    n_total = assembler.ind.ntot

    def imp_of(tr, alt_):
        return implicit_dynamics(dims, mode, lin, tr, alt_, ip_opts,
                                 fixed_iters=opts.fixed_ip_iters)

    n_ls = opts.max_ls + 1
    alphas = 0.5 ** torch.arange(n_ls, dtype=dtype, device=device)
    alt_t = alt[:, None, :].expand(batch, n_ls, dims.nc)
    lane = torch.arange(batch, device=device)
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
            return ldl(jac, r_c)
        # nothing is raised and nothing read back: a singular matrix gives
        # a non-finite step, which the guard in the body rejects
        with capturable_linalg(jac):
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

    def start():
        # sanitize the warm start: any non-finite leaf (a diverged previous
        # float32 solve) falls back to the reference value
        tr = ContactTraj(traj.h, traj.kappa, *(
            torch.where(torch.isfinite(w), w, r)
            for w, r in zip(traj[2:], ref[2:])))
        nu_s = torch.where(torch.isfinite(nu), nu, torch.zeros_like(nu))
        # reset (newton.jl:130-167): pin the measured configurations
        q = torch.cat([q0[:, None], q1[:, None], tr.q[:, 2:]], dim=1)
        tr = update_theta(dims, tr._replace(q=q))
        imp = imp_of(tr, alt)
        r = assembler.residual(obj, imp, tr, ref, nu_s)
        r_norm = torch.sum(torch.abs(r), dim=-1)
        beta = torch.full((batch,), opts.beta_init, dtype=dtype,
                          device=device)
        it = torch.zeros((batch,), dtype=torch.int32, device=device)
        return NewtonState(tr, nu_s, beta, imp, r, r_norm, it)

    def live(s):
        lv = ~(s.r_norm / n_total < opts.r_tol)   # a NaN residual is live
        if opts.fixed_newton_iters <= 0:
            lv = lv & (s.it < opts.max_iter)
        return lv

    def trip(s):
        lv = live(s)
        ok, traj_n, nu_n, beta_n, imp_n, r_n, rn_n = body(
            s.traj, s.nu, s.beta, s.imp, s.r, s.r_norm)
        upd = lv & ok
        sel = lambda n, o: torch.where(
            upd.view((-1,) + (1,) * (o.dim() - 1)), n, o)
        return NewtonState(
            traj=_where(upd, traj_n, s.traj), nu=sel(nu_n, s.nu),
            beta=torch.where(lv, beta_n, s.beta),
            imp=_where(upd, imp_n, s.imp), r=sel(r_n, s.r),
            r_norm=sel(rn_n, s.r_norm), it=s.it + lv.to(torch.int32))

    def finish(s):
        return NewtonResult(traj=s.traj, nu=s.nu, beta=s.beta,
                            r_norm=s.r_norm, iterations=s.it)

    return NewtonProgram(start, live, trip, finish)


def run_newton(prog: NewtonProgram, opts: NewtonOptions) -> NewtonResult:
    """Drive ``prog``: ``opts.fixed_newton_iters`` trips with no read from
    the device, or trips while a lane is live with one read of that flag a
    trip (the adaptive loop); then ``finish``."""
    s = prog.start()
    if opts.fixed_newton_iters > 0:
        for _ in range(opts.fixed_newton_iters):
            s = prog.trip(s)
    else:
        while bool(prog.live(s).any()):    # one read a trip
            s = prog.trip(s)
    return prog.finish(s)


def newton_solve(dims: Dims, mode: str, assembler: NewtonAssembler, obj,
                 lin: LinearizedData, ref: ContactTraj, traj: ContactTraj,
                 nu, q0, q1, alt, ip_opts: IPOptions,
                 opts: NewtonOptions) -> NewtonResult:
    """One MPC Newton solve (newton_solve!, newton.jl:169-288) for a batch
    of lanes: the working trajectory ``traj`` with leaves (B, ...), duals
    ``nu`` (B, H, nd), measured ``q0``, ``q1`` (B, nq), ``alt`` (B, nc).
    ``lin`` (gathered to the horizon window), ``ref`` and the objective
    are shared by the lanes. The loop is ``newton_program``'s, driven
    eagerly (``run_newton``)."""
    return run_newton(newton_program(dims, mode, assembler, obj, lin, ref,
                                     traj, nu, q0, q1, alt, ip_opts, opts),
                      opts)
