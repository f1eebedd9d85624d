"""Structured O(H) horizon-KKT solver (Riccati-style block elimination) —
the structure-mode Newton solve of the MPC.

PyTorch counterpart of ``contactimplicitmpc_tpu/control/structure_solver.py``.
Problem (newton_structure_solver/methods.jl:1-12)::

    [S  Cᵀ] [Δz]   [rlag]
    [C  0 ] [Δν] = [rdyn]

with per-stage states x_t = (qa_t, qb_t) = (q_{t}, q_{t+1}) and the
constraints ν1_t: qa_{t+1} − qb_t = 0 and ν2_t: qb_{t+1} − z*(qa_t, qb_t,
u_t) = 0. ``Y = C S⁻¹ Cᵀ`` is block tridiagonal with 2nq blocks, factored
by a block Cholesky sweep and solved by one forward and one backward
substitution, each a Python loop over the stages: ``structure_kkt_solve``,
the plain version. On CUDA tensors ``structure_newton_solve`` solves the
KKT through ``ops/structure_kkt.py``, one launch of the hand-written kernel
``csrc/structure_kkt.cu`` a solve (``control/graphs.py`` replays the whole
``structure_newton_solve`` as one CUDA graph); the plain version's sweep,
where it runs on the card, takes cuSOLVER's and cuBLAS's routines
(``capturable_linalg``).

Every function takes an optional leading batch shape (lanes, and lanes ×
line-search trials); the objective and the reference window broadcast.
Arrays carry one dummy leading stage so the formulas read as the 1-based
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dims import Dims
from ..ops.knot_ip import knot_ip
from ..ops.linsolve import mv
from ..ops.structure_kkt import route as kkt_route
from ..ops.structure_kkt import structure_kkt
from ..sim.interior_point import IPOptions
from ..utils.cuda_graphs import capturable_linalg
from .implicit_dynamics import adaptive_knot_solve
from .linearized import LinearizedData
from .newton import NewtonOptions
from .objective import TrackingVelocityObjective


def _mtv(m, v):
    """mᵀ v over the last two axes of m."""
    return mv(m.mT, v)


def _pad(x, axis):
    """Prepend one zero stage along ``axis`` (the dummy 1-based row)."""
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    return torch.cat([zero, x], dim=axis)


def _next(x, axis):
    """x[t+1] along ``axis`` with a zero last stage."""
    n = x.shape[axis]
    return torch.cat([x.narrow(axis, 1, n - 1),
                      torch.zeros_like(x.narrow(axis, 0, 1))], dim=axis)


class StructureObjective(NamedTuple):
    """Per-stage (qa, qb) objective blocks and their inverses
    (update_objective!, methods.jl:598-628), 1-based padded."""

    qa: torch.Tensor    # (H+1, nq, nq)
    qb: torch.Tensor
    qv: torch.Tensor
    ra: torch.Tensor    # (H+1, nu, nu)
    qat: torch.Tensor   # inverses
    qbt: torch.Tensor
    qvt: torch.Tensor
    rat: torch.Tensor


def build_structure_objective(dims: Dims, q_weight, v_weight, u_weight,
                              beta: float, horizon: int) -> StructureObjective:
    """Map per-knot diagonal weights (q: (H+1, nq), v: (H+1, nq),
    u: (H+1, nu), 1-based padded) to the (qa, qb) stage blocks."""
    h = horizon
    nq, nu = dims.nq, dims.nu
    dtype, device = q_weight.dtype, q_weight.device

    t = torch.arange(h + 1, device=device)
    c1 = torch.where(t > 1, 0.5, 1.0).to(dtype)
    c2 = torch.where(t < h, 0.5, 1.0).to(dtype)
    eye_q = torch.eye(nq, dtype=dtype, device=device)

    qa = torch.diag_embed(c1[:, None] * q_weight + v_weight) + beta * eye_q
    qb = torch.diag_embed(c2[:, None] * q_weight + v_weight) + beta * eye_q
    qv = torch.diag_embed(-v_weight)
    ra = (torch.diag_embed(u_weight)
          + beta * torch.eye(nu, dtype=dtype, device=device))

    # block-2×2 inverse per stage
    big = torch.cat([torch.cat([qa, qv], dim=2),
                     torch.cat([qv.mT, qb], dim=2)], dim=1)
    big_inv = torch.linalg.inv(big)
    return StructureObjective(qa=qa, qb=qb, qv=qv, ra=ra,
                              qat=big_inv[:, :nq, :nq].contiguous(),
                              qbt=big_inv[:, nq:, nq:].contiguous(),
                              qvt=big_inv[:, :nq, nq:].contiguous(),
                              rat=torch.linalg.inv(ra))


def compute_y_blocks(obj: StructureObjective, aa, ab, ba, beta, horizon):
    """Y = C S⁻¹ Cᵀ block assembly (compute_Y!, methods.jl:386-448).

    ``aa, ab, ba`` are (..., H, nq, ·) 1-based padded Jacobian stacks
    (rows 1..H-1 valid). Returns Yii (..., H-1, 2nq, 2nq) and
    Yij (..., H-2, 2nq, 2nq).
    """
    nq = aa.shape[-1]
    h = horizon
    qat, qbt, qvt, rat = obj.qat, obj.qbt, obj.qvt, obj.rat
    qat_n, qbt_n, qvt_n = qat[2:h + 1], qbt[2:h + 1], qvt[2:h + 1]
    qat_c, qbt_c, qvt_c = qat[1:h], qbt[1:h], qvt[1:h]
    aa_c, ab_c, ba_c = aa[..., 1:h, :, :], ab[..., 1:h, :, :], ba[..., 1:h, :, :]
    rat_c = rat[1:h]

    mask = (torch.arange(1, h, device=aa.device) > 1).to(aa.dtype)[:, None, None]

    yiia = qat_n + mask * qbt_c
    yiib = qvt_n + mask * (qvt_c @ aa_c.mT + qbt_c @ ab_c.mT)
    yiic = qvt_n + mask * (aa_c @ qvt_c + ab_c @ qbt_c)
    bab = ba_c @ rat_c @ ba_c.mT
    yiid = qbt_n + bab + mask * (
        aa_c @ qat_c @ aa_c.mT
        + aa_c @ qvt_c @ ab_c.mT
        + ab_c @ qvt_c @ aa_c.mT
        + ab_c @ qbt_c @ ab_c.mT)

    eye = torch.eye(nq, dtype=aa.dtype, device=aa.device)
    yiia = yiia + beta * eye
    yiid = yiid + beta * eye

    # off-diagonal blocks for t = 1..h-2 (uses stage t+1 Jacobians)
    aa_n, ab_n = aa[..., 2:h, :, :], ab[..., 2:h, :, :]
    yija = (-qvt[2:h]).expand(aa_n.shape)
    yijb = -(qat[2:h] @ aa_n.mT + qvt[2:h] @ ab_n.mT)
    yijc = (-qbt[2:h]).expand(aa_n.shape)
    yijd = -(qvt[2:h] @ aa_n.mT + qbt[2:h] @ ab_n.mT)

    yiia = yiia.expand(yiid.shape)
    yii = torch.cat([torch.cat([yiia, yiib], dim=-1),
                     torch.cat([yiic, yiid], dim=-1)], dim=-2)
    yij = torch.cat([torch.cat([yija, yijb], dim=-1),
                     torch.cat([yijc, yijd], dim=-1)], dim=-2)
    return yii, yij


def block_tridiag_cholesky(yii, yij):
    """L of the block-tridiagonal Y by a sweep over the stages
    (compute_L!, methods.jl:466-486). ``yij[..., k]`` couples stages k and
    k+1. A block that is not positive definite gives a factor that is NaN
    in its lower triangle, as ``jnp.linalg.cholesky`` does, so the caller's finite guard rejects the
    step; nothing is read back to the host."""
    n_stage = yii.shape[-3]
    lji_prev = torch.zeros_like(yii[..., 0, :, :])
    lii, lji = [], []
    for t in range(n_stage):
        m = yii[..., t, :, :] - lji_prev.mT @ lji_prev
        l_t, info = torch.linalg.cholesky_ex(m)
        l_t = torch.where((info != 0)[..., None, None],
                          torch.full_like(l_t, float("nan")).tril(), l_t)
        lii.append(l_t)
        if t < n_stage - 1:
            lji_prev = torch.linalg.solve_triangular(
                l_t, yij[..., t, :, :], upper=False)
            lji.append(lji_prev)
    return torch.stack(lii, dim=-3), torch.stack(lji, dim=-3)


def block_tridiag_solve(lii, lji, beta):
    """Solve Y x = β given the block Cholesky (compute_y!/compute_Δν!,
    methods.jl:506-537); β is (..., T, n)."""
    n_stage = lii.shape[-3]
    y = []
    for t in range(n_stage):
        b = beta[..., t, :, None]
        if t > 0:
            b = b - lji[..., t - 1, :, :].mT @ y[-1]
        y.append(torch.linalg.solve_triangular(lii[..., t, :, :], b,
                                               upper=False))
    x = [None] * n_stage
    for t in reversed(range(n_stage)):
        b = y[t]
        if t < n_stage - 1:
            b = b - lji[..., t, :, :] @ x[t + 1]
        x[t] = torch.linalg.solve_triangular(lii[..., t, :, :].mT, b,
                                             upper=True)
    return torch.stack([xt[..., 0] for xt in x], dim=-2)


def structure_beta(obj: StructureObjective, aa, ab, ba, rlagu, rlagqa,
                   rlagqb, rdyn1, rdyn2, horizon):
    """β, the right-hand side of Y Δν = β (compute_β!, methods.jl:487-504),
    (..., H-1, 2nq), from the residuals (1-based padded stacks)."""
    h = horizon
    qat, qbt, qvt, rat = obj.qat, obj.qbt, obj.qvt, obj.rat
    qat_n, qbt_n, qvt_n = qat[2:h + 1], qbt[2:h + 1], qvt[2:h + 1]
    qat_c, qbt_c, qvt_c = qat[1:h], qbt[1:h], qvt[1:h]
    aa_c, ab_c, ba_c = aa[..., 1:h, :, :], ab[..., 1:h, :, :], ba[..., 1:h, :, :]
    rat_c = rat[1:h]
    ru, rqa, rqb = rlagu[..., 1:h, :], rlagqa[..., 1:h, :], rlagqb[..., 1:h, :]
    rd1, rd2 = rdyn1[..., 1:h, :], rdyn2[..., 1:h, :]
    # previous-stage lagrangian rows (t-1), zero at the first stage
    rqa_p = _pad(rqa[..., :-1, :], -2)
    rqb_p = _pad(rqb[..., :-1, :], -2)
    mask = (torch.arange(1, h, device=aa.device) > 1).to(rqa.dtype)[:, None]

    beta1 = (-rd1 + mv(qat_n, rqa) + mv(qvt_n, rqb)
             - mask * (mv(qbt_c, rqb_p) + mv(qvt_c, rqa_p)))
    beta2 = (-rd2 - mv(ba_c, mv(rat_c, ru))
             + mv(qbt_n, rqb) + mv(qvt_n, rqa)
             - mask * (mv(aa_c, mv(qat_c, rqa_p))
                       + mv(ab_c, mv(qbt_c, rqb_p))
                       + mv(aa_c, mv(qvt_c, rqb_p))
                       + mv(ab_c, mv(qvt_c, rqa_p))))
    return torch.cat([beta1, beta2], dim=-1)


def structure_kkt_solve(dims: Dims, obj: StructureObjective, aa, ab, ba,
                        rlagu, rlagqa, rlagqb, rdyn1, rdyn2, beta,
                        horizon):
    """Full structured KKT solve: given residuals (1-based padded stacks),
    return (Δu, Δqa, Δqb, Δν1, Δν2) for stages 1..H-1 (padded):
    ``structure_beta``, the tridiagonal solve, and compute_Δz!
    (methods.jl:539-557). The plain version of the kernel
    ``csrc/structure_kkt.cu`` (``ops/structure_kkt.py``)."""
    h = horizon
    nq = dims.nq
    qat_n, qbt_n, qvt_n = obj.qat[2:h + 1], obj.qbt[2:h + 1], obj.qvt[2:h + 1]
    ba_c, rat_c = ba[..., 1:h, :, :], obj.rat[1:h]
    ru, rqa, rqb = rlagu[..., 1:h, :], rlagqa[..., 1:h, :], rlagqb[..., 1:h, :]
    beta_n = structure_beta(obj, aa, ab, ba, rlagu, rlagqa, rlagqb, rdyn1,
                            rdyn2, h)

    yii, yij = compute_y_blocks(obj, aa, ab, ba, beta, h)
    with capturable_linalg(yii):
        lii, lji = block_tridiag_cholesky(yii, yij)
        dnu = block_tridiag_solve(lii, lji, beta_n)
    dnu1, dnu2 = dnu[..., :nq], dnu[..., nq:]

    # Δz recovery (compute_Δz!, methods.jl:539-557)
    dnu1_n, dnu2_n = _next(dnu1, -2), _next(dnu2, -2)
    aa_n = _next(aa[..., 1:h, :, :], -3)
    ab_n = _next(ab[..., 1:h, :, :], -3)

    du = mv(rat_c, ru + _mtv(ba_c, dnu2))
    ea = rqa - dnu1 + _mtv(aa_n, dnu2_n)
    eb = rqb - dnu2 + _mtv(ab_n, dnu2_n) + dnu1_n
    dqa = mv(qat_n, ea) + mv(qvt_n, eb)
    dqb = mv(qbt_n, eb) + mv(qvt_n, ea)
    return tuple(_pad(x, -2) for x in (du, dqa, dqb, dnu1, dnu2))


# ---------------------------------------------------------------------------
# Full structure-mode Newton solve (methods.jl:640-882)
# ---------------------------------------------------------------------------

def structure_objective_from_tracking(dims: Dims, obj, beta: float,
                                      horizon: int) -> StructureObjective:
    """Map per-knot tracking weights to 1-based padded stage weights
    (quadratic_objective / update_objective!, methods.jl:591-628)."""
    def pad_rows(w, rows):
        idx = np.minimum(np.arange(rows), w.shape[0] - 1)
        return _pad(w[torch.as_tensor(idx, device=w.device)], 0)

    q_w = pad_rows(obj.q, horizon)
    v_w = (pad_rows(obj.v, horizon)
           if isinstance(obj, TrackingVelocityObjective)
           else torch.zeros_like(q_w))
    u_w = pad_rows(obj.u, horizon)
    return build_structure_objective(dims, q_w, v_w, u_w, beta, horizon)


class StructureState(NamedTuple):
    """1-based padded stage trajectories (methods.jl:29-45), with any
    leading batch shape."""

    u: torch.Tensor    # (..., H, nu)   valid 1..H-1
    qa: torch.Tensor   # (..., H+1, nq) valid 1..H; qa[1] = q0 pinned
    qb: torch.Tensor   # (..., H+1, nq) valid 1..H; qb[1] = q1 pinned
    nu1: torch.Tensor  # (..., H, nq)   valid 1..H-1
    nu2: torch.Tensor  # (..., H, nq)


def _map(fn, *states):
    return StructureState(*(fn(*leaves) for leaves in zip(*states)))


def state_from_reference(q_ref, u_ref, dims: Dims,
                         horizon: int) -> StructureState:
    """initialize_trajectories! (methods.jl:755-795). ``q_ref`` is
    (..., H+1, nq) configurations (0-based rows 0..H), ``u_ref``
    (..., H-1, nu)."""
    h = horizon
    zeros = torch.zeros_like(q_ref[..., :h, :])
    return StructureState(u=_pad(u_ref[..., :h - 1, :], -2),
                          qa=_pad(q_ref[..., :h, :], -2),
                          qb=_pad(q_ref[..., 1:h + 1, :], -2),
                          nu1=zeros, nu2=zeros.clone())


def shift_state(st: StructureState, q_ref, u_ref,
                horizon: int) -> StructureState:
    """Receding-horizon warm start: advance the previous solution one knot
    so it aligns with the rotated reference window, filling the newly
    entered tail stage from the reference (``q_ref``/``u_ref`` are the new
    window's references, 0-based)."""
    h = horizon
    lead = st.qa.shape[:-2]

    def tail(x):
        return x.expand(lead + x.shape[-2:])

    cat = lambda *xs: torch.cat(xs, dim=-2)
    return StructureState(
        u=cat(st.u[..., :1, :], st.u[..., 2:h, :], tail(u_ref[..., h - 2:h - 1, :])),
        qa=cat(st.qa[..., :1, :], st.qa[..., 2:h + 1, :],
               tail(q_ref[..., h - 1:h, :])),
        qb=cat(st.qb[..., :1, :], st.qb[..., 2:h + 1, :],
               tail(q_ref[..., h:h + 1, :])),
        nu1=cat(st.nu1[..., :1, :], st.nu1[..., 2:h, :], st.nu1[..., h - 1:, :]),
        nu2=cat(st.nu2[..., :1, :], st.nu2[..., 2:h, :], st.nu2[..., h - 1:, :]))


def _implicit_stages(dims: Dims, lin: LinearizedData, state: StructureState,
                     theta_template, alt, opts: IPOptions, horizon: int,
                     fixed_iters: int):
    """Per-stage linearized IP solves at (qa_t, qb_t, u_t), t = 1..H-1
    (methods.jl:683-704), for every batch entry of ``state``. ``lin``
    holds the H-1 window knots; ``theta_template`` (H-1, nθ) supplies the
    w/μ/h slots; ``alt`` is (..., nc).

    Returns (d, aa, ab, ba, converged) as 1-based padded stacks: ``d[t]``
    is the solved configuration z*_{q2} and aa/ab/ba are ∂z*q2/∂(q0, q1, u).
    ``fixed_iters > 0`` takes the fixed-iteration knot solve (the kernel on
    CUDA tensors), 0 the adaptive ``ip_solve``.
    """
    h = horizon
    nq = dims.nq
    lead = state.qa.shape[:-2]
    th = torch.cat([state.qa[..., 1:h, :], state.qb[..., 1:h, :],
                    state.u[..., 1:h, :],
                    theta_template[:, dims.iw1.start:].expand(
                        lead + (h - 1, dims.ntheta - dims.iw1.start))], dim=-1)
    alt_p = alt[..., None, :].expand(lead + (h - 1, dims.nc)).contiguous()
    q2_init = state.qb[..., 1:h, :].contiguous()
    if fixed_iters > 0:
        res = knot_ip(dims, lin.z0, lin.theta0, lin.r0, lin.rz0, lin.rtheta0,
                      alt_p, th, q2_init, opts, iters=fixed_iters)
        z, dz, converged = res.z, res.dz, res.converged
    else:
        z, dz, converged = adaptive_knot_solve(dims, lin, alt_p, th, q2_init,
                                               opts)
    d = _pad(z[..., :nq], -2)
    aa = _pad(dz[..., :nq, dims.iq0], -3)
    ab = _pad(dz[..., :nq, dims.iq1], -3)
    ba = _pad(dz[..., :nq, dims.iu1], -3)
    return d, aa, ab, ba, converged


def structure_residuals(dims: Dims, obj: StructureObjective,
                        state: StructureState, q_ref, u_ref, d, aa, ab, ba,
                        horizon: int):
    """dynamics_constraints! + lagrangian_gradient! (methods.jl:640-681).
    Returns 1-based padded residual stacks."""
    h = horizon
    u, qa, qb, nu1, nu2 = state

    rdyn1 = qa[..., 2:h + 1, :] - qb[..., 1:h, :]           # stages 1..H-1
    rdyn2 = qb[..., 2:h + 1, :] - d[..., 1:h, :]

    # objective terms (q_ref 0-based rows: stage t decision qa_{t+1} ~
    # q_ref[t], qb_{t+1} ~ q_ref[t+1])
    ru = mv(obj.ra[1:h], u[..., 1:h, :] - u_ref[..., :h - 1, :])
    dqa = qa[..., 2:h + 1, :] - q_ref[..., 1:h, :]
    dqb = qb[..., 2:h + 1, :] - q_ref[..., 2:h + 1, :]
    rqa = mv(obj.qa[2:h + 1], dqa)
    rqb = mv(obj.qb[2:h + 1], dqb)
    vel = qb[..., 2:h + 1, :] - qa[..., 2:h + 1, :]
    rqa = rqa - mv(obj.qv[2:h + 1], vel)
    rqb = rqb + mv(obj.qv[2:h + 1], vel)

    # configuration equality duals
    rqa = rqa + nu1[..., 1:h, :]
    rqb = rqb - _next(nu1[..., 1:h, :], -2)

    # dynamics duals
    ru = ru - _mtv(ba[..., 1:h, :, :], nu2[..., 1:h, :])
    rqb = rqb + nu2[..., 1:h, :]
    nu2_n = _next(nu2[..., 1:h, :], -2)
    rqa = rqa - _mtv(_next(aa[..., 1:h, :, :], -3), nu2_n)
    rqb = rqb - _mtv(_next(ab[..., 1:h, :, :], -3), nu2_n)
    return tuple(_pad(x, -2) for x in (ru, rqa, rqb, rdyn1, rdyn2))


def _residual_norm(parts):
    total = 0
    for p in parts:
        total = total + torch.sum(torch.abs(p), dim=(-2, -1))
    return total


class StructureNewtonResult(NamedTuple):
    state: StructureState
    r_norm: torch.Tensor      # (B,)
    iterations: torch.Tensor  # (B,) int32


def structure_newton_solve(dims: Dims, sobj: StructureObjective,
                           lin: LinearizedData, q_ref, u_ref,
                           theta_template, q0, q1, state: StructureState,
                           alt, ip_opts: IPOptions, opts: NewtonOptions,
                           horizon: int) -> StructureNewtonResult:
    """Damped Newton on the stage-structured horizon KKT
    (newton_solve!, methods.jl:798-882) for a batch of lanes: ``q0``,
    ``q1`` (B, nq), ``state`` leaves (B, ...), ``alt`` (B, nc). The
    7-point line search is one batch of (B, 7) trial states.

    The reference's adaptive loop becomes ``max_iter`` masked trips: a
    lane whose loop condition is false passes through unchanged and
    counts no iteration, as under a vmapped ``while_loop``; with
    ``opts.fixed_newton_iters > 0`` it is that many masked trips, a lane
    passing through once it has converged. Nothing is read back to the
    host either way, so that with fixed knot solves
    (``opts.fixed_ip_iters > 0``) the whole solve is one CUDA graph on the
    card (``control/graphs.py``).
    """
    h = horizon
    dtype = q_ref.dtype
    beta = opts.beta_init
    batch = q0.shape[0]

    # sanitize the warm start: any non-finite leaf falls back to the
    # reference value; then pin the measured configurations
    ref_st = state_from_reference(q_ref, u_ref, dims, h)
    state = _map(lambda w, r: torch.where(torch.isfinite(w), w, r),
                 state, ref_st)
    state = state._replace(
        qa=torch.cat([state.qa[:, :1], q0[:, None], state.qa[:, 2:]], dim=1),
        qb=torch.cat([state.qb[:, :1], q1[:, None], state.qb[:, 2:]], dim=1))

    # line-search trials may run a reduced knot-solve budget: the trial
    # residual only steers the accept decision, and the chosen candidate
    # is solved again at the full budget before it becomes the iterate
    cheap_trials = 0 < opts.trial_ip_iters < opts.fixed_ip_iters
    # the KKT solve: CPU tensors take the plain version, CUDA tensors the
    # kernel (or raise)
    kkt_solve = (structure_kkt_solve if kkt_route(
        q0.device, dtype, dims.nq, dims.nu, h) == "plain" else structure_kkt)

    def residual_of(st, alt_, fixed_iters=opts.fixed_ip_iters):
        d, aa, ab, ba, _ = _implicit_stages(
            dims, lin, st, theta_template, alt_, ip_opts, h, fixed_iters)
        parts = structure_residuals(dims, sobj, st, q_ref, u_ref,
                                    d, aa, ab, ba, h)
        return parts, (aa, ab, ba)

    parts, jacs = residual_of(state, alt)
    r_norm = _residual_norm(parts)
    n_total = (h - 1) * (dims.nu + 4 * dims.nq)

    n_ls = opts.max_ls + 1
    alphas = 0.5 ** torch.arange(n_ls, dtype=dtype, device=q0.device)
    a_col = alphas[:, None, None]
    alt_t = alt[:, None, :].expand(batch, n_ls, dims.nc)
    lane = torch.arange(batch, device=q0.device)

    def apply_step(st, step):
        """Trial states (B, n_ls, ...) for every α; ``step`` holds the
        padded (du, dqa, dqb, dnu1, dnu2); the pinned leading stages stay."""
        def one(x, dx, keep):
            moved = x[:, None, keep:] - a_col * dx[:, None, 1:]
            head = x[:, None, :keep].expand(-1, n_ls, -1, -1)
            return torch.cat([head, moved], dim=2)
        return StructureState(*(one(x, dx, keep) for x, dx, keep in
                                zip(st, step, (1, 2, 2, 1, 1))))

    def select(mask, new, old):
        return tuple(torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o)
                     for n, o in zip(new, old))

    def within(rn, r_norm_c):
        """Reject non-finite steps always, and residual growth beyond
        ls_growth_allow when that bound is finite (stale values + retry
        next control period, implicit_dynamics.jl:169-177)."""
        ok = torch.isfinite(rn)
        if np.isfinite(opts.ls_growth_allow):
            ok = ok & (rn <= opts.ls_growth_allow * r_norm_c)
        return ok

    it = torch.zeros((batch,), dtype=torch.int32, device=q0.device)
    fixed = opts.fixed_newton_iters > 0
    for _ in range(opts.fixed_newton_iters if fixed else opts.max_iter):
        if fixed:
            live = ~(r_norm / n_total < opts.r_tol)
        else:
            live = (it < opts.max_iter) & (r_norm / n_total >= opts.r_tol)
        step = kkt_solve(dims, sobj, *jacs, *parts, beta, h)
        sts = apply_step(state, step)
        ps, js = residual_of(sts, alt_t, opts.trial_ip_iters if cheap_trials
                             else opts.fixed_ip_iters)
        rns = _residual_norm(ps)                                 # (B, n_ls)
        accept = rns ** 2 < (1.0 - 1.0e-3 * alphas) * r_norm[:, None] ** 2
        # no-accept fallback: the reference's smallest-α forced step when
        # the growth bound is off; the least-bad FINITE trial when it is on
        if np.isfinite(opts.ls_growth_allow):
            fallback = torch.where(torch.isfinite(rns), rns,
                                   torch.inf).argmin(dim=1)
        else:
            fallback = torch.full_like(lane, n_ls - 1)
        pick = torch.where(accept.any(dim=1),
                           accept.to(torch.int8).argmax(dim=1), fallback)
        take = lambda x: x[lane, pick]
        rn_pick = take(rns)
        ok = within(rn_pick, r_norm)
        st_pick = StructureState(*(take(x) for x in sts))
        if cheap_trials:
            ps_pick, js_pick = residual_of(st_pick, alt)
            rn_pick = _residual_norm(ps_pick)
            ok = ok & within(rn_pick, r_norm)
        else:
            ps_pick, js_pick = [take(x) for x in ps], [take(x) for x in js]
        upd = ok & live
        state = StructureState(*select(upd, st_pick, state))
        parts = select(upd, ps_pick, parts)
        jacs = select(upd, js_pick, jacs)
        r_norm = torch.where(upd, rn_pick, r_norm)
        it = torch.where(live, it + 1, it)
    return StructureNewtonResult(state=state, r_norm=r_norm, iterations=it)
