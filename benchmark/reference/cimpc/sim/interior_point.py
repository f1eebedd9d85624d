"""Mehrotra-style predictor–corrector interior-point solver for the
contact NCP, batched over a leading axis of problems.

PyTorch counterpart of ``contactimplicitmpc_tpu/sim/interior_point.py``.
Scheme per iteration (relaxed central path over
``y1 = [γ1; b1; ψ1] ⟂ y2 = [s1; η1; s2]``; for the nonlinear cone γ1 ⟂ s1
over the orthant and, per contact, [ψᵢ; ηᵢ] ⟂ [s2ᵢ; bᵢ] over the
second-order cone, with the exact Jacobian and a dense LU):

1. affine (predictor) step: solve ``rz Δaff = r(z, θ, 0)``
2. centering: ``σ = clamp(μaff/μ, 0, 1)³`` with ``μ = y1ᵀy2/ny``
3. corrector: solve ``rz Δ = r(z, θ, κ_t) + [0; 0; Δaff₁ ∘ Δaff₂]`` with
   ``κ_t = max(σ μ, κ_tol / undercut)``
4. fraction-to-boundary step ``z ← z − α Δ`` chosen by a merit line search
   over the corrected and the pure centering direction.

Convergence: ``rvio ≤ r_tol ∧ κvio ≤ κ_tol`` measured on ``r(z, θ, 0)``.

Two loops. ``fixed_iters > 0``: every problem runs that many masked
iterations (a problem that has converged, or whose trial iterate is not
finite, keeps its state), and no value is read back to the host. Otherwise
the adaptive loop: each problem iterates until it has converged or reached
``max_iter``, as under a vmapped ``while_loop``; the loop runs while any
problem is live and reads that one flag from the device each trip.
``ip_program`` cuts the solve at its loop into functions of tensors only
(``IPProgram``); ``run_program`` drives them eagerly, and a sim step on the
card replays them as CUDA graphs (``sim/graphs.py``).

Solution sensitivities (``diff_sol``): ``dz = −rz⁻¹ rθ = ∂z*/∂θ`` by one
more solve with ``nθ`` right-hand sides.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, jvp, vmap

from ..dims import Dims
from ..env import LINEARIZED_CONE
from ..ops.linsolve import gj_inverse
from ..ops.soc import NCConeLayout, soc_product, soc_step_length
from ..utils.cuda_graphs import capturable_linalg


@dataclasses.dataclass(frozen=True)
class IPOptions:
    """InteriorPointOptions equivalent (simulator.jl:24-32,
    implicit_dynamics.jl:25-32); field names match the JAX package's."""

    r_tol: float = 1.0e-8
    kappa_tol: float = 1.0e-8
    max_iter: int = 100
    undercut: float = float("inf")
    gamma_reg: float = 0.0      # cone regularization: y_reg = max(y, γ_reg κvio)
    tau_min: float = 0.9        # fraction-to-boundary floor
    tau_max: float = 0.99       # fraction-to-boundary cap
    max_ls: int = 3             # residual-merit backtracking halvings
    eps_min: float = 0.0        # line-search floor (× the cone step)
    diff_sol: bool = False
    retries: int = 0            # cold restarts after a failed solve
    refine: int = 0             # refinement passes per linear solve
    fixed_iters: int = 0        # >0: masked fixed-iteration loop


class IPResult(NamedTuple):
    z: torch.Tensor           # (B, nz) solution
    converged: torch.Tensor   # (B,) bool
    iterations: torch.Tensor  # (B,) int32
    rvio: torch.Tensor        # (B,) residual violation at κ = 0
    kvio: torch.Tensor        # (B,) bilinear violation at κ = 0
    dz: Optional[torch.Tensor]  # (B, nz, nθ) sensitivity ∂z*/∂θ or None


def _violations(dims: Dims, r):
    """residual_violation / bilinear_violation (linearized_solver.jl:401-409)."""
    ne = dims.nx + dims.ny
    return (torch.amax(torch.abs(r[..., :ne]), dim=-1),
            torch.amax(torch.abs(r[..., ne:]), dim=-1))


def _step_length(y, dy, tau):
    """Largest α ∈ (0, 1] with y − α·dy ≥ (1 − τ)·y over the last axis;
    ``tau`` has the leading shape. Only positive Δ components limit."""
    big = torch.finfo(y.dtype).max
    pos = dy > 0
    ratio = torch.where(pos, tau[..., None] * y / torch.where(pos, dy, 1.0),
                        big)
    return torch.clamp(torch.amin(ratio, dim=-1), max=1.0)


def z_initialize(dims: Dims, q, dtype=None, cone: str = LINEARIZED_CONE):
    """z_initialize! (simulation.jl:53-81). ``q`` is (..., nq).

    Linearized cone: ones with the q2 slot set. Nonlinear cone: 0.1 with
    unit scalar parts (ψ1, s2) so each SOC starts in the cone interior."""
    dtype = dtype or q.dtype
    shape = q.shape[:-1] + (dims.nz - dims.nq,)
    if cone == LINEARIZED_CONE:
        rest = torch.ones(shape, dtype=dtype, device=q.device)
    else:
        rest = torch.full(shape, 0.1, dtype=dtype, device=q.device)
        for sl in (dims.ipsi1, dims.is2):
            rest[..., sl.start - dims.nq:sl.stop - dims.nq].fill_(1.0)
    return torch.cat([q.to(dtype), rest], dim=-1)


def z_warmstart(dims: Dims, q, z_prev, generator=None, amplitude=1.0e-3,
                cone: str = LINEARIZED_CONE, draw=None):
    """z_warmstart! (simulation.jl:87-107): the previous solution's cone
    variables, nudged into the interior by a positive uniform perturbation
    of the given amplitude, with the q2 slot pinned again. ``q`` is
    (..., nq) and ``z_prev`` (..., nz). The perturbation is ``amplitude``
    times ``draw`` (..., nz − nq) where given, else times a uniform [0, 1)
    draw from ``generator`` (the default generator when None).

    The nonlinear cone falls back to ``z_initialize`` (the reference's
    behavior) and draws nothing."""
    if cone != LINEARIZED_CONE:
        return z_initialize(dims, q, z_prev.dtype, cone=cone)
    cone_prev = z_prev[..., dims.nq:]
    if draw is None:
        draw = torch.rand(cone_prev.shape, generator=generator,
                          dtype=z_prev.dtype, device=z_prev.device)
    return torch.cat([q.to(z_prev.dtype), cone_prev + amplitude * draw],
                     dim=-1)


def make_dense_solver(dims: Dims, jacobian_fn, opts: IPOptions,
                      clamp_bilinear: bool = True):
    """Regularized dense LU backend. ``jacobian_fn(z, θ)`` gives the batch
    of Jacobians (B, nz, nz). The bilinear diagonal blocks are clamped
    from below by ``γ_reg κvio`` (y1_reg/y2_reg in rzlin!,
    linearized_solver.jl:390-394); ``clamp_bilinear=False`` keeps the
    Jacobian as it is."""
    nx, ny = dims.nx, dims.ny
    ne = nx + ny

    def factor(z, theta, kvio):
        rz = jacobian_fn(z, theta)
        if clamp_bilinear:
            reg = opts.gamma_reg * kvio[:, None]
            y1 = torch.maximum(z[:, nx:ne], reg)
            y2 = torch.maximum(z[:, ne:], reg)
            rz = torch.cat([rz[:, :ne], torch.cat([
                rz[:, ne:, :nx], torch.diag_embed(y2), torch.diag_embed(y1)],
                dim=-1)], dim=-2)
        with capturable_linalg(rz):
            return torch.linalg.lu_factor_ex(rz)[:2]

    def solve(factors, rhs):
        vec = rhs.dim() == 2
        with capturable_linalg(rhs):
            out = torch.linalg.lu_solve(*factors,
                                        rhs[..., None] if vec else rhs)
        return out[..., 0] if vec else out

    return factor, solve


def make_ncp_schur_solver(dims: Dims, residual_fn, opts: IPOptions):
    """Structure-exploiting backend for the full linearized-cone NCP::

        rz = [[Dx  Dy1  0      ]     x  = q2,  y1 = (γ1, b1, ψ1)
              [Rx  Ry1  I      ]     y2 = (s1, η1, s2)
              [0   D(y2) D(y1) ]]

    Eliminate y2 diagonally, then x through Dx, leaving one ny×ny Schur
    factorization per IP iteration. The Dx/Rx/Dy1/Ry1 blocks are the
    forward-mode Jacobian of the equality rows in the (x, y1) directions
    only. ``residual_fn`` acts on one sample; the batch is a ``vmap``.
    ``solve`` takes one right-hand side a problem (B, nz) or a matrix of
    them (B, nz, R).
    """
    nx, ny = dims.nx, dims.ny
    ne = nx + ny

    def equality_rows(xy1, y2, theta):
        z = torch.cat([xy1, y2])
        return residual_fn(z, theta, 0.0)[:ne]

    jac_fn = vmap(jacfwd(equality_rows))

    def factor(z, theta, kvio):
        jac = jac_fn(z[:, :ne], z[:, ne:], theta)     # (B, ne, ne)
        dx, dy1 = jac[:, :nx, :nx], jac[:, :nx, nx:]
        rx, ry1 = jac[:, nx:, :nx], jac[:, nx:, nx:]

        reg = opts.gamma_reg * kvio[:, None]
        y1r = torch.maximum(z[:, nx:ne], reg)
        y2r = torch.maximum(z[:, ne:], reg)

        dxi = gj_inverse(dx)
        cai = rx @ dxi
        caib = cai @ dy1
        s = ry1 - torch.diag_embed(y2r / y1r) - caib
        return (dxi, dy1, cai, gj_inverse(s), y1r, y2r)

    def solve(factors, rhs):
        dxi, dy1, cai, si, y1r, y2r = factors
        vec = rhs.dim() == 2
        r = rhs[..., None] if vec else rhs
        r1, r2, r3 = r[:, :nx], r[:, nx:ne], r[:, ne:]
        r2p = r2 - r3 / y1r[..., None]
        dy1_sol = si @ (r2p - cai @ r1)
        dx_sol = dxi @ (r1 - dy1 @ dy1_sol)
        dy2_sol = (r3 - y2r[..., None] * dy1_sol) / y1r[..., None]
        out = torch.cat([dx_sol, dy1_sol, dy2_sol], dim=1)
        return out[..., 0] if vec else out

    return factor, solve


_NC_INDEX = {}   # (dims, device): the nonlinear cone's index tensors


def _nc_index(dims: Dims, device):
    """The nonlinear cone's index sets (``NCConeLayout``) as tensors on
    ``device``, made once per (dims, device) so that a solve copies nothing
    from the host."""
    key = (dims, torch.device(device))
    out = _NC_INDEX.get(key)
    if out is None:
        lay = NCConeLayout(dims)
        out = _NC_INDEX[key] = tuple(
            torch.as_tensor(a, device=device)
            for a in (lay.ort_a, lay.ort_b, lay.soc_u, lay.soc_v))
    return out


def _nc_tools(dims: Dims, like):
    """The nonlinear cone's step length, μ, Mehrotra correction and κ on the
    bilinear rows (it enters the orthant rows and each SOC block's first
    row) over its layout (orthant γ1 ⟂ s1, then one SOC pair a contact), on
    a batch (B, nz) of ``like``'s dtype and device."""
    ort_a, ort_b, soc_u, soc_v = _nc_index(dims, like.device)  # (nc, nf + 1)

    def step_length(z, d, tau):
        alpha = torch.minimum(_step_length(z[:, ort_a], d[:, ort_a], tau),
                              _step_length(z[:, ort_b], d[:, ort_b], tau))
        t = tau[:, None]
        return torch.minimum(alpha, torch.minimum(
            soc_step_length(z[:, soc_u], d[:, soc_u], t),
            soc_step_length(z[:, soc_v], d[:, soc_v], t)).amin(dim=-1))

    def mu_of(z):
        total = torch.sum(z[:, ort_a] * z[:, ort_b], dim=-1)
        pair = torch.sum(z[:, soc_u] * z[:, soc_v], dim=-1)   # (B, nc)
        for i in range(dims.nc):           # the JAX package's order
            total = total + pair[:, i]
        return total / (2 * dims.nc)

    def correction(d):
        return torch.cat([d[:, ort_a] * d[:, ort_b], soc_product(
            d[:, soc_u], d[:, soc_v]).flatten(1)], dim=-1)

    kmask = like.new_zeros((dims.ny,))
    kmask[:dims.nc].fill_(1.0)
    kmask[dims.nc::dims.nf + 1].fill_(1.0)

    def kappa_rows(kappa):
        return kappa[:, None] * kmask

    return step_length, mu_of, correction, kappa_rows


class IPState(NamedTuple):
    """The solve loop's carry, one entry a problem."""

    z: torch.Tensor       # (B, nz) iterate
    r: torch.Tensor       # (B, nz) r(z, θ, 0)
    rvio: torch.Tensor    # (B,) its violations
    kvio: torch.Tensor
    it: torch.Tensor      # (B,) int32 iterations taken
    done: torch.Tensor    # (B,) bool converged


class IPProgram(NamedTuple):
    """``ip_solve`` cut at its loop into functions of tensors only, none of
    which reads a value back to the host: ``start(z)`` is the carry at the
    iterate ``z``; ``live(s)`` the problems the next trip advances;
    ``trip(s)`` one masked loop trip; ``restart(s)`` a cold restart of the
    problems that failed (``opts.retries``); ``finish(s)`` the divergence
    guard and the sensitivities, the ``IPResult``. ``run_program`` drives
    them eagerly; ``sim/graphs.py`` captures them as CUDA graphs."""

    start: Callable
    live: Callable
    trip: Callable
    restart: Callable
    finish: Callable


def ip_solve(dims: Dims, residual_fn: Callable, z0, theta, opts: IPOptions,
             jacobian_fn: Optional[Callable] = None,
             rtheta_fn: Optional[Callable] = None, linear_solver=None,
             cone: str = LINEARIZED_CONE, batched: bool = False) -> IPResult:
    """Solve ``r(z, θ, κ→κ_tol) = 0`` for a batch: ``z0`` (B, nz) and
    ``theta`` (B, nθ).

    ``residual_fn(z, θ, κ)``, ``jacobian_fn(z, θ)`` and ``rtheta_fn(z, θ)``
    act on one sample and are batched here with ``vmap``; ``rtheta_fn``
    defaults to the forward-mode derivative of ``residual_fn``.
    ``jacobian_fn`` (one sample; by default the forward-mode derivative of
    ``residual_fn``) feeds the dense LU that the nonlinear cone selects. With
    ``batched=True`` the three take the whole batch instead (problems
    whose data differs from one to the next, as the MPC's pre-linearized
    knots): ``residual_fn`` then gets ``z`` as (B, nz) with ``κ`` (B,), or
    as (B, C, nz) with ``κ`` (B, C) for the C line-search candidates of a
    problem, and ``rtheta_fn`` must be given where ``diff_sol`` is set.

    ``linear_solver`` is a ``(factor, solve)`` pair on the batch:
    ``factor(z, θ, κvio)`` and ``solve(factors, rhs)`` with ``rhs`` (B, nz)
    or (B, nz, R). It defaults to the structured Schur elimination of
    ``make_ncp_schur_solver`` for the linearized cone, and to the exact
    Jacobian's dense LU (``make_dense_solver``, no γ_reg clamp) for the
    nonlinear cone, whose SOC rows have arrow-matrix Jacobians.

    The loop runs eagerly (``run_program``); a sim step on the card runs
    the same program as CUDA graphs (``sim/graphs.py``).
    """
    return run_program(ip_program(
        dims, residual_fn, z0, theta, opts, jacobian_fn=jacobian_fn,
        rtheta_fn=rtheta_fn, linear_solver=linear_solver, cone=cone,
        batched=batched), z0, opts)


def run_program(prog: IPProgram, z0, opts: IPOptions) -> IPResult:
    """Drive ``prog`` from ``z0``: ``opts.fixed_iters`` trips with no read
    from the device (the ``fori_loop``), or trips while a problem is live
    with one read of that flag a trip (the ``while_loop``); then each cold
    restart with its own loop, then ``finish``."""
    s = prog.start(z0)
    for attempt in range(opts.retries + 1):
        if attempt:
            s = prog.restart(s)
        if opts.fixed_iters > 0:
            for _ in range(opts.fixed_iters):
                s = prog.trip(s)
        else:
            while bool(prog.live(s).any()):   # one read a trip
                s = prog.trip(s)
    return prog.finish(s)


def ip_program(dims: Dims, residual_fn: Callable, z0, theta,
               opts: IPOptions, jacobian_fn: Optional[Callable] = None,
               rtheta_fn: Optional[Callable] = None, linear_solver=None,
               cone: str = LINEARIZED_CONE,
               batched: bool = False) -> IPProgram:
    """``ip_solve``'s program (``IPProgram``) over the tensors ``z0`` (the
    cold restarts' configurations and the divergence guard's fallback) and
    ``theta``, which its functions read when they are called; the
    arguments are ``ip_solve``'s."""
    linearized = cone == LINEARIZED_CONE
    dtype = z0.dtype
    nx, ny = dims.nx, dims.ny
    ne = nx + ny
    n_cand = opts.max_ls + 1
    batch = z0.shape[0]

    if batched:
        residual = residual_fn
    else:
        res_one = vmap(residual_fn)
        res_cand = vmap(vmap(residual_fn, in_dims=(0, None, 0)))

        def residual(z, th, kappa):
            return (res_one if z.dim() == 2 else res_cand)(z, th, kappa)

    if linear_solver is None:
        if batched:
            raise ValueError("ip_solve: batched callables need a "
                             "linear_solver")
        if linearized:
            linear_solver = make_ncp_schur_solver(dims, residual_fn, opts)
        else:
            jac_one = jacobian_fn or jacfwd(
                lambda zz, th: residual_fn(zz, th, 0.0))
            linear_solver = make_dense_solver(
                dims, vmap(jac_one), dataclasses.replace(opts, gamma_reg=0.0),
                clamp_bilinear=False)
    factor_fn, solve_fn = linear_solver

    halvings = torch.clamp(
        0.5 ** torch.arange(n_cand, dtype=dtype, device=z0.device),
        min=opts.eps_min)
    kappa_floor = opts.kappa_tol / opts.undercut
    one = torch.ones((batch,), dtype=dtype, device=z0.device)
    zero = torch.zeros_like(one)

    if linearized:
        def cone_step_length(z, d, tau):
            return torch.minimum(_step_length(z[:, nx:ne], d[:, nx:ne], tau),
                                 _step_length(z[:, ne:], d[:, ne:], tau))

        def cone_mu(z):
            return torch.sum(z[:, nx:ne] * z[:, ne:], dim=-1) / ny

        def cone_correction(d):
            return d[:, nx:ne] * d[:, ne:]

        def cone_kappa(kappa):
            return kappa[:, None]
    else:
        cone_step_length, cone_mu, cone_correction, cone_kappa = _nc_tools(
            dims, z0)

    def apply_reg_jacobian(z, kvio, d):
        """The regularized Jacobian, the operator the factorization
        represents, on one step a problem (B, nz): equality rows by a JVP
        of the residual, bilinear rows with the γ_reg-clamped diagonals.
        Refining against it corrects only the rounding of the structured
        solve, so the correction contracts; against the unclamped Jacobian
        it diverges wherever the clamp is active. The nonlinear cone's dense
        backend factors the exact Jacobian: no clamp to match there."""
        if batched:
            jd = jvp(lambda zz: residual_fn(zz, theta, zero), (z,), (d,))[1]
        else:
            jd = vmap(lambda zz, th, dd: jvp(
                lambda x: residual_fn(x, th, 0.0), (zz,), (dd,))[1])(
                    z, theta, d)
        if not linearized:
            return jd
        reg = opts.gamma_reg * kvio[:, None]
        y1r = torch.maximum(z[:, nx:ne], reg)
        y2r = torch.maximum(z[:, ne:], reg)
        bil = y2r * d[:, nx:ne] + y1r * d[:, ne:]
        return torch.cat([jd[:, :ne], bil], dim=-1)

    def refined(z, kvio, factors, rhs):
        """One structured solve and ``opts.refine`` passes of iterative
        refinement against the factorization's own operator; ``rhs`` is
        (B, nz) or (B, nz, R)."""
        d = solve_fn(factors, rhs)
        for _ in range(opts.refine):
            if rhs.dim() == 2:
                kd = apply_reg_jacobian(z, kvio, d)
            else:
                kd = torch.stack([apply_reg_jacobian(z, kvio, d[..., c])
                                  for c in range(d.shape[-1])], dim=-1)
            d = d + solve_fn(factors, rhs - kd)
        return d

    def body(z, r0, rvio, kvio):
        # r0 is r(z, θ, 0), carried from the previous trip; r(z, θ, κ)
        # differs from it by −κ on the bilinear rows only (for the
        # nonlinear cone on the orthant rows and each SOC block's first)
        factors = factor_fn(z, theta, kvio)
        d_aff = refined(z, kvio, factors, r0)
        alpha_aff = cone_step_length(z, d_aff, one)
        mu = cone_mu(z)
        mu_aff = cone_mu(z - alpha_aff[:, None] * d_aff)
        sigma = torch.clamp(mu_aff / torch.clamp(
            mu, min=torch.finfo(dtype).tiny), 0.0, 1.0) ** 3
        kappa_t = torch.clamp(sigma * mu, min=kappa_floor)

        r_center = torch.cat([r0[:, :ne], r0[:, ne:] - cone_kappa(kappa_t)],
                             -1)
        r_cor = torch.cat([r_center[:, :ne], r_center[:, ne:]
                           + cone_correction(d_aff)], -1)
        d_cor = refined(z, kvio, factors, r_cor)
        d_cen = refined(z, kvio, factors, r_center)

        tau = torch.clamp(1.0 - torch.maximum(rvio, kvio) ** 2,
                          opts.tau_min, opts.tau_max)
        merit0 = torch.sum(r_center ** 2, dim=-1)
        a0_cor = cone_step_length(z, d_cor, tau)
        a0_cen = cone_step_length(z, d_cen, tau)
        alphas = torch.cat([a0_cor[:, None] * halvings,
                            a0_cen[:, None] * halvings], dim=1)  # (B, C)
        dirs = torch.stack([d_cor, d_cen], dim=1).repeat_interleave(
            n_cand, dim=1)                                       # (B, C, nz)
        z_c = z[:, None, :] - alphas[..., None] * dirs
        rr = residual(z_c, theta, kappa_t[:, None].expand(-1, 2 * n_cand))
        merits = torch.sum(rr ** 2, dim=-1)
        ok = merits < (1.0 - 1.0e-3 * alphas) * merit0[:, None]
        pick = torch.where(ok.any(dim=1), ok.to(torch.int8).argmax(dim=1),
                           merits.argmin(dim=1))
        alpha = alphas.gather(1, pick[:, None])
        d = dirs.gather(1, pick[:, None, None].expand(-1, 1, dims.nz))[:, 0]
        z_new = z - alpha * d
        r_new = residual(z_new, theta, zero)
        rvio_n, kvio_n = _violations(dims, r_new)
        return z_new, r_new, rvio_n, kvio_n

    def start(z):
        r = residual(z, theta, zero)
        rvio, kvio = _violations(dims, r)
        done = (rvio <= opts.r_tol) & (kvio <= opts.kappa_tol)
        it = torch.zeros((batch,), dtype=torch.int32, device=z0.device)
        return IPState(z, r, rvio, kvio, it, done)

    def live(s):
        if opts.fixed_iters > 0:
            return ~s.done
        return ~s.done & (s.it < opts.max_iter)

    def trip(s):
        lv = live(s)
        z_n, r_n, rvio_n, kvio_n = body(s.z, s.r, s.rvio, s.kvio)
        if opts.fixed_iters > 0:
            # a non-finite trial iterate keeps the last finite one; the
            # adaptive loop has no such guard and a problem gone NaN
            # iterates on to max_iter (reset by ``finish``)
            lv = lv & torch.isfinite(z_n).all(dim=-1)
        return IPState(
            torch.where(lv[:, None], z_n, s.z),
            torch.where(lv[:, None], r_n, s.r),
            torch.where(lv, rvio_n, s.rvio),
            torch.where(lv, kvio_n, s.kvio),
            s.it + lv.to(torch.int32),
            torch.where(lv, (rvio_n <= opts.r_tol)
                        & (kvio_n <= opts.kappa_tol), s.done))

    def restart(s):
        # cold-restart retries: a failed solve starts again from the cold
        # initializer; converged problems enter with done set and iterate
        # no further (their iteration count restarts at 0, as the
        # reference's does)
        z_cold = z_initialize(dims, z0[:, dims.iq2], dtype, cone=cone)
        return start(torch.where(s.done[:, None], s.z, z_cold))

    def finish(s):
        # divergence guard: a non-finite solve returns the (finite) initial
        # iterate marked non-converged (rvio/kvio keep the diverged values)
        bad = ~torch.isfinite(s.z).all(dim=-1)
        z = torch.where(bad[:, None], z0, s.z)
        done = s.done & ~bad

        dz = None
        if opts.diff_sol:
            if rtheta_fn is not None:
                rtheta = (rtheta_fn if batched else vmap(rtheta_fn))(z, theta)
            elif batched:
                raise ValueError("ip_solve: diff_sol with batched callables "
                                 "needs rtheta_fn")
            else:
                rtheta = vmap(lambda zz, th: jacfwd(
                    lambda t: residual_fn(zz, t, 0.0))(th))(z, theta)
            dz = refined(z, s.kvio, factor_fn(z, theta, s.kvio), -rtheta)
            # a singular factorization can give non-finite sensitivities at
            # a finite z: zero them and flag the problem
            dz_bad = ~torch.isfinite(dz).all(dim=-1).all(dim=-1)
            dz = torch.where(dz_bad[:, None, None], torch.zeros_like(dz), dz)
            done = done & ~dz_bad

        return IPResult(z=z, converged=done, iterations=s.it, rvio=s.rvio,
                        kvio=s.kvio, dz=dz)

    return IPProgram(start, live, trip, restart, finish)
