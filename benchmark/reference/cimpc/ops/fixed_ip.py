"""Fixed-iteration linearized interior-point solve of pre-linearized knot
subproblems — the plain PyTorch version of the knot kernel
(``ops/knot_ip.py``, ``csrc/knot_ip.cu``).

PyTorch counterpart of ``contactimplicitmpc_tpu/ops/fixed_ip.py`` with its
whole contract: ``iters`` masked Mehrotra predictor–corrector iterations
on the structured Schur path, the last-finite-iterate guard, the final
residual, and the sensitivity solve ``dz = −K_reg⁻¹ rθ0`` with refinement
and zeroing of non-finite results.

Batching: the per-problem tensors (``alt``, ``theta``, ``q2_init``) carry
a leading shape ``P``; the linearization tensors (``z0_lin`` … ``rtheta0``)
carry a leading shape that broadcasts against ``P`` (one knot shared by
many problems costs no copy).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..dims import Dims
from ..sim.interior_point import IPOptions, _step_length
from .linsolve import gj_inverse, mv


class FixedIPResult(NamedTuple):
    z: torch.Tensor          # (..., nz)
    converged: torch.Tensor  # (...,) bool
    rvio: torch.Tensor       # (...,)
    kvio: torch.Tensor       # (...,)
    dz: torch.Tensor         # (..., nz, nθ) sensitivities


class KnotBlocks(NamedTuple):
    """The constant blocks of a knot's regularized Schur solve (RZLin,
    linearized_solver.jl:224-304); they depend on ``rz0`` alone."""
    dxi: torch.Tensor   # (..., nx, nx)  Dx⁻¹
    dy1: torch.Tensor   # (..., nx, ny)
    cai: torch.Tensor   # (..., ny, nx)  Rx Dx⁻¹
    caib: torch.Tensor  # (..., ny, ny)  Rx Dx⁻¹ Dy1
    ry1: torch.Tensor   # (..., ny, ny)
    ry2: torch.Tensor   # (..., ny)      diagonal of the y2 block


def knot_blocks(dims: Dims, rz0) -> KnotBlocks:
    nx, ne = dims.nx, dims.nx + dims.ny
    dy1 = rz0[..., :nx, nx:ne]
    dxi = gj_inverse(rz0[..., :nx, :nx])
    cai = rz0[..., nx:ne, :nx] @ dxi
    return KnotBlocks(
        dxi=dxi, dy1=dy1, cai=cai, caib=cai @ dy1, ry1=rz0[..., nx:ne, nx:ne],
        ry2=torch.diagonal(rz0[..., nx:ne, ne:], dim1=-2, dim2=-1))


def linearized_ip_fixed(dims: Dims, z0_lin, theta0, r0, rz0, rtheta0,
                        alt, theta, q2_init, opts: IPOptions,
                        iters: int = 10,
                        affine_merit: bool = False) -> FixedIPResult:
    """Solve pre-linearized knots with ``iters`` masked IP iterations.

    ``affine_merit`` takes the line search's equality rows at a candidate
    as r − α (Rza d), the CUDA kernel's form, in place of the residual
    evaluated at the candidate (JAX's form): the same function in exact
    arithmetic; in float32, where the residual sits at its floor, the two
    forms pick other candidates (tools/knot_ip_spread.py measures how far
    that parts two solves)."""
    dtype = theta.dtype
    nx, ny, nq, nz = dims.nx, dims.ny, dims.nq, dims.nz
    ne = nx + ny
    tiny = torch.finfo(dtype).tiny

    dxi, dy1, cai, caib, ry1, ry2 = knot_blocks(dims, rz0)

    # affine residual pieces: r_affine(z) = base + rz0_affrows (z − z0)
    lead = theta.shape[:-1]
    alt_full = torch.cat([
        torch.zeros(lead + (nq,), dtype=dtype, device=theta.device), alt,
        torch.zeros(lead + (nz - nq - dims.nc,), dtype=dtype,
                    device=theta.device)], dim=-1)
    r_base = (r0 + mv(rtheta0, theta - theta0) + alt_full)[..., :ne]
    rz_aff = rz0[..., :ne, :]

    def residual(z, kappa):
        """(..., [C,] nz) at per-problem κ (..., [C])."""
        extra = z.dim() - len(lead) - 1   # 1 for a candidate axis
        rza = rz_aff[..., None, :, :] if extra else rz_aff
        rb = r_base[..., None, :] if extra else r_base
        z0 = z0_lin[..., None, :] if extra else z0_lin
        affine = rb + mv(rza, z - z0)
        bil = z[..., nx:ne] * z[..., ne:] - kappa[..., None]
        return torch.cat([affine, bil], dim=-1)

    def schur_factor(z, kvio):
        reg = opts.gamma_reg * kvio[..., None]
        y1r = torch.maximum(z[..., nx:ne], reg)
        y2r = torch.maximum(z[..., ne:], reg)
        s = ry1 - torch.diag_embed(ry2 * y2r / y1r) - caib
        return gj_inverse(s), y1r, y2r

    def schur_solve(factors, r):
        """Right-hand sides as columns: r (..., nz, R)."""
        si, y1r, y2r = factors
        rdyn, rrst, rbil = r[..., :nx, :], r[..., nx:ne, :], r[..., ne:, :]
        v = rrst - (ry2 / y1r)[..., None] * rbil
        temp = si @ (cai @ rdyn - v)
        x = dxi @ (rdyn + dy1 @ temp)
        dy2 = (rbil + y2r[..., None] * temp) / y1r[..., None]
        return torch.cat([x, -temp, dy2], dim=-2)

    def apply_jac(factors, d):
        """The factorization's own (γ_reg-regularized) operator on step
        columns d (..., nz, R) — refinement against it contracts."""
        _, y1r, y2r = factors
        eq = rz_aff @ d
        bil = y1r[..., None] * d[..., ne:, :] + y2r[..., None] * d[..., nx:ne, :]
        return torch.cat([eq, bil], dim=-2)

    def solve_refined(factors, rhs):
        d = schur_solve(factors, rhs)
        for _ in range(opts.refine):
            d = d + schur_solve(factors, rhs - apply_jac(factors, d))
        return d

    z_init = torch.cat([
        q2_init, torch.ones(lead + (nz - nq,), dtype=dtype,
                            device=theta.device)], dim=-1)
    n_ls = opts.max_ls + 1
    halvings = 0.5 ** torch.arange(n_ls, dtype=dtype, device=theta.device)
    one = torch.ones(lead, dtype=dtype, device=theta.device)
    zero = torch.zeros_like(one)
    kappa_floor = opts.kappa_tol / opts.undercut

    def violations(r):
        return (torch.amax(torch.abs(r[..., :ne]), dim=-1),
                torch.amax(torch.abs(r[..., ne:]), dim=-1))

    z = z_init
    done = torch.zeros(lead, dtype=torch.bool, device=theta.device)
    for _ in range(iters):
        r0_ = residual(z, zero)
        rvio, kvio = violations(r0_)
        done_now = (rvio <= opts.r_tol) & (kvio <= opts.kappa_tol)

        factors = schur_factor(z, kvio)
        d_aff = solve_refined(factors, r0_[..., None])[..., 0]
        y1, y2 = z[..., nx:ne], z[..., ne:]
        a_aff = torch.minimum(_step_length(y1, d_aff[..., nx:ne], one),
                              _step_length(y2, d_aff[..., ne:], one))
        mu = torch.sum(y1 * y2, dim=-1) / ny
        mu_aff = torch.sum((y1 - a_aff[..., None] * d_aff[..., nx:ne])
                           * (y2 - a_aff[..., None] * d_aff[..., ne:]),
                           dim=-1) / ny
        sigma = torch.clamp(mu_aff / torch.clamp(mu, min=tiny), 0.0, 1.0) ** 3
        kappa_t = torch.clamp(sigma * mu, min=kappa_floor)

        r_center = residual(z, kappa_t)
        r_cor = torch.cat([r_center[..., :ne], r_center[..., ne:]
                           + d_aff[..., nx:ne] * d_aff[..., ne:]], dim=-1)
        both = solve_refined(factors, torch.stack([r_cor, r_center], dim=-1))
        d_cor, d_cen = both[..., 0], both[..., 1]

        tau = torch.clamp(1.0 - torch.maximum(rvio, kvio) ** 2,
                          opts.tau_min, opts.tau_max)
        a_cor = torch.minimum(_step_length(y1, d_cor[..., nx:ne], tau),
                              _step_length(y2, d_cor[..., ne:], tau))
        a_cen = torch.minimum(_step_length(y1, d_cen[..., nx:ne], tau),
                              _step_length(y2, d_cen[..., ne:], tau))
        alphas = torch.cat([a_cor[..., None] * halvings,
                            a_cen[..., None] * halvings], dim=-1)  # (..., C)
        dirs = torch.stack([d_cor, d_cen], dim=-2).repeat_interleave(
            n_ls, dim=-2)                                           # (..., C, nz)
        merit0 = torch.sum(r_center ** 2, dim=-1)
        z_c = z[..., None, :] - alphas[..., None] * dirs
        if affine_merit:
            jd = torch.stack([mv(rz_aff, d_cor), mv(rz_aff, d_cen)],
                             dim=-2).repeat_interleave(n_ls, dim=-2)
            eq = r_center[..., None, :ne] - alphas[..., None] * jd
            bil = z_c[..., nx:ne] * z_c[..., ne:] - kappa_t[..., None, None]
            merits = (torch.sum(eq ** 2, dim=-1)
                      + torch.sum(bil ** 2, dim=-1))
        else:
            merits = torch.sum(residual(z_c, kappa_t[..., None]) ** 2,
                               dim=-1)
        ok = merits < (1.0 - 1.0e-3 * alphas) * merit0[..., None]
        pick = torch.where(ok.any(dim=-1), ok.to(torch.int8).argmax(dim=-1),
                           merits.argmin(dim=-1))
        z_new = torch.gather(
            z_c, -2, pick[..., None, None].expand(lead + (1, nz)))[..., 0, :]
        # keep the last finite iterate: a float32 blow-up in the Schur
        # solve must not freeze the lane on NaN for the remaining masked
        # iterations
        keep = done | done_now | ~torch.isfinite(z_new).all(dim=-1)
        z = torch.where(keep[..., None], z, z_new)
        done = done | done_now

    r_final = residual(z, zero)
    rvio, kvio = violations(r_final)
    converged = (rvio <= opts.r_tol) & (kvio <= opts.kappa_tol)

    dz = solve_refined(schur_factor(z, kvio), -rtheta0)
    # sensitivity guard: a singular float32 factorization at a finite z
    # must not poison the horizon-Newton Jacobian blocks — zero the
    # sensitivities and flag the knot instead
    dz_bad = ~torch.isfinite(dz).all(dim=-1).all(dim=-1)
    dz = torch.where(dz_bad[..., None, None], torch.zeros_like(dz), dz)
    converged = converged & ~dz_bad
    return FixedIPResult(z=z, converged=converged, rvio=rvio, kvio=kvio,
                         dz=dz)
