"""Pre-linearized residual data for the MPC's smooth implicit-dynamics
model.

PyTorch counterpart of ``contactimplicitmpc_tpu/control/linearized.py``:
the linearization data is a stack of dense ``(H, nz, nz)`` /
``(H, nz, nθ)`` tensors. Residual semantics (rlin!,
linearized_solver.jl:364-373)::

    r_dyn,rst(z, θ) = r0 + rz0 (z − z0) + rθ0 (θ − θ0)   (affine rows)
    r_bil(z, κ)     = y1 ∘ y2 − κ                        (exact rows)
    r_rst[imp]     += alt                                 (altitude shift)
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from ..dims import Dims
from ..models.base import Model
from ..ops.linsolve import gj_inverse, mv
from ..sim.residual import (residual, residual_theta_jacobian,
                            residual_z_jacobian)
from ..utils.spans import span
from .trajectory import ContactTraj


class LinearizedData(NamedTuple):
    """Stacked LinearizedStep (linearized_step.jl:1-29): linearization
    points and Jacobians for every knot of a reference trajectory."""

    z0: torch.Tensor        # (H, nz)
    theta0: torch.Tensor    # (H, nθ)
    r0: torch.Tensor        # (H, nz)  residual at (z0, θ0, κ)
    rz0: torch.Tensor       # (H, nz, nz)
    rtheta0: torch.Tensor   # (H, nz, nθ)


def linearize_trajectory(model: Model, env, traj: ContactTraj,
                         kappa) -> LinearizedData:
    """Evaluate r, rz, rθ at every knot of ``traj``
    (implicit_dynamics.jl:56-68)."""
    kappa = float(kappa)

    def one(z0, th0):
        return (residual(model, env, z0, th0, kappa),
                residual_z_jacobian(model, env, z0, th0),
                residual_theta_jacobian(model, env, z0, th0))

    with span("linearize"):
        r0, rz0, rt0 = vmap(one)(traj.z, traj.theta)
    return LinearizedData(z0=traj.z, theta0=traj.theta, r0=r0, rz0=rz0,
                          rtheta0=rt0)


def gather(lin: LinearizedData, idx) -> LinearizedData:
    """Select the knots covered by the receding-horizon window."""
    idx = torch.as_tensor(idx, device=lin.z0.device)
    return LinearizedData(*(torch.index_select(a, 0, idx) for a in lin))


def linearized_residual_fns(dims: Dims, z0, theta0, r0, rz0, rtheta0, alt):
    """Residual/Jacobian callbacks of a batch of knots' linearized models,
    in the batched form of ``ip_solve(..., batched=True)``: problem ``i``
    uses row ``i`` of every tensor here (``z0`` (N, nz) … ``rtheta0``
    (N, nz, nθ), ``alt`` (N, nc))."""
    nx, ne = dims.nx, dims.nx + dims.ny
    nq, nc, nz = dims.nq, dims.nc, dims.nz
    alt_rows = torch.cat([alt.new_zeros(alt.shape[:-1] + (nq,)), alt,
                          alt.new_zeros(alt.shape[:-1] + (ne - nq - nc,))],
                         dim=-1)
    rz_aff = rz0[..., :ne, :]

    def r_fn(z, th, kap):
        """``z`` (N, nz) with ``kap`` (N,), or (N, C, nz) with (N, C)."""
        base = (r0 + mv(rtheta0, th - theta0))[..., :ne] + alt_rows
        if z.dim() == 3:
            affine = base[:, None] + mv(rz_aff[:, None], z - z0[:, None])
        else:
            affine = base + mv(rz_aff, z - z0)
        bil = z[..., nx:ne] * z[..., ne:] - kap[..., None]
        return torch.cat([affine, bil], dim=-1)

    def rz_fn(z, th):
        # constant affine rows; the solver refreshes the bilinear diagonals
        return rz0

    def rtheta_fn(z, th):
        return rtheta0

    return r_fn, rz_fn, rtheta_fn


def make_schur_solver(dims: Dims, rz0, opts):
    """Structured linear-system backend of the linearized IP solve
    (linear_solve!, linearized_solver.jl:424-444) for a batch of knots
    ``rz0`` (N, nz, nz).

    The Jacobian is ``[[Dx Dy1 0]; [Rx Ry1 diag(Ry2)]; [0 diag(y2)
    diag(y1)]]`` with only the bilinear diagonals changing per IP
    iteration. Eliminating y2 diagonally leaves a 2×2 block system whose
    Schur complement about the constant ``Dx`` needs one ny×ny
    factorization per iteration; Dx⁻¹, Rx Dx⁻¹ and Rx Dx⁻¹ Dy1 are formed
    once per linearization point (RZLin, linearized_solver.jl:224-304).
    """
    nx, ne = dims.nx, dims.nx + dims.ny
    dy1 = rz0[:, :nx, nx:ne]
    ry1 = rz0[:, nx:ne, nx:ne]
    ry2 = torch.diagonal(rz0[:, nx:ne, ne:], dim1=-2, dim2=-1)
    dxi = gj_inverse(rz0[:, :nx, :nx])
    cai = rz0[:, nx:ne, :nx] @ dxi
    caib = cai @ dy1

    def factor(z, theta, kvio):
        reg = opts.gamma_reg * kvio[:, None]
        y1r = torch.maximum(z[:, nx:ne], reg)
        y2r = torch.maximum(z[:, ne:], reg)
        d = ry1 - torch.diag_embed(ry2 * y2r / y1r)
        return gj_inverse(d - caib), y1r, y2r

    def solve(factors, rhs):
        si, y1r, y2r = factors
        vec = rhs.dim() == 2
        r = rhs[..., None] if vec else rhs
        rdyn, rrst, rbil = r[:, :nx], r[:, nx:ne], r[:, ne:]
        v = rrst - (ry2 / y1r)[..., None] * rbil
        temp = si @ (cai @ rdyn - v)
        x = dxi @ (rdyn + dy1 @ temp)
        dy2 = (rbil + y2r[..., None] * temp) / y1r[..., None]
        out = torch.cat([x, -temp, dy2], dim=1)
        return out[..., 0] if vec else out

    return factor, solve
