"""Implicit (smoothed) contact dynamics for the MPC: batched linearized
interior-point solves with sensitivities.

PyTorch counterpart of
``contactimplicitmpc_tpu/control/implicit_dynamics.py``. The H knots of
every lane (and of every line-search trial) are one batch of problems.

Outputs per knot t (implicit_dynamics.jl:156-192):

* ``d``  — dynamics violation ``z*[:nd] − [q2ref; γref; bref]``
  (mode ``configurationforce``) or ``z*[:nq] − q2ref`` (``configuration``)
* ``dq0, dq1, du1`` — sensitivity blocks ``∂z*[:nd]/∂(q0, q1, u1)``
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..dims import Dims
from ..ops.knot_ip import knot_ip
from ..sim.interior_point import IPOptions, ip_solve
from .linearized import (LinearizedData, linearized_residual_fns,
                         make_schur_solver)
from .trajectory import ContactTraj

CONFIGURATION = "configuration"
CONFIGURATION_FORCE = "configurationforce"


def nd_of(dims: Dims, mode: str) -> int:
    """implicit_dynamics.jl:46-52."""
    if mode == CONFIGURATION_FORCE:
        return dims.nq + dims.nc + dims.nb
    if mode == CONFIGURATION:
        return dims.nq
    raise ValueError(f"invalid mode {mode!r}")


def default_mpc_ip_options(kappa: float, max_iter: int = 100) -> IPOptions:
    """ImplicitTrajectory defaults (implicit_dynamics.jl:25-32)."""
    return IPOptions(r_tol=1.0e-8, kappa_tol=float(kappa), max_iter=max_iter,
                     undercut=5.0, gamma_reg=0.1, diff_sol=True)


def adaptive_knot_solve(dims: Dims, lin: LinearizedData, alt, theta,
                        q2_init, opts: IPOptions):
    """The adaptive ``ip_solve`` over the linearized residual, all problems
    one batch: ``theta`` (..., K, nθ) with ``alt`` (..., K, nc) and
    ``q2_init`` (..., K, nq), problem ``(..., k)`` about knot ``k`` of
    ``lin``. Returns (z, dz, converged) with the leading shape (..., K)."""
    opts = dataclasses.replace(opts, diff_sol=True, fixed_iters=0)
    lead = theta.shape[:-1]
    flat = lambda x, k: x.expand(lead + x.shape[-k:]).reshape(
        (-1,) + x.shape[-k:])
    knots = [flat(x, k) for x, k in zip(lin, (1, 1, 1, 2, 2))]
    r_fn, rz_fn, rt_fn = linearized_residual_fns(dims, *knots, flat(alt, 1))
    theta = flat(theta, 1)
    z0 = torch.cat([flat(q2_init, 1), theta.new_ones(
        (theta.shape[0], dims.nz - dims.nq))], dim=-1)
    res = ip_solve(dims, r_fn, z0, theta, opts, jacobian_fn=rz_fn,
                   rtheta_fn=rt_fn,
                   linear_solver=make_schur_solver(dims, knots[3], opts),
                   batched=True)
    return (res.z.reshape(lead + (dims.nz,)),
            res.dz.reshape(lead + (dims.nz, dims.ntheta)),
            res.converged.reshape(lead))


class ImplicitDynamicsResult(NamedTuple):
    """Leading shape (..., H): the lanes (and trials), then the knots."""

    d: torch.Tensor          # (..., H, nd) dynamics violation
    dq0: torch.Tensor        # (..., H, nd, nq)
    dq1: torch.Tensor        # (..., H, nd, nq)
    du1: torch.Tensor        # (..., H, nd, nu)
    z: torch.Tensor          # (..., H, nz) solved knots
    converged: torch.Tensor  # (..., H)


def implicit_dynamics(dims: Dims, mode: str, lin: LinearizedData,
                      traj: ContactTraj, alt, opts: IPOptions,
                      fixed_iters: int = 0) -> ImplicitDynamicsResult:
    """Solve all H knots of the smooth implicit model around ``lin`` for
    the trajectories ``traj``, whose leaves carry any leading shape
    (``q`` (..., H+2, nq), ``theta`` (..., H, nθ)); ``alt`` is (..., nc).

    ``lin`` holds the H knots of the horizon window
    (implicit_dynamics.jl:160-178: lin index = window, traj index = i).

    ``fixed_iters > 0`` takes the fixed-iteration knot solve
    (``ops/knot_ip.py``: the CUDA kernel on CUDA tensors); 0 the adaptive
    ``ip_solve`` over the linearized residual.
    """
    nd = nd_of(dims, mode)
    horizon = traj.horizon
    lead = traj.theta.shape[:-1]                       # (..., H)
    q2_init = traj.q[..., 2:horizon + 2, :]
    alt_p = alt[..., None, :].expand(lead + (dims.nc,))

    if fixed_iters > 0:
        res = knot_ip(dims, lin.z0, lin.theta0, lin.r0, lin.rz0, lin.rtheta0,
                      alt_p.contiguous(), traj.theta.contiguous(),
                      q2_init.contiguous(), opts, iters=fixed_iters)
        z, dz, converged = res.z, res.dz, res.converged
    else:
        z, dz, converged = adaptive_knot_solve(dims, lin, alt_p, traj.theta,
                                               q2_init, opts)

    # dynamics violation (implicit_dynamics.jl:180-190)
    if mode == CONFIGURATION_FORCE:
        ref = torch.cat([q2_init, traj.gamma, traj.b], dim=-1)
    else:
        ref = q2_init
    d = z[..., :nd] - ref
    # sensitivity views (implicit_dynamics.jl:83-86): δz rows 1:nd, θ-cols
    return ImplicitDynamicsResult(
        d=d, dq0=dz[..., :nd, dims.iq0], dq1=dz[..., :nd, dims.iq1],
        du1=dz[..., :nd, dims.iu1], z=z, converged=converged)
