"""Contact-NCP residual: one physics step as a nonlinear complementarity
problem.

PyTorch counterpart of ``contactimplicitmpc_tpu/sim/residual.py``.
``residual`` acts on one sample; ``jacfwd`` of it gives ``rz`` and ``rθ``,
and ``torch.func.vmap`` batches both.

Residual rows for the linearized cone (simulation.jl:133-158)::

    r = [ d(h, q0, q1, u1, w1, Jᵀλ1, q2)          dynamics        (nq)
          s1 - ϕ(q2) + alt                         impact          (nc)
          η1 - vT(q1,q2) - Eᵀψ1                    max dissipation (nb)
          s2 - (μ γ1 - E b1)                       friction cone   (nc)
          γ1 ∘ s1 - κ                              bilinear        (nc)
          b1 ∘ η1 - κ                              bilinear        (nb)
          ψ1 ∘ s2 - κ ]                            bilinear        (nc)

and for the nonlinear (second-order) cone (simulation.jl:160-186) the rows
``η1 - vT``, ``s2 - μ γ1``, ``γ1 ∘ s1 - κ`` and, per contact, the Jordan
product ``[ψᵢ; ηᵢ] ∘ [s2ᵢ; bᵢ] - [κ; 0]``.

``alt`` is the per-contact altitude offset of the MPC's linearized model
(linearized_solver.jl:370); the physics leaves it out (zero).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ..dims import Dims
from ..env import LINEARIZED_CONE
from ..models.base import (Model, contact_forces, dims_of, dynamics,
                           e_mapping, velocity_stack)
from ..ops.soc import soc_product


def unpack_z(dims: Dims, z):
    """index.jl:417-435; works on the last axis."""
    return (z[..., dims.iq2], z[..., dims.igamma1], z[..., dims.ib1],
            z[..., dims.ipsi1], z[..., dims.is1], z[..., dims.ieta1],
            z[..., dims.is2])


def unpack_theta(dims: Dims, theta):
    """index.jl:396-411; works on the last axis."""
    return (theta[..., dims.iq0], theta[..., dims.iq1], theta[..., dims.iu1],
            theta[..., dims.iw1], theta[..., dims.imu], theta[..., dims.ih])


def pack_z(q2, gamma1, b1, psi1, s1, eta1, s2):
    """index.jl:449-451; concatenates on the last axis."""
    return torch.cat([q2, gamma1, b1, psi1, s1, eta1, s2], dim=-1)


def _e_mapping(model: Model, dims: Dims, like):
    return model.const(("e_mapping", dims.nc, dims.nf),
                       lambda: e_mapping(dims, torch.float64), like)


def pack_z_consistent(model: Model, env, q2, gamma1, b1, psi1, eta1):
    """index.jl:437-447 — the slacks derived from the primal variables, for
    one sample (``torch.func.vmap`` batches it)."""
    dims = dims_of(model, env)
    s1 = model.phi(env, q2)
    if env.cone == LINEARIZED_CONE:
        s2 = model.mu_world * gamma1 - _e_mapping(model, dims, q2) @ b1
    else:
        s2 = model.mu_world * gamma1
    return pack_z(q2, gamma1, b1, psi1, s1, eta1, s2)


def pack_theta(q0, q1, u1, w1, mu, h):
    """index.jl:413-415; ``mu`` and ``h`` are scalars or tensors of the
    leading shape of ``q0``."""
    def column(x):
        if isinstance(x, torch.Tensor):
            return x.to(q0.dtype).expand(q0.shape[:-1])[..., None]
        return torch.full(q0.shape[:-1] + (1,), x, dtype=q0.dtype,
                          device=q0.device)

    return torch.cat([q0, q1, u1, w1, column(mu), column(h)], dim=-1)


def residual(model: Model, env, z, theta, kappa, alt=None):
    """NCP residual r(z, θ, κ) of one sample (simulation.jl:133-186)."""
    dims = dims_of(model, env)
    q2, gamma1, b1, psi1, s1, eta1, s2 = unpack_z(dims, z)
    q0, q1, u1, w1, mu, h = unpack_theta(dims, theta)

    phi = model.phi(env, q2)
    k = model.kinematics(q2)
    lam1 = contact_forces(model, env, gamma1, b1, q2, k)
    cap_lam1 = model.contact_jacobian(q2).T @ lam1
    vt = velocity_stack(model, env, q1, q2, k, h)

    d = dynamics(model, h, q0, q1, u1, w1, cap_lam1, q2)
    impact = s1 - phi if alt is None else s1 - phi + alt

    if env.cone == LINEARIZED_CONE:
        e = _e_mapping(model, dims, z)
        return torch.cat([
            d,
            impact,
            eta1 - vt - e.T @ psi1,
            s2 - (mu * gamma1 - e @ b1),
            gamma1 * s1 - kappa,
            b1 * eta1 - kappa,
            psi1 * s2 - kappa,
        ])

    # nonlinear (second-order) cone, simulation.jl:160-186: per contact
    # [ψᵢ; ηᵢ] ∘ [s2ᵢ; bᵢ] − [κ; 0], the contacts a leading axis
    nc, nf = dims.nc, dims.nf
    prod = soc_product(torch.cat([psi1[:, None], eta1.reshape(nc, nf)], -1),
                       torch.cat([s2[:, None], b1.reshape(nc, nf)], -1))
    return torch.cat([
        d,
        impact,
        eta1 - vt,
        s2 - mu * gamma1,
        gamma1 * s1 - kappa,
        torch.cat([prod[:, :1] - kappa, prod[:, 1:]], dim=-1).reshape(-1),
    ])


def residual_z_jacobian(model: Model, env, z, theta):
    """rz = ∂r/∂z via forward-mode autodiff."""
    return jacfwd(lambda zz: residual(model, env, zz, theta, 0.0))(z)


def residual_theta_jacobian(model: Model, env, z, theta):
    """rθ = ∂r/∂θ via forward-mode autodiff."""
    return jacfwd(lambda tt: residual(model, env, z, tt, 0.0))(theta)
