"""Second-order-cone operations for the nonlinear-friction-cone NCP.

PyTorch counterpart of ``contactimplicitmpc_tpu/ops/soc.py``. The NC
formulation (index.jl:345-369, simulation.jl:160-186) keeps orthant
complementarity for impact (γ ⟂ s1) and second-order-cone complementarity
per contact between the primal cone [ψᵢ; ηᵢ] and the dual cone [s2ᵢ; bᵢ].
Both functions act on the last axis and broadcast over any leading axes
(lanes, contacts).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dims import Dims


def soc_product(u, v):
    """u ∘ v = [uᵀv; u0 v̄ + v0 ū] (Jordan product) over the last axis."""
    return torch.cat([torch.sum(u * v, dim=-1, keepdim=True),
                      u[..., :1] * v[..., 1:] + v[..., :1] * u[..., 1:]],
                     dim=-1)


def soc_step_length(u, du, tau):
    """Largest α ∈ (0, 1] with u − α·du ∈ K (scaled by τ), over the last
    axis; ``tau`` broadcasts against the leading shape.

    Solves the boundary quadratic of λmin(u − α du) = 0:
    (u0 − α d0)² = ‖ū − α d̄‖², u0 − α d0 ≥ 0. Each guard is elementwise,
    since the problems of a batch take different branches: |a| ≤ 1e-20
    (the quadratic degenerates to the linear root), the 1e20 sentinel for a
    root that does not limit, and the scalar face u0 − α d0 ≥ 0.
    """
    u0, ub = u[..., 0], u[..., 1:]
    d0, db = du[..., 0], du[..., 1:]
    # quadratic a α² + b α + c = 0 with
    a = d0 * d0 - torch.sum(db * db, dim=-1)
    b = -2.0 * (u0 * d0 - torch.sum(ub * db, dim=-1))
    c = u0 * u0 - torch.sum(ub * ub, dim=-1)          # ≥ 0 inside the cone
    sq = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
    eps, big = 1e-20, 1e20                    # both finite in float32
    quad = a.abs() > eps
    a_safe = torch.where(quad, a, eps)
    r1 = (-b - sq) / (2.0 * a_safe)
    r2 = (-b + sq) / (2.0 * a_safe)
    r_lin = -c / torch.where(b.abs() > eps, b, eps)
    roots = torch.stack([r1, r2, torch.where(quad, big, r_lin)], dim=-1)
    # smallest positive root = distance to the boundary
    sigma = torch.amin(torch.where(roots > 0, roots, big), dim=-1)
    # also respect the scalar face u0 − α d0 ≥ 0
    sigma0 = torch.where(d0 > 0, u0 / d0, big)
    return torch.clamp(tau * torch.minimum(sigma, sigma0), max=1.0)


class NCConeLayout:
    """Static index sets of the NC cone structure (index.jl:345-369)."""

    def __init__(self, dims: Dims):
        nq, nc, nf = dims.nq, dims.nc, dims.nf
        # orthant pair: γ (iy1 head) ⟂ s1 (iy2 head)
        self.ort_a = np.arange(nq, nq + nc)                      # γ1
        self.ort_b = np.arange(dims.is1.start, dims.is1.stop)    # s1
        # per-contact SOC pairs: u = [ψ_i; η_i], v = [s2_i; b_i]
        u_idx, v_idx = [], []
        for i in range(nc):
            psi = dims.ipsi1.start + i
            eta = dims.ieta1.start + i * nf
            s2 = dims.is2.start + i
            b = dims.ib1.start + i * nf
            u_idx.append([psi] + list(range(eta, eta + nf)))
            v_idx.append([s2] + list(range(b, b + nf)))
        self.soc_u = np.asarray(u_idx)   # (nc, nf+1)
        self.soc_v = np.asarray(v_idx)
        # bilinear residual rows: orthant rows then per-contact soc rows
        self.bil_ort_rows = np.arange(dims.ibil.start,
                                      dims.ibil.start + nc)
        self.bil_soc_rows = np.asarray(
            [list(range(dims.ibil.start + nc + i * (nf + 1),
                        dims.ibil.start + nc + (i + 1) * (nf + 1)))
             for i in range(nc)])
