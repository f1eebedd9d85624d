"""Small-matrix dense solvers over a leading batch of problems.

PyTorch counterpart of ``contactimplicitmpc_tpu/ops/linsolve.py``:
unpivoted Gauss-Jordan, LDLᵀ and modified Gram-Schmidt QR whose steps are
rank-1 updates across the batch. Pivot-free is safe by construction (the cone Schur complement is the
matrix the reference factorizes with unpivoted QR; the dynamics block is
mass-matrix dominated; the ±β-regularized horizon KKT is symmetric
quasidefinite). A tiny magnitude floor on the pivot guards exact
zeros. Full float32 products are pinned in the package ``__init__``, so
the JAX package's ``pdot`` (a HIGHEST-precision product) is ``@`` here.
"""

from __future__ import annotations

import torch


def mv(m, v):
    """Batched matrix-vector product (..., r, c) × (..., c) → (..., r)."""
    return torch.matmul(m, v[..., None])[..., 0]


def _boost_pivot(piv, boost):
    sign = torch.where(piv >= 0, 1.0, -1.0).to(piv.dtype)
    return torch.where(piv.abs() < boost, sign * boost, piv)


def _boost_of(a, boost: float):
    return boost if boost else torch.finfo(a.dtype).tiny


def gj_inverse(a, boost: float = 0.0):
    """Inverse of each (n, n) matrix of ``a`` (..., n, n) by unpivoted
    Gauss-Jordan elimination, pivots floored in magnitude at ``boost``
    (the dtype's ``tiny`` when 0; ops/linsolve.py:54-75)."""
    n = a.shape[-1]
    boost = _boost_of(a, boost)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    ab = torch.cat([a, eye.expand(a.shape)], dim=-1)
    for k in range(n):
        piv = _boost_pivot(ab[..., k, k], boost)
        row = ab[..., k, :] / piv[..., None]
        upd = ab - ab[..., :, k, None] * row[..., None, :]
        ab = torch.cat([upd[..., :k, :], row[..., None, :],
                        upd[..., k + 1:, :]], dim=-2)
    return ab[..., n:]


class GJFactors:
    """Opaque factor handle: Gauss-Jordan stores the inverse explicitly."""

    __slots__ = ("inv",)

    def __init__(self, inv):
        self.inv = inv


def gj_factor(a, boost: float = 0.0) -> GJFactors:
    return GJFactors(gj_inverse(a, boost))


def gj_apply(factors: GJFactors, b):
    """``b`` (..., n) or (..., n, R) through the stored inverse."""
    b, vec = _columns(b, factors.inv)
    x = factors.inv @ b
    return x[..., 0] if vec else x


def _columns(b, a):
    """``b`` as right-hand-side columns of ``a`` (..., n, n), and whether it
    came as a vector (..., n)."""
    vec = b.dim() == a.dim() - 1
    return (b[..., None] if vec else b), vec


def gj_solve(a, b, boost: float = 0.0):
    """Solve ``a x = b``; ``b`` is (..., n) or (..., n, R)."""
    b, vec = _columns(b, a)
    x = gj_inverse(a, boost) @ b
    return x[..., 0] if vec else x


def mgs_qr(a):
    """Modified Gram-Schmidt QR (the reference's SDMGS factorization,
    qr.jl:62-118) of each matrix of ``a`` (..., n, n): (Q, R) with
    orthonormal columns in Q and R upper triangular; n dependent steps of
    column updates."""
    n = a.shape[-1]
    tiny = torch.finfo(a.dtype).tiny
    q = a
    rows = []
    for j in range(n):
        v = q[..., :, j]
        nrm = torch.clamp(torch.sqrt(torch.sum(v * v, dim=-1)), min=tiny)
        qj = v / nrm[..., None]
        # project qj out of the remaining columns (qr.jl:84-96)
        proj = mv(q[..., :, j + 1:].mT, qj)
        q = torch.cat([q[..., :, :j], qj[..., None],
                       q[..., :, j + 1:] - qj[..., None] * proj[..., None, :]],
                      dim=-1)
        rows.append(torch.cat([torch.zeros_like(a[..., 0, :j]),
                               nrm[..., None], proj], dim=-1))
    return q, torch.stack(rows, dim=-2)


def mgs_solve(a, b):
    """Solve via MGS QR: x = R⁻¹ Qᵀ b (qr_solve!, qr.jl:24-39)."""
    b, vec = _columns(b, a)
    q, r = mgs_qr(a)
    x = torch.linalg.solve_triangular(r, q.mT @ b, upper=True)
    return x[..., 0] if vec else x


def ldl_factor(a, boost: float = 0.0):
    """Unpivoted LDLᵀ of each symmetric (quasi-definite) matrix of ``a``
    (..., n, n), the role QDLDL fills for the Newton KKT (ldl.jl:4-180):
    (L, d) with L unit lower triangular and d the diagonal of D. ``d``
    carries the boosted pivot that scaled L's column, so that L diag(d) Lᵀ
    reproduces the boost-regularized matrix. n dependent rank-1 updates of
    the trailing block."""
    n = a.shape[-1]
    boost = _boost_of(a, boost)
    work = a.clone()
    l = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    d = torch.empty(a.shape[:-1], dtype=a.dtype, device=a.device)
    for k in range(n):
        piv = _boost_pivot(work[..., k, k], boost)
        col = work[..., k + 1:, k] / piv[..., None]
        work[..., k + 1:, k + 1:] -= (piv[..., None, None] * col[..., :, None]
                                      * col[..., None, :])
        l[..., k + 1:, k] = col
        d[..., k] = piv
    return l, d


def ldl_solve(a, b, boost: float = 0.0):
    """Solve ``a x = b`` with ``a`` symmetric via LDLᵀ (QDLDL's solve
    phase); ``b`` is (..., n) or (..., n, R)."""
    b, vec = _columns(b, a)
    l, d = ldl_factor(a, boost)
    y = torch.linalg.solve_triangular(l, b, upper=False, unitriangular=True)
    y = y / _boost_pivot(d, _boost_of(a, boost))[..., None]
    x = torch.linalg.solve_triangular(l.mT, y, upper=True, unitriangular=True)
    return x[..., 0] if vec else x
