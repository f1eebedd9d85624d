"""Time-varying LQR gains around linearized contact dynamics.

PyTorch counterpart of ``contactimplicitmpc_tpu/control/gains.py`` (the
reference's ``gains.jl``). The backward Riccati recursion is a Python loop
over the knots; the contact-dynamics Jacobians come from the linearized
sensitivity ``∂z/∂θ = −rz⁻¹ rθ`` as in ``reference_gains``
(gains.jl:17-51), with the two-configuration state x = (q1, q2).
"""

from __future__ import annotations

import torch

from ..models.base import Model, dims_of
from .linearized import linearize_trajectory
from .objective import TrackingVelocityObjective
from .trajectory import ContactTraj


def tvlqr(a, b, q, r):
    """Discrete-time backward Riccati sweep (gains.jl:1-16).

    a: (T-1, n, n), b: (T-1, n, m), q: (T, n, n), r: (T-1, m, m).
    Returns gains K (T-1, m, n) and cost-to-go P (T, n, n).
    """
    p_next = q[-1]
    ks, ps = [], [p_next]
    for t in range(a.shape[0] - 1, -1, -1):
        btp = b[t].mT @ p_next
        k_t = torch.linalg.solve(r[t] + btp @ b[t], btp @ a[t])
        acl = a[t] - b[t] @ k_t
        p_next = q[t] + k_t.mT @ r[t] @ k_t + acl.mT @ p_next @ acl
        ks.append(k_t)
        ps.append(p_next)
    k = (torch.stack(ks[::-1]) if ks
         else b.new_zeros((0, b.shape[-1], b.shape[-2])))
    return k, torch.stack(ps[::-1])


def reference_gains(model: Model, env, traj: ContactTraj, obj, *,
                    periods: int = 10, kappa: float = 2e-4,
                    u_scaling: float = 100.0, v_scaling: float = 100.0):
    """TVLQR gains about a reference contact trajectory
    (reference_gains, gains.jl:17-51): tile the gait ``periods`` times,
    build A, B from the per-knot solution sensitivities, and run the
    Riccati sweep; return the first gait period's gains (H, nu, 2nq), on
    the device of ``traj``."""
    dims = dims_of(model, env)
    nq, nu = dims.nq, dims.nu
    horizon = traj.horizon
    total = periods * horizon
    dtype, device = traj.q.dtype, traj.q.device

    lin = linearize_trajectory(model, env, traj, kappa)
    dzdth = (-torch.linalg.solve(lin.rz0, lin.rtheta0)).repeat(periods, 1, 1)
    dq3dq1 = dzdth[:, dims.iq2, dims.iq0]
    dq3dq2 = dzdth[:, dims.iq2, dims.iq1]
    dq3du = dzdth[:, dims.iq2, dims.iu1]

    znn = torch.zeros((total, nq, nq), dtype=dtype, device=device)
    eye = torch.eye(nq, dtype=dtype, device=device).expand(total, nq, nq)
    a = torch.cat([torch.cat([znn, eye], dim=2),
                   torch.cat([dq3dq1, dq3dq2], dim=2)], dim=1)
    b = torch.cat([torch.zeros((total, nq, nu), dtype=dtype, device=device),
                   dq3du], dim=1)

    weight = lambda w: torch.diag(torch.as_tensor(w, dtype=dtype,
                                                  device=device))
    qw = weight(obj.q[0])
    vw = v_scaling * weight(obj.v[0] if isinstance(
        obj, TrackingVelocityObjective) else torch.zeros(nq))
    q_blk = torch.cat([torch.cat([qw + vw, -vw], dim=1),
                       torch.cat([-vw, qw + vw], dim=1)], dim=0)
    q = q_blk.expand(total + 1, 2 * nq, 2 * nq)
    r = (u_scaling * weight(obj.u[0])).expand(total, nu, nu)

    k, _ = tvlqr(a, b, q, r)
    return k[:horizon]
