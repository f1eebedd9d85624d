"""Rotation utilities: quaternions, modified Rodrigues parameters, Euler.

PyTorch counterpart of ``contactimplicitmpc_tpu/models/rotations.py``
(the reference's ``quaternions.jl``, ``mrp.jl`` and ``euler.jl``). Quaternions
are (w, x, y, z). Every function takes its vector on the last axis and any
leading batch shape ``(...)``; matrices come out as ``(..., m, n)``.
"""

from __future__ import annotations

import torch


def _mat(rows):
    """(..., m, n) from m lists of n tensors of one shape (...)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def skew(v):
    """(..., 3, 3): skew(v) @ x = v × x."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return _mat([[o, -z, y], [z, o, -x], [-y, x, o]])


def conjugate(q):
    """quaternions.jl:10-15."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _eye3(q):
    return torch.eye(3, dtype=q.dtype, device=q.device).expand(
        q.shape[:-1] + (3, 3))


def _multiply_matrix(q, sign):
    s, v = q[..., :1], q[..., 1:]
    top = torch.cat([s, -v], dim=-1)[..., None, :]
    bottom = torch.cat([v[..., :, None],
                        s[..., None] * _eye3(q) + sign * skew(v)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def l_multiply(q):
    """Left-multiplication matrix (quaternions.jl:17-24)."""
    return _multiply_matrix(q, 1.0)


def r_multiply(q):
    """Right-multiplication matrix (quaternions.jl:26-33)."""
    return _multiply_matrix(q, -1.0)


def multiply(q1, q2):
    return (l_multiply(q1) @ q2[..., None])[..., 0]


def attitude_jacobian(q):
    """quaternions.jl:36-43 (planning-with-attitude eq. 14), (..., 4, 3)."""
    s, v = q[..., :1], q[..., 1:]
    return torch.cat([-v[..., None, :], s[..., None] * _eye3(q) + skew(v)],
                     dim=-2)


def quaternion_rotation_matrix(q):
    """Rotation matrix of a unit quaternion."""
    w, x, y, z = q.unbind(-1)
    return _mat([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def mrp_quaternion_map(mrp):
    """mrp.jl:1-6."""
    n2 = torch.sum(mrp * mrp, dim=-1, keepdim=True)
    m = 2.0 / (1.0 + n2)
    return torch.cat([(1.0 - n2) / (1.0 + n2), m * mrp], dim=-1)


def mrp_rotation_matrix(mrp):
    """mrp.jl:8 — matches Rotations.jl MRP convention."""
    return quaternion_rotation_matrix(mrp_quaternion_map(mrp))


def euler_rotation_matrix(euler):
    """ZYX Euler (roll-pitch-yaw) rotation matrix (euler.jl): Rz Ry Rx."""
    r, p, y = euler.unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    o, i = torch.zeros_like(r), torch.ones_like(r)
    rz = _mat([[cy, -sy, o], [sy, cy, o], [o, o, i]])
    ry = _mat([[cp, o, sp], [o, i, o], [-sp, o, cp]])
    rx = _mat([[i, o, o], [o, cr, -sr], [o, sr, cr]])
    return rz @ ry @ rx
