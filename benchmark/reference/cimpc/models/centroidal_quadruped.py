"""Centroidal quadruped: 3D single rigid body + four point feet.

PyTorch counterpart of ``contactimplicitmpc_tpu/models/centroidal_quadruped.py``
(the reference's ``centroidal_quadruped/model.jl``).

Configuration (model.jl:1-10)::

    q = (p_body (3), euler_body (3), f1 (3), f2 (3), f3 (3), f4 (3))

Controls are world-frame forces at the four feet, mapped to body
wrench + foot reactions through B (model.jl:96-119). The bias includes
the gyroscopic term ω × I ω with Euler rates standing in for body rates
(model.jl:75-84). Mass matrix and bias are the reference's analytic ones;
the residual's derivatives come from ``torch.func``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .base import Model
from .rotations import euler_rotation_matrix, skew


class CentroidalQuadruped(Model):
    """model.jl:11-32, :186-208 (nominal instance)."""

    nq, nu, nw, nc = 18, 12, 3, 4

    def __init__(self, mass_body=13.5, inertia_scaling=10.0, mass_foot=0.2,
                 mu_world=0.3, mu_joint=1.0, g=9.81, damped=True):
        self.mass_body = mass_body
        self.inertia_body = np.diag([0.0178533, 0.0377999, 0.0456542]) \
            * inertia_scaling
        self.mass_foot = mass_foot
        self.mu_world = mu_world
        self.mu_joint = mu_joint
        self.g = g
        if damped:
            self.joint_friction = tuple(
                mu_joint * np.concatenate(
                    [10 * np.ones(3), 30 * np.ones(3), 10 * np.ones(12)]))
        else:
            self.joint_friction = tuple(np.zeros(18))

    def kinematics(self, q):
        """Foot positions, (4, 3) (model.jl:60-62)."""
        return q[6:].reshape(4, 3)

    def lagrangian(self, q, v):
        m = self.mass_matrix(q)
        pe = self.g * (self.mass_body * q[2]
                       + self.mass_foot * torch.sum(q[8::3]))
        return 0.5 * torch.dot(v, m @ v) - pe

    def mass_matrix(self, q):
        """model.jl:66-74."""
        def value():
            m = np.diag(np.concatenate([self.mass_body * np.ones(3),
                                        np.zeros(3),
                                        self.mass_foot * np.ones(12)]))
            m[3:6, 3:6] = self.inertia_body
            return m
        return self.const("mass_matrix", value, q)

    def _gravity(self, q):
        return self.const("gravity", np.concatenate(
            [[0.0, 0.0, self.mass_body * self.g], np.zeros(3),
             np.tile([0.0, 0.0, self.mass_foot * self.g], 4)]), q)

    def _gyro(self, v):
        """ω × I ω with the Euler rates v[3:6] as ω."""
        om = v[3:6]
        inertia = self.const("inertia_body", self.inertia_body, v)
        return skew(om) @ (inertia @ om)

    def bias(self, q, v):
        """model.jl:76-85 — gravity + gyroscopic term."""
        z3 = torch.zeros_like(v[:3])
        return self._gravity(q) + torch.cat([z3, self._gyro(v)]
                                            + [z3] * 4)

    def phi(self, env, q):
        """Foot heights (model.jl:87-96) — flat-ground variant."""
        return q[8::3]

    def control_jacobian(self, q):
        """model.jl:98-119 — foot forces to generalized forces, (12, 18):
        foot i's rows are [I, Rᵀ skew(fᵢ − p), −I in foot i's columns]."""
        rot = euler_rotation_matrix(q[3:6])
        r = q[6:].reshape(4, 3) - q[:3]
        eye = self.const("eye3x4", np.broadcast_to(np.eye(3), (4, 3, 3)), q)
        feet = self.const("foot_blocks", -np.kron(np.eye(4), np.eye(3))
                          .reshape(4, 3, 12), q)
        rows = torch.cat([eye, rot.T @ skew(r), feet], dim=-1)
        return rows.reshape(12, 18)

    def disturbance_jacobian(self, q):
        return self.const("disturbance_jacobian", np.eye(3, 18), q)

    def contact_jacobian(self, q):
        """model.jl:126-135 — feet are their own coordinates."""
        return self.const("contact_jacobian",
                          np.concatenate([np.zeros((12, 6)), np.eye(12)], 1),
                          q)


centroidal_quadruped = CentroidalQuadruped()
centroidal_quadruped_undamped = CentroidalQuadruped(damped=False)


def relative_state_cost(qbody, qorientation, qfoot, dtype=torch.float64,
                        device=None):
    """Coupled body/feet tracking weights (model.jl:167-183): penalizes
    foot positions relative to the body. Returns an (18, 18) matrix for
    use as a dense q-cost block, on ``device``, by default the GPU
    (``device.default_device``)."""
    q = np.zeros((18, 18))
    q[:3, :3] = np.diag(qbody)
    q[3:6, 3:6] = np.diag(qorientation)
    foot = np.diag(qfoot)
    for i in range(4):
        s = 6 + 3 * i
        q[:3, :3] += foot
        q[s:s + 3, s:s + 3] += foot
        q[:3, s:s + 3] -= foot
        q[s:s + 3, :3] -= foot
    return torch.as_tensor(q, dtype=dtype, device=resolve_device(device))
