"""3D particle model (particle/model.jl).

PyTorch counterpart of ``contactimplicitmpc_tpu/models/particle.py``.
"""

from __future__ import annotations

import torch

from .base import Model

_EYE3 = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]


class Particle(Model):
    """Point mass in R³, one contact (particle/model.jl:13-27,113-121)."""

    nq, nu, nw, nc = 3, 3, 3, 1

    def __init__(self, m=1.0, g=9.81, mu_world=1.0, mu_joint=0.0):
        self.m = m
        self.g = g
        self.mu_world = mu_world
        self.mu_joint = mu_joint
        self.joint_friction = (0.0, 0.0, 0.0)

    def lagrangian(self, q, v):
        """particle/model.jl:29-36."""
        return 0.5 * self.m * torch.dot(v, v) - self.m * self.g * q[2]

    def mass_matrix(self, q):
        return self.m * self.const("eye3", _EYE3, q)

    def bias(self, q, v):
        return self.const("bias", [0.0, 0.0, self.m * self.g], q)

    def kinematics(self, q):
        return q[None, :]

    def control_jacobian(self, q):
        return self.const("eye3", _EYE3, q)

    def disturbance_jacobian(self, q):
        return self.const("eye3", _EYE3, q)

    def contact_jacobian(self, q):
        return self.const("eye3", _EYE3, q)


particle = Particle()
