"""2D Raibert-style hopper (hopper_2D/model.jl).

PyTorch counterpart of ``contactimplicitmpc_tpu/models/hopper_2d.py``.
Configuration q = (x, z, t, r): lateral, vertical, body angle, leg length.
Mass matrix, bias and the input Jacobians are the analytic ones of the
reference model.
"""

from __future__ import annotations

import torch

from .base import Model


class Hopper2D(Model):
    """hopper_2D/model.jl:10-29,88-110."""

    nq, nu, nw, nc = 4, 2, 2, 1

    def __init__(self, mb=3.0, ml=0.3, Jb=0.75, Jl=0.075,
                 mu_world=0.8, mu_joint=0.0, g=9.81):
        self.mb = mb
        self.ml = ml
        self.Jb = Jb
        self.Jl = Jl
        self.mu_world = mu_world
        self.mu_joint = mu_joint
        self.g = g
        self.joint_friction = (0.0, 0.0, 0.0, 0.0)

    def _inertia(self, like):
        return self.const("inertia", [self.mb + self.ml, self.mb + self.ml,
                                      self.Jb + self.Jl, self.ml], like)

    def lagrangian(self, q, v):
        # hopper_2D/model.jl:31 declares L = 0; the analytic M/C below are used
        return (0.5 * torch.dot(v, self._inertia(q) * v)
                - (self.mb + self.ml) * self.g * q[1])

    def mass_matrix(self, q):
        """hopper_2D/model.jl:40-45."""
        return torch.diag(self._inertia(q))

    def bias(self, q, v):
        """hopper_2D/model.jl:47-52."""
        return self.const("bias", [0.0, (self.mb + self.ml) * self.g, 0.0,
                                   0.0], q)

    def kinematics(self, q):
        """Foot position (hopper_2D/model.jl:34-37)."""
        return torch.stack([q[0] + q[3] * torch.sin(q[2]),
                            q[1] - q[3] * torch.cos(q[2])])[None, :]

    def control_jacobian(self, q):
        """hopper_2D/model.jl:64-67."""
        z = torch.zeros_like(q[0])
        o = torch.ones_like(q[0])
        return torch.stack([
            torch.stack([z, z, o, z]),
            torch.stack([-torch.sin(q[2]), torch.cos(q[2]), z, o]),
        ])

    def disturbance_jacobian(self, q):
        """hopper_2D/model.jl:69-72."""
        return self.const("disturbance_jacobian",
                          [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]], q)

    def contact_jacobian(self, q):
        """hopper_2D/model.jl:59-62."""
        z = torch.zeros_like(q[0])
        o = torch.ones_like(q[0])
        return torch.stack([
            torch.stack([o, z, q[3] * torch.cos(q[2]), torch.sin(q[2])]),
            torch.stack([z, o, q[3] * torch.sin(q[2]), -torch.cos(q[2])]),
        ])


hopper_2d = Hopper2D()
