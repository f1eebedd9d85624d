"""3D hopper with MRP orientation (hopper_3D/model.jl).

PyTorch counterpart of ``contactimplicitmpc_tpu/models/hopper_3d.py``.
q = (px, py, pz, mrp_x, mrp_y, mrp_z, r): body position, modified
Rodrigues parameters, leg length. Mass matrix and bias are the reference's
analytic ones; the contact Jacobian is ``torch.func.jacfwd`` of the foot's
position, as the JAX package takes it by ``jax.jacfwd``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from .base import Model
from .rotations import mrp_rotation_matrix


class Hopper3D(Model):
    """hopper_3D/model.jl:7-28, :96-120."""

    nq, nu, nw, nc = 7, 3, 3, 1

    def __init__(self, mb=3.0, ml=0.3, Jb=0.75, Jl=0.075,
                 mu_world=1.5, mu_joint=0.0, g=9.81):
        self.mb = mb
        self.ml = ml
        self.Jb = Jb
        self.Jl = Jl
        self.mu_world = mu_world
        self.mu_joint = mu_joint
        self.g = g
        self.joint_friction = tuple([0.0] * 7)

    def _inertia(self, like):
        return self.const("inertia", [self.mb + self.ml] * 3
                          + [self.Jb + self.Jl] * 3 + [self.ml], like)

    def kinematics(self, q):
        """Foot position (hopper_3D/model.jl:32-37)."""
        rot = mrp_rotation_matrix(q[3:6])
        z = torch.zeros_like(q[6])
        return (q[:3] + rot @ torch.stack([z, z, -q[6]]))[None, :]

    def lagrangian(self, q, v):
        return (0.5 * torch.dot(v, self._inertia(q) * v)
                - (self.mb + self.ml) * self.g * q[2])

    def mass_matrix(self, q):
        """hopper_3D/model.jl:40-44."""
        return torch.diag(self._inertia(q))

    def bias(self, q, v):
        """hopper_3D/model.jl:46-48."""
        return self.const("bias", [0.0, 0.0, (self.mb + self.ml) * self.g]
                          + [0.0] * 4, q)

    def control_jacobian(self, q):
        """hopper_3D/model.jl:55-61 — torques in the body frame, leg
        force."""
        rot = mrp_rotation_matrix(q[3:6])
        z3 = torch.zeros_like(q[:3])
        z1, o1 = torch.zeros_like(q[:1]), torch.ones_like(q[:1])
        return torch.stack([torch.cat([z3, rot[:, 0], z1]),
                            torch.cat([z3, rot[:, 1], z1]),
                            torch.cat([rot[:, 2], z3, o1])])

    def disturbance_jacobian(self, q):
        return self.const("disturbance_jacobian", np.eye(3, 7), q)

    def contact_jacobian(self, q):
        """hopper_3D/model.jl:71-74 — autodiff of the foot's position."""
        return jacfwd(lambda qq: self.kinematics(qq).reshape(-1))(q)


hopper_3d = Hopper3D()
