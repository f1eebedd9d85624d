"""3D hopper with MRP orientation (hopper_3D/model.jl).

PyTorch counterpart of ``contactimplicitmpc_tpu/models/hopper_3d.py``.
q = (px, py, pz, mrp_x, mrp_y, mrp_z, r): body position, modified
Rodrigues parameters, leg length. Mass matrix and bias are the reference's
analytic ones; the contact Jacobian is written out (the JAX package takes it
by ``jax.jacfwd`` of the foot's position; the tests hold the two to each
other), since every derivative of the residual differentiates through it
again.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Model
from .rotations import (mrp_quaternion_map, mrp_rotation_matrix,
                        quaternion_rotation_matrix)


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
        """hopper_3D/model.jl:71-74 — ∂foot/∂q of foot = p − r c(m), with
        c = R(m) e3 the leg's axis, in closed form: I in p, −r ∂c/∂m in m
        (through the quaternion (w, x, y, z) of the MRP m), −c in r."""
        m, r = q[3:6], q[6:7]
        quat = mrp_quaternion_map(m)
        c = quaternion_rotation_matrix(quat)[:, 2]
        w, x, y, z = quat[0:1], quat[1:2], quat[2:3], quat[3:4]
        o = torch.zeros_like(w)
        # ∂c/∂(w, x, y, z) of c = (2(xz + wy), 2(yz − wx), 1 − 2(x² + y²))
        dc_dq = torch.stack([torch.cat([y, z, w, x]),
                             torch.cat([-x, -w, z, y]),
                             torch.cat([o, -2.0 * x, -2.0 * y, o])]) * 2.0
        # ∂(w, x, y, z)/∂m of w = (1 − |m|²)/(1 + |m|²), v = 2m/(1 + |m|²)
        den = 1.0 + torch.sum(m * m, dim=-1, keepdim=True)
        dw_dm = -4.0 * m / den ** 2
        dv_dm = (2.0 / den) * torch.eye(3, dtype=q.dtype, device=q.device) \
            - (4.0 / den ** 2) * m[:, None] * m[None, :]
        dq_dm = torch.cat([dw_dm[None], dv_dm], dim=0)
        return torch.cat([torch.eye(3, dtype=q.dtype, device=q.device),
                          -r * (dc_dq @ dq_dm), -c[:, None]], dim=1)


hopper_3d = Hopper3D()
