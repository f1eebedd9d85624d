"""Point-foot quadruped (120 Hz variant): centroidal body + four feet
with orientation damping and springs.

PyTorch counterpart of ``contactimplicitmpc_tpu/models/point_foot_quadruped.py``
(the reference's ``point_foot_quadruped/model.jl``, V1
parameter set: orientation friction 5, orientation spring 0.5, no joint
springs or friction). The model replaces the integrator's damping with
relative body↔foot damping + orientation friction (model.jl:230-241).
"""

from __future__ import annotations

import torch

from .centroidal_quadruped import CentroidalQuadruped


class PointFootQuadruped(CentroidalQuadruped):
    """point_foot_quadruped/model.jl:1-40, :244-294."""

    def __init__(self, body_height=0.3, foot_x=0.17, foot_y=0.15,
                 mass_body=13.5, mass_foot=0.2, mu_world=0.3, g=9.81,
                 joint_friction_gain=0.0, spring_stiffness_joint=0.0,
                 orientation_friction=5.0,
                 spring_stiffness_orientation=0.5):
        super().__init__(mass_body=mass_body, inertia_scaling=1.0,
                         mass_foot=mass_foot, mu_world=mu_world,
                         mu_joint=0.0, g=g, damped=False)
        self.body_height = body_height
        self.foot_x = foot_x
        self.foot_y = foot_y
        self.joint_friction_gain = joint_friction_gain
        self.spring_stiffness_joint = spring_stiffness_joint
        self.orientation_friction = orientation_friction
        self.spring_stiffness_orientation = spring_stiffness_orientation

    def _offsets(self, like):
        fx, fy, bh = self.foot_x, self.foot_y, self.body_height
        return self.const("foot_offsets", [[fx, fy, -bh], [fx, -fy, -bh],
                                           [-fx, fy, -bh], [-fx, -fy, -bh]],
                          like)

    def bias(self, q, v):
        """model.jl:82-100 — gravity, gyroscopic, joint/orientation
        springs."""
        ks = self.spring_stiffness_joint
        ko = self.spring_stiffness_orientation
        offsets = self._offsets(q)
        p, feet = q[:3], q[6:].reshape(4, 3)
        grav = self._gravity(q)
        body = grav[:3] + ks * (torch.sum(offsets, dim=0) + 4 * p
                                - torch.sum(feet, dim=0))
        orient = self._gyro(v) + ko * q[3:6]
        foot_rows = grav[6:9] + ks * (-offsets + feet - p)
        return torch.cat([body, orient, foot_rows.reshape(-1)])

    def damping_force(self, h, vm2):
        """model.jl:230-241 — orientation friction + relative body↔foot
        damping."""
        kj = self.joint_friction_gain
        ko = self.orientation_friction
        rel = vm2[:3] - vm2[6:].reshape(4, 3)                 # (4, 3)
        zero = torch.zeros_like(vm2[:3])
        return torch.cat([zero + -h * kj * torch.sum(rel, dim=0),
                          zero + -h * ko * vm2[3:6],
                          (zero + -h * kj * (-rel)).reshape(-1)])


point_foot_quadruped = PointFootQuadruped()
