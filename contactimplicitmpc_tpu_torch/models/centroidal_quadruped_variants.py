"""Centroidal quadruped variants: box step-up and wall contacts.

PyTorch counterpart of
``contactimplicitmpc_tpu/models/centroidal_quadruped_variants.py``
(the reference's ``centroidal_quadruped_box/model.jl`` and
``centroidal_quadruped_wall/model.jl``, plus ``model_slanted.jl``, which
differs only in the wall position ``x_wall``).

Both share the centroidal quadruped's rigid-body + point-feet dynamics and
differ only in contact geometry:

* **Box** (box/model.jl:87-107): the terrain is a smooth tanh step ("box" of
  height 0.20 at x = 0.25) baked into ϕ; the contact frame stays
  world-aligned.
* **Wall** (wall/model.jl:87-101): 8 contacts — the 4 foot/ground pairs plus
  4 foot/wall pairs against a vertical wall at ``x = x_wall`` whose normal
  is −x; contact forces and tangential velocities follow
  wall/model.jl:146-174.
"""

from __future__ import annotations

import numpy as np
import torch

from .centroidal_quadruped import CentroidalQuadruped


class CentroidalQuadrupedBox(CentroidalQuadruped):
    """box/model.jl:11-32; instance at :204-230."""

    def __init__(self, h_step=0.20, x_step=0.25, **kw):
        super().__init__(**kw)
        self.h_step = h_step
        self.x_step = x_step

    def elevation(self, x):
        """Smooth tanh step (box/model.jl:102-107)."""
        return self.h_step * (1.0 + torch.tanh((x - self.x_step) * 200.0)) / 2.0

    def phi(self, env, q):
        """Foot height above the box surface (box/model.jl:87-100)."""
        feet = q[6:].reshape(4, 3)
        return feet[:, 2] - self.elevation(feet[:, 0])


class CentroidalQuadrupedWall(CentroidalQuadruped):
    """wall/model.jl:11-32; nominal instance at :210-235 (x_wall = 0.25);
    the 'slanted' file's instance uses x_wall = 1.0 (model_slanted.jl:94)."""

    nc = 8

    def __init__(self, x_wall=0.25, **kw):
        super().__init__(**kw)
        self.x_wall = x_wall

    def kinematics(self, q):
        """(8, 3): foot positions, repeated for the wall contact set."""
        feet = q[6:].reshape(4, 3)
        return torch.cat([feet, feet], dim=0)

    def phi(self, env, q):
        """Ground gaps then wall gaps (wall/model.jl:87-101)."""
        feet = q[6:].reshape(4, 3)
        return torch.cat([feet[:, 2], self.x_wall - feet[:, 0]])

    def contact_jacobian(self, q):
        """(24, 18): foot-velocity selector, twice (wall/model.jl:133-145)."""
        block = np.concatenate([np.zeros((12, 6)), np.eye(12)], 1)
        return self.const("contact_jacobian_wall",
                          np.concatenate([block, block], 0), q)

    def contact_forces(self, env, gamma1, b1, q2, k):
        """wall/model.jl:147-160: ground forces [m b; γ] (normal +z),
        wall forces [−γ; m b] (normal −x, tangentials y, z)."""
        fm = self.const(("friction_mapping", env.dim),
                        lambda: env.friction_mapping(torch.float64), q2)
        tan = b1.reshape(8, 4) @ fm.T                        # (8, 2)
        ground = torch.cat([tan[:4], gamma1[:4, None]], dim=-1)
        wall = torch.cat([-gamma1[4:, None], tan[4:]], dim=-1)
        return torch.cat([ground, wall], dim=0).reshape(-1)

    def velocity_stack(self, env, q1, q2, k, h):
        """wall/model.jl:162-174: ground tangentials (x, y), wall
        tangentials (y, z), each duplicated ±."""
        v = (q2[6:] - q1[6:]).reshape(4, 3) / h
        fm = self.const(("friction_mapping", env.dim),
                        lambda: env.friction_mapping(torch.float64), q2)
        return torch.cat([v[:, :2] @ fm, v[:, 1:] @ fm], dim=0).reshape(-1)


centroidal_quadruped_box = CentroidalQuadrupedBox()
centroidal_quadruped_wall = CentroidalQuadrupedWall(x_wall=0.25)
centroidal_quadruped_wall_slanted = CentroidalQuadrupedWall(x_wall=1.0)
