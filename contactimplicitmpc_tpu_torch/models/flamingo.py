"""Flamingo: planar 9-DoF biped with feet (toe and heel contacts).

PyTorch counterpart of ``contactimplicitmpc_tpu/models/flamingo.py`` (the
reference's ``flamingo/model.jl``).

Configuration (model.jl:455-460)::

    q = [x, z, θ_torso, θ_thigh1, θ_calf1, θ_thigh2, θ_calf2,
         θ_foot1, θ_foot2]

The torso points up (kinematics_1 torso branch negates the sine terms,
model.jl:61-93); contacts are [toe1, heel1, toe2, heel2]. Every body and
contact point is the hip (x, z) plus Σⱼ arm[j] · (sin θⱼ, −cos θⱼ) over the
seven absolute angles θ = q[2:], as in the quadruped: the point Jacobians,
the mass matrix, the contact Jacobian and the bias are written out in
closed form (the JAX package takes them from ``jax.jacfwd`` and the
Lagrangian; the tests hold each to the ``torch.func`` derivatives of
``lagrangian``). Positions keep their chained evaluation order, so that ϕ
and the points round as before.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from .base import Model

# rotational DoF of each body in q order: torso=2, thigh1=3, calf1=4,
# foot1=7, thigh2=5, calf2=6, foot2=8
_ROT_IDX = [2, 3, 4, 7, 5, 6, 8]

# rows of the lever-arm matrix: the 7 bodies, then the 4 contacts
_COMS = slice(0, 7)
_FEET = slice(7, 11)


class Flamingo(Model):
    """model.jl:1-58 (fields), :459-500 (nominal instance)."""

    nq, nu, nw, nc = 9, 6, 2, 4

    def __init__(self, g=9.81, mu_world=0.9, mu_joint=0.0):
        self.g = g
        self.mu_world = mu_world
        self.mu_joint = mu_joint

        self.m_torso, self.m_thigh = 12.0, 0.4598
        self.m_calf, self.m_foot = 0.306, 0.3466
        self.l_torso, self.l_thigh = 0.385, 0.42
        self.l_calf, self.l_foot = 0.45, 0.1725
        self.d_torso, self.d_thigh = 0.20, 0.21
        self.d_calf, self.d_foot = 0.225, 0.0525
        self.j_torso, self.j_thigh = 0.10, 0.01256
        self.j_calf, self.j_foot = 0.00952, 0.0015

        self.joint_friction = tuple([0.0] * 9)
        self._masses = [self.m_torso, self.m_thigh, self.m_calf, self.m_foot,
                        self.m_thigh, self.m_calf, self.m_foot]
        self._inertias = [self.j_torso, self.j_thigh, self.j_calf,
                          self.j_foot, self.j_thigh, self.j_calf, self.j_foot]
        diag = np.zeros(9)
        for j, idx in zip(self._inertias, _ROT_IDX):
            diag[idx] += j
        self._rot_diag = diag
        b = np.zeros((6, 9))
        pairs = [(2, 3), (3, 4), (2, 5), (5, 6), (4, 7), (6, 8)]
        for row, (parent, child) in enumerate(pairs):
            b[row, parent] = -1.0
            b[row, child] = 1.0
        self._b = b
        self._arms = self._lever_arms()

    def _lever_arms(self):
        """(7 bodies + 4 contacts, 7 angles) lever arms over θ = q[2:]
        (torso, thigh1, calf1, thigh2, calf2, foot1, foot2): the torso
        points up (arm −d_torso); toe and heel hang from the ankle with
        +l_foot and −d_foot; the foot's centre of mass sits at
        ½(l_foot − d_foot)."""
        cb = 0.5 * (self.l_foot - self.d_foot)
        arms = np.zeros((11, 7))
        arms[0, 0] = -self.d_torso
        for leg, (th, ca, ft) in enumerate(((1, 2, 5), (3, 4, 6))):
            body = 1 + 3 * leg
            arms[body, th] = self.d_thigh
            arms[body + 1, [th, ca]] = self.l_thigh, self.d_calf
            arms[body + 2, [th, ca, ft]] = self.l_thigh, self.l_calf, cb
            for toe, arm in enumerate((self.l_foot, -self.d_foot)):
                arms[7 + 2 * leg + toe, [th, ca, ft]] = (self.l_thigh,
                                                         self.l_calf, arm)
        return arms

    def _point_jacobians(self, q, rows):
        """Closed-form ∂(point)/∂q of the lever-arm rows ``rows``,
        (n, 2, nq): the identity in (x, z), arm[j] · (cos θⱼ, sin θⱼ) in
        column 2 + j. Each entry of ``jacfwd`` of the chained positions is
        that one product or an exact zero, so the two agree bit for bit."""
        arms = self.const(("arms", rows.start), self._arms[rows], q)
        eye = self.const(("eye2", rows.start), lambda: np.broadcast_to(
            np.eye(2), (arms.shape[0], 2, 2)), q)
        dd = torch.stack([torch.cos(q[2:]), torch.sin(q[2:])], dim=0)
        return torch.cat([eye, arms[:, None, :] * dd[None]], dim=-1)

    @staticmethod
    def _down(p, r, theta):
        return p + r * torch.stack([torch.sin(theta), -torch.cos(theta)])

    def _ankles(self, q):
        hip = q[:2]
        a1 = self._down(self._down(hip, self.l_thigh, q[3]), self.l_calf, q[4])
        a2 = self._down(self._down(hip, self.l_thigh, q[5]), self.l_calf, q[6])
        return a1, a2

    def _com_positions(self, q):
        """Bodies: torso, thigh1, calf1, foot1, thigh2, calf2, foot2."""
        hip = q[:2]
        torso = hip + self.d_torso * torch.stack([-torch.sin(q[2]),
                                                  torch.cos(q[2])])
        cb = 0.5 * (self.l_foot - self.d_foot)
        coms = [torso]
        for i_th, i_ca, i_ft in ((3, 4, 7), (5, 6, 8)):
            thigh = self._down(hip, self.d_thigh, q[i_th])
            knee = self._down(hip, self.l_thigh, q[i_th])
            calf = self._down(knee, self.d_calf, q[i_ca])
            ankle = self._down(knee, self.l_calf, q[i_ca])
            foot = self._down(ankle, cb, q[i_ft])
            coms.extend([thigh, calf, foot])
        return torch.stack(coms)  # (7, 2)

    def kinematics(self, q):
        """[toe1, heel1, toe2, heel2] positions (model.jl:342-349)."""
        a1, a2 = self._ankles(q)
        return torch.stack([self._down(a1, self.l_foot, q[7]),
                            self._down(a1, -self.d_foot, q[7]),
                            self._down(a2, self.l_foot, q[8]),
                            self._down(a2, -self.d_foot, q[8])])

    def lagrangian(self, q, v):
        """model.jl:259-328."""
        masses = self.const("masses", self._masses, q)
        inertias = self.const("inertias", self._inertias, q)
        vel = jacfwd(self._com_positions)(q) @ v
        ke = 0.5 * torch.sum(masses * torch.sum(vel * vel, dim=1))
        ke = ke + 0.5 * torch.sum(inertias * v[_ROT_IDX] ** 2)
        pe = self.g * torch.sum(masses * self._com_positions(q)[:, 1])
        return ke - pe

    def mass_matrix(self, q):
        """model.jl:352-389: Σ mᵢ JᵢᵀJᵢ + rotational inertias."""
        masses = self.const("masses", self._masses, q)
        jac = self._point_jacobians(q, _COMS)    # (7, 2, nq)
        m = torch.einsum("b,bin,bim->nm", masses, jac, jac)
        return m + torch.diag(self.const("rot_diag", self._rot_diag, q))

    def bias(self, q, v):
        """C(q, v) = ∂²L/∂v∂q · v − ∂L/∂q in closed form, as the
        quadruped's: Σ mᵢ Jᵢᵀ(J̇ᵢv) + g Σ mᵢ ∂yᵢ/∂q with
        J̇ᵢv = (arms · θ̇²) @ (−sin θ, cos θ) (the rotational inertias are
        constant and add nothing)."""
        masses = self.const("masses", self._masses, q)
        arms = self.const(("arms", _COMS.start), self._arms[_COMS], q)
        jac = self._point_jacobians(q, _COMS)    # (7, 2, nq)
        dd2 = torch.stack([-torch.sin(q[2:]), torch.cos(q[2:])], dim=-1)
        jdot_v = (arms * v[2:] ** 2) @ dd2        # (7, 2)
        return (torch.einsum("b,bin,bi->n", masses, jac, jdot_v)
                + self.g * (masses @ jac[:, 1, :]))

    def control_jacobian(self, q):
        """model.jl:404-411 — relative torques: hips, knees, ankles."""
        return self.const("control_jacobian", self._b, q)

    def disturbance_jacobian(self, q):
        """model.jl:413-416."""
        return self.const("disturbance_jacobian", np.eye(2, 9), q)

    def contact_jacobian(self, q):
        """model.jl:418-429 — stacked toe/heel Jacobians (8, 9)."""
        return self._point_jacobians(q, _FEET).reshape(2 * self.nc, self.nq)


flamingo = Flamingo()
