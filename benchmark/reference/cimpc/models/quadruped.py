"""Planar quadruped (~Unitree A1), 11-DoF, 4 contact feet.

PyTorch counterpart of ``contactimplicitmpc_tpu/models/quadruped.py``.
Every com and foot is one row of a constant lever-arm matrix over the
absolute angles, so positions, their Jacobians, the mass matrix and the
bias are small tensor expressions written out in closed form (the tests
hold them to the ``torch.func`` derivatives of ``lagrangian``).

Configuration::

    q = [x, z, θ_torso, θ_thigh1, θ_calf1, θ_thigh2, θ_calf2,
         θ_thigh3, θ_calf3, θ_thigh4, θ_calf4]

Legs 1/2 hang from the hip point (x, z); legs 3/4 hang from the torso tip.
All angles are absolute (world frame).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import Model

_COMS = slice(0, 9)
_FEET = slice(9, 13)


class Quadruped(Model):
    """model.jl:1-66 (fields), :555-569 (nominal instance)."""

    nq, nu, nw, nc = 11, 8, 2, 4

    def __init__(self, g=9.81, mu_world=1.0, mu_joint=0.1,
                 m_payload=0.0, j_payload=0.0):
        self.g = g
        self.mu_world = mu_world
        self.mu_joint = mu_joint

        # ~Unitree A1 parameters (model.jl:512-535)
        self.m_torso = 4.713 + 4 * 0.696 + m_payload
        self.m_thigh = 1.013
        self.m_calf = 0.166
        self.j_torso = 0.01683 + 4 * 0.696 * 0.183 ** 2 + j_payload
        self.j_thigh = 0.00552
        self.j_calf = 0.00299
        self.l_torso = 0.183 * 2
        self.l_thigh = 0.2
        self.l_calf = 0.2
        self.d_torso = 0.5 * self.l_torso + 0.0127
        self.d_thigh = 0.5 * self.l_thigh - 0.00323
        self.d_calf = 0.5 * self.l_calf - 0.006435

        self.joint_friction = tuple([0.0] * 3 + [mu_joint] * 8)
        self._masses = [self.m_torso] + [self.m_thigh, self.m_calf] * 4
        self._inertias = [self.j_torso] + [self.j_thigh, self.j_calf] * 4
        b = np.zeros((8, 11))
        pairs = [(2, 3), (3, 4), (2, 5), (5, 6), (2, 7), (7, 8), (2, 9),
                 (9, 10)]
        for row, (parent, child) in enumerate(pairs):
            b[row, parent] = -1.0
            b[row, child] = 1.0
        self._b = b
        self._arms = self._lever_arms()

    # ---- link kinematics (model.jl:75-270) ----------------------------
    def _lever_arms(self):
        """(9 bodies + 4 feet, 9 angles) lever arms: every point is
        (x, z) + Σⱼ arm[j] · (sin θⱼ, −cos θⱼ) over the absolute angles
        θ = q[2:]. Rows: torso, (thigh, calf) × 4 legs, feet 1-4."""
        arms = np.zeros((13, 9))
        arms[0, 0] = self.d_torso
        for leg in range(4):
            th, ca = 1 + 2 * leg, 2 + 2 * leg
            root = self.l_torso if leg >= 2 else 0.0  # legs 3/4: torso tip
            for row, (a_th, a_ca) in ((1 + 2 * leg, (self.d_thigh, 0.0)),
                                      (2 + 2 * leg, (self.l_thigh, self.d_calf)),
                                      (9 + leg, (self.l_thigh, self.l_calf))):
                arms[row, 0] = root
                arms[row, th] = a_th
                arms[row, ca] = a_ca
        return arms

    def _points(self, q, rows):
        """World positions of the lever-arm rows ``rows``, (n, 2)."""
        arms = self.const(("arms", rows.start), self._arms[rows], q)
        d = torch.stack([torch.sin(q[2:]), -torch.cos(q[2:])], dim=-1)
        return q[:2] + arms @ d

    def _point_jacobians(self, q, rows):
        """Closed-form ∂(point)/∂q of the lever-arm rows, (n, 2, nq): the
        identity in (x, z), arm[j] · (cos θⱼ, sin θⱼ) in column 2 + j.
        Written out rather than nested ``jacfwd`` because every derivative
        of the residual differentiates through it again (tests hold it to
        ``jacfwd`` of ``_points``)."""
        arms = self.const(("arms", rows.start), self._arms[rows], q)
        eye = self.const(("eye2", rows.start), lambda: np.broadcast_to(
            np.eye(2), (arms.shape[0], 2, 2)), q)
        dd = torch.stack([torch.cos(q[2:]), torch.sin(q[2:])], dim=0)
        return torch.cat([eye, arms[:, None, :] * dd[None]], dim=-1)

    def _com_positions(self, q):
        """Center-of-mass position of each of the 9 bodies, (9, 2)."""
        return self._points(q, _COMS)

    def kinematics(self, q):
        """Foot (calf end-effector) positions, (4, 2) (model.jl:410-417)."""
        return self._points(q, _FEET)

    # ---- mechanics -----------------------------------------------------
    def lagrangian(self, q, v):
        """model.jl:277-372."""
        masses = self.const("masses", self._masses, q)
        inertias = self.const("inertias", self._inertias, q)
        jac = self._point_jacobians(q, _COMS)    # (9, 2, nq)
        vel = jac @ v                             # (9, 2)
        ke = 0.5 * torch.sum(masses * torch.sum(vel * vel, dim=1))
        ke = ke + 0.5 * torch.sum(inertias * v[2:] ** 2)
        pe = self.g * torch.sum(masses * self._com_positions(q)[:, 1])
        return ke - pe

    def mass_matrix(self, q):
        """model.jl:421-463: Σ mᵢ JᵢᵀJᵢ + rotational inertias."""
        masses = self.const("masses", self._masses, q)
        inertias = self.const("inertias_q", [0.0, 0.0] + self._inertias, q)
        jac = self._point_jacobians(q, _COMS)    # (9, 2, nq)
        m = torch.einsum("b,bin,bim->nm", masses, jac, jac)
        return m + torch.diag(inertias)

    def bias(self, q, v):
        """C(q, v) = ∂²L/∂v∂q · v − ∂L/∂q in closed form: with
        L = ½ Σ mᵢ|Jᵢv|² + ½ Σ Iθ̇² − g Σ mᵢ yᵢ the centripetal terms of
        the two parts cancel, leaving Σ mᵢ Jᵢᵀ(J̇ᵢv) + g Σ mᵢ ∂yᵢ/∂q.
        Equal to the ``torch.func`` default of ``Model.bias``, which the
        tests hold it to."""
        masses = self.const("masses", self._masses, q)
        arms = self.const(("arms", _COMS.start), self._arms[_COMS], q)
        jac = self._point_jacobians(q, _COMS)    # (9, 2, nq)
        dd2 = torch.stack([-torch.sin(q[2:]), torch.cos(q[2:])], dim=-1)
        jdot_v = (arms * v[2:] ** 2) @ dd2        # (9, 2)
        return (torch.einsum("b,bin,bi->n", masses, jac, jdot_v)
                + self.g * (masses @ jac[:, 1, :]))

    def control_jacobian(self, q):
        """model.jl:489-498 — relative joint torques."""
        return self.const("control_jacobian", self._b, q)

    def disturbance_jacobian(self, q):
        """model.jl:500-503."""
        return self.const("disturbance_jacobian", np.eye(2, 11), q)

    def contact_jacobian(self, q):
        """Stacked foot Jacobians (8, 11)."""
        return self._point_jacobians(q, _FEET).reshape(2 * self.nc, self.nq)


def initial_configuration(model: Quadruped, theta0, theta1, theta2, theta3,
                          x, dz):
    """Kinematically-consistent standing pose from leg angles — the
    reference's Monte-Carlo initial-state distribution
    (``examples/quadruped/monte_carlo.jl:94-116``). Arguments are tensors
    of one shape ``(...)``; the result is ``(..., nq)``."""
    z = model.l_thigh * torch.cos(-theta1) + model.l_calf * torch.cos(theta2)
    calf_bd = torch.arccos(torch.clamp(
        (z - model.l_thigh * torch.cos(-theta3)) / model.l_calf, -1.0, 1.0))
    return torch.stack([
        x, z + dz, math.pi / 2.0 + theta0,
        -theta1, theta2,          # leg 1
        -theta3, calf_bd,         # leg 2
        -theta1, theta2,          # leg 3
        -theta3, calf_bd,         # leg 4
    ], dim=-1)


quadruped = Quadruped()
quadruped_payload = Quadruped(m_payload=3.0, j_payload=0.03)
