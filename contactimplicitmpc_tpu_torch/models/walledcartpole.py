"""Walled cartpole: the pole's tip confined between two compliant walls.

PyTorch counterpart of ``contactimplicitmpc_tpu/models/walledcartpole.py``
(the reference's ``walledcartpole/model.jl``). q = (θ, x, xw1, xw2): pole
angle, cart position and the two wall deflections (spring-loaded with
stiffness k). Its own ϕ (the tip's gap to each deflected wall) and contact
Jacobian replace the height-field defaults. Mass matrix and bias are
written out (the JAX package takes them from the Lagrangian; the tests hold
them to its ``torch.func`` derivatives).
"""

from __future__ import annotations

import torch

from .base import Model

# the tip Jacobian's wall terms and the two walls' contact frames
_W1 = [[0.0, 0.0, -1.0, 0.0], [0.0, 0.0, 0.0, 0.0]]
_W2 = [[0.0, 0.0, 0.0, -1.0], [0.0, 0.0, 0.0, 0.0]]
_R1 = [[0.0, -1.0], [1.0, 0.0]]
_R2 = [[0.0, 1.0], [-1.0, 0.0]]


class WalledCartpole(Model):
    """walledcartpole/model.jl:16-38, :144-162."""

    nq, nu, nw, nc = 4, 1, 4, 2

    def __init__(self, mb=0.978, mt=0.411, mw=0.1, length=0.6, lc=0.4267,
                 w=0.35, k=50.0, mu_world=0.1, mu_joint=1.0, g=9.81):
        self.mb = mb
        self.mt = mt
        self.mw = mw
        self.l = length
        self.lc = lc
        self.w = w
        self.k = k
        self.mu_world = mu_world
        self.mu_joint = mu_joint
        self.g = g
        self.joint_friction = (0.0, mu_joint, 3.0 * mu_joint, 3.0 * mu_joint)

    def _tip(self, q):
        # a Python number with a 0-dim float32 tensor takes a float64
        # tangent under torch.func's forward mode: the sums and products
        # here have a one-element tensor on the other side
        ls = self.l * torch.cat([torch.cos(q[0:1]), torch.sin(q[0:1])])
        return torch.stack([q[1] - ls[1], ls[0]])

    def kinematics(self, q):
        k = self._tip(q)
        return torch.stack([k, k])

    def lagrangian(self, q, v):
        """walledcartpole/model.jl:75-99 (one-element slices: see ``_tip``)."""
        th = q[0:1]
        xw1, xw2 = q[2:3], q[3:4]
        om, xd, w1d, w2d = v[0:1], v[1:2], v[2:3], v[3:4]
        ke = (0.5 * (self.mt + self.mb) * xd ** 2
              - self.mt * xd * om * self.lc * torch.cos(th)
              + 0.5 * self.mt * self.lc ** 2 * om ** 2)
        ke = ke + 0.5 * self.mw * (w1d ** 2 + w2d ** 2)
        pe = self.mt * self.g * self.lc * torch.cos(th)
        pe = pe + self.k * (xw1 ** 2 + xw2 ** 2)
        return (ke - pe)[0]

    def mass_matrix(self, q):
        """M = [[mₜ l꜀², −mₜ l꜀ cos θ, 0, 0], [−mₜ l꜀ cos θ, mₜ + m_b, 0, 0],
        [0, 0, m_w, 0], [0, 0, 0, m_w]] (one-element slices: see ``_tip``)."""
        off = -self.mt * self.lc * torch.cos(q[0:1])
        z = torch.zeros_like(off)
        return torch.cat([
            torch.full_like(off, self.mt * self.lc ** 2), off, z, z,
            off, torch.full_like(off, self.mt + self.mb), z, z,
            z, z, torch.full_like(off, self.mw), z,
            z, z, z, torch.full_like(off, self.mw)]).reshape(4, 4)

    def bias(self, q, v):
        """C = (−mₜ g l꜀ sin θ, mₜ l꜀ sin θ · ω², 2k x_w1, 2k x_w2): the
        pole's centripetal term, gravity and the wall springs."""
        s = torch.sin(q[0:1])
        om = v[0:1]
        return torch.cat([-self.mt * self.g * self.lc * s,
                          self.mt * self.lc * s * om ** 2,
                          2.0 * self.k * q[2:4]])

    def phi(self, env, q):
        """Gap to each (deflected) wall (walledcartpole/model.jl:101-110)."""
        x_tip = self._tip(q)[0]
        return torch.stack([x_tip - q[2], q[3] - x_tip]) + self.w

    def contact_jacobian(self, q):
        """walledcartpole/model.jl:112-118."""
        ls = self.l * torch.cat([torch.cos(q[0:1]), torch.sin(q[0:1])])
        z = torch.zeros_like(ls[0])
        o = torch.ones_like(ls[0])
        jt = torch.stack([torch.stack([-ls[0], o, z, z]),
                          torch.stack([-ls[1], z, z, z])])
        return torch.cat([self.const("r1", _R1, q)
                          @ (jt + self.const("w1", _W1, q)),
                          self.const("r2", _R2, q)
                          @ (jt + self.const("w2", _W2, q))], dim=0)

    def control_jacobian(self, q):
        return self.const("control_jacobian", [[0.0, 1.0, 0.0, 0.0]], q)

    def disturbance_jacobian(self, q):
        return self.const("eye4", [[1.0 if i == j else 0.0 for j in range(4)]
                                   for i in range(4)], q)


walledcartpole = WalledCartpole()
