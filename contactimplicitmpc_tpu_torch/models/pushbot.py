"""PushBot: inverted pendulum between two walls (push recovery).

PyTorch counterpart of ``contactimplicitmpc_tpu/models/pushbot.py`` (the
reference's ``pushbot/model.jl``). q = (θ, d) where d is the end-effector
slider along the pole; two contacts against walls at x = ±0.5. Its own ϕ
(wall gaps) and contact Jacobian (the slider Jacobian rotated so that each
wall's normal is the contact frame's last axis) replace the height-field
defaults. Mass matrix and bias are written out (the JAX package takes them
from the Lagrangian; the tests hold them to its ``torch.func``
derivatives).
"""

from __future__ import annotations

import torch

from .base import Model

# the wall normals: +x for the wall at x = -0.5, -x for the one at +0.5
_R1 = [[0.0, -1.0], [1.0, 0.0]]
_R2 = [[0.0, 1.0], [-1.0, 0.0]]


def _cos_sin(q):
    """cos θ and sin θ of q[0], taken from a one-element slice. Every sum or
    product of a Python number and a tensor here has a tensor of at least
    one dimension on the other side: under ``torch.func``'s forward mode a
    Python number with a 0-dim float32 tensor takes a float64 tangent,
    which breaks the Jacobians in float32."""
    cs = torch.cat([torch.cos(q[0:1]), torch.sin(q[0:1])])
    return cs[0], cs[1]


class PushBot(Model):
    """pushbot/model.jl:4-22, :119-138."""

    nq, nu, nw, nc = 2, 2, 2, 2

    def __init__(self, mb=1.0, ma=0.01, length=1.0, mu_world=0.5,
                 mu_joint=10.0, g=9.81):
        self.mb = mb
        self.ma = ma
        self.l = length
        self.mu_world = mu_world
        self.mu_joint = mu_joint
        self.g = g
        self.joint_friction = (mu_joint, mu_joint)

    def _kin_d(self, q):
        """The slider's end (pushbot/model.jl:26-40, :d mode)."""
        c, s = _cos_sin(q)
        ls = self.l * torch.stack([-s, c])
        return torch.stack([ls[0] + q[1] * c, ls[1] + q[1] * s])

    def _jac_d(self, q):
        c, s = _cos_sin(q)
        lc = self.l * torch.stack([c, s])
        d = q[1]
        return torch.stack([torch.stack([-lc[0] - d * s, c]),
                            torch.stack([-lc[1] + d * c, s])])

    def kinematics(self, q):
        k = self._kin_d(q)
        return torch.stack([k, k])

    def lagrangian(self, q, v):
        """pushbot/model.jl:66-78."""
        c, s = _cos_sin(q)
        lc = self.l * torch.stack([c, s])
        z = torch.zeros_like(c)
        jc = torch.stack([torch.stack([-lc[0], z]), torch.stack([-lc[1], z])])
        vth = (jc @ v)[:, None]
        vd = (self._jac_d(q) @ v)[:, None]
        lag = 0.5 * self.mb * torch.sum(vth * vth, dim=0)
        lag = lag - self.mb * self.g * lc[0:1]
        lag = lag + 0.5 * self.ma * torch.sum(vd * vd, dim=0)
        return (lag - self.ma * self.g * self._kin_d(q)[1:2])[0]

    def mass_matrix(self, q):
        """M = [[m_b l² + m_a (l² + d²), −m_a l], [−m_a l, m_a]]: the
        pole's point has |J_b v|² = l² θ̇², the slider's
        J_aᵀJ_a = [[l² + d², −l], [−l, 1]]."""
        d = q[1:2]
        m00 = (self.mb + self.ma) * self.l ** 2 + self.ma * d ** 2
        off = torch.full_like(d, -self.ma * self.l)
        return torch.cat([m00, off, off, torch.full_like(d, self.ma)]
                         ).reshape(2, 2)

    def bias(self, q, v):
        """Σ mᵢ Jᵢᵀ(J̇ᵢv) + g Σ mᵢ ∂yᵢ/∂q over the pole's point
        (J_bᵀJ̇_b v = 0) and the slider's end (J_aᵀJ̇_a v =
        (2 d ḋ θ̇, −d θ̇²)): C = (2 m_a d ḋ θ̇ − m_b g l s + m_a g (d c − l s),
        m_a (g s − d θ̇²))."""
        c, s = _cos_sin(q)
        d, om, dd = q[1:2], v[0:1], v[1:2]
        c, s = c[None], s[None]
        c0 = (2.0 * self.ma * d * dd * om - self.mb * self.g * self.l * s
              + self.ma * self.g * (d * c - self.l * s))
        c1 = self.ma * (self.g * s - d * om ** 2)
        return torch.cat([c0, c1])

    def phi(self, env, q):
        """Wall gaps at x = ±0.5 (pushbot/model.jl:88-92)."""
        x = self._kin_d(q)[0]
        return torch.stack([x, -x]) + 0.5

    def contact_jacobian(self, q):
        """pushbot/model.jl:100-106."""
        jd = self._jac_d(q)
        return torch.cat([self.const("r1", _R1, q) @ jd,
                          self.const("r2", _R2, q) @ jd], dim=0)

    def control_jacobian(self, q):
        """pushbot/model.jl:108-111."""
        return self.const("control_jacobian",
                          [[self.l, 1.0], [1.0, 1.0 / self.l]], q)

    def disturbance_jacobian(self, q):
        return self.const("eye2", [[1.0, 0.0], [0.0, 1.0]], q)


pushbot = PushBot()
