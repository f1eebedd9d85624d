"""Model protocol and the variational (midpoint Lagrangian) integrator.

PyTorch counterpart of ``contactimplicitmpc_tpu/models/base.py``. Model
methods act on ONE sample (``q`` of shape ``(nq,)``), are free of in-place
writes and host reads, and so compose with ``torch.func`` transforms: the
batch is a ``torch.func.vmap`` over them, and the autodiff defaults below
are ``torch.func`` derivatives of the Lagrangian (the models on the paths
write theirs out; the tests hold them to these defaults):

* ``mass_matrix``  default = ∂²L/∂v²
* ``bias``         default = ∂²L/∂v∂q · v − ∂L/∂q
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch
from torch.func import grad, hessian, jvp

from ..dims import Dims
from ..env import LINEARIZED_CONE

if TYPE_CHECKING:  # pragma: no cover
    from ..env import Environment


class Model:
    """Base robot model (``Model{T}`` protocol, model.jl:1-41).

    Subclasses set ``nq, nu, nw, nc``, ``mu_world``, ``joint_friction`` and
    implement ``lagrangian`` (or override ``mass_matrix``/``bias``),
    ``kinematics``, ``control_jacobian``, ``disturbance_jacobian`` and
    ``contact_jacobian``.
    """

    nq: int
    nu: int
    nw: int
    nc: int
    mu_world: float
    mu_joint: float = 0.0
    joint_friction: tuple = ()

    def const(self, name, value, like: torch.Tensor) -> torch.Tensor:
        """A model constant as a tensor of ``like``'s dtype and device,
        made once per (name, dtype, device) so that hot loops copy nothing
        from the host. ``value`` is array-like, or a function returning
        it, called only when the constant is first made."""
        cache = self.__dict__.setdefault("_consts", {})
        key = (name, like.dtype, like.device)
        t = cache.get(key)
        if t is None:
            value = value() if callable(value) else value
            # made outside any torch.func transform: a tensor made inside
            # one (a hessian's inner grad) is wrapped at its level, and the
            # cached copy would escape that level on the next call
            with torch._C._DisableFuncTorch():
                t = torch.tensor(np.array(value, dtype=np.float64),
                                 dtype=like.dtype).to(like.device)
            cache[key] = t
        return t

    # ---- Lagrangian mechanics -----------------------------------------
    def lagrangian(self, q, v):
        raise NotImplementedError

    def mass_matrix(self, q):
        """M(q). Default: Hessian of L in velocity."""
        v0 = torch.zeros_like(q)
        return hessian(lambda vv: self.lagrangian(q, vv))(v0)

    def bias(self, q, v):
        """C(q, v) = ∂²L/∂v∂q · v − ∂L/∂q. The product ∂²L/∂v∂q · v is
        the derivative of ∂L/∂v along v, one ``jvp`` instead of the nq
        columns of ``jacfwd``."""
        dlq = grad(self.lagrangian, argnums=0)(q, v)
        d2lvq_v = jvp(lambda qq: grad(self.lagrangian, argnums=1)(qq, v),
                      (q,), (v,))[1]
        return d2lvq_v - dlq

    # ---- input maps ----------------------------------------------------
    def control_jacobian(self, q):
        """B(q): (nu, nq); applied as Bᵀu."""
        raise NotImplementedError

    def disturbance_jacobian(self, q):
        """A(q): (nw, nq); applied as Aᵀw."""
        raise NotImplementedError

    def contact_jacobian(self, q):
        """J(q): (nc * ne, nq); applied as Jᵀλ."""
        raise NotImplementedError

    # ---- contact kinematics -------------------------------------------
    def kinematics(self, q):
        """Per-contact world positions, shape (nc, ne)."""
        raise NotImplementedError

    def phi(self, env: "Environment", q):
        """Signed distances, shape (nc,): height minus terrain."""
        k = self.kinematics(q)
        return k[:, -1] - env.surf(k[:, :-1])

    def joint_friction_vector(self, like):
        jf = self.joint_friction
        if len(jf) != self.nq:
            jf = [0.0] * self.nq
        return self.const("joint_friction", jf, like)

    def damping_force(self, h, vm2):
        """Velocity damping: −h · joint_friction ∘ v (model.jl:34)."""
        return -h * self.joint_friction_vector(vm2) * vm2

    # ---- contact maps --------------------------------------------------
    def contact_forces(self, env: "Environment", gamma1, b1, q2, k):
        return _default_contact_forces(self, env, gamma1, b1, q2, k)

    def velocity_stack(self, env: "Environment", q1, q2, k, h):
        return _default_velocity_stack(self, env, q1, q2, k, h)


def dims_of(model: Model, env: "Environment") -> Dims:
    return Dims(nq=model.nq, nu=model.nu, nw=model.nw, nc=model.nc,
                nf=env.friction_dim, ne=env.dim)


def lagrangian_derivatives(model: Model, q, v):
    """model.jl:12-16: D1L = -C(q, v), D2L = M(q) v."""
    d1 = -model.bias(q, v)
    d2 = model.mass_matrix(q) @ v
    return d1, d2


def dynamics(model: Model, h, q0, q1, u1, w1, lam1, q2):
    """Discrete Euler–Lagrange residual (model.jl:18-36). ``lam1`` is the
    generalized contact impulse Jᵀλ1; ``h`` is a 0-d tensor."""
    qm1 = 0.5 * (q0 + q1)
    vm1 = (q1 - q0) / h
    qm2 = 0.5 * (q1 + q2)
    vm2 = (q2 - q1) / h

    d1l1, d2l1 = lagrangian_derivatives(model, qm1, vm1)
    d1l2, d2l2 = lagrangian_derivatives(model, qm2, vm2)

    return (0.5 * h * d1l1 + d2l1 + 0.5 * h * d1l2 - d2l2
            + model.control_jacobian(qm2).T @ u1
            + model.disturbance_jacobian(qm2).T @ w1
            + lam1
            + model.damping_force(h, vm2))


# ---------------------------------------------------------------------------
# Contact-space helpers (src/simulation/contact_methods.jl)
# ---------------------------------------------------------------------------

def e_mapping(dims: Dims, dtype, device=None) -> torch.Tensor:
    """E: (nc, nb) block-ones duplication matrix (simulation.jl:127-131)."""
    return torch.kron(torch.eye(dims.nc, dtype=dtype, device=device),
                      torch.ones((1, dims.nf), dtype=dtype, device=device))


def contact_forces(model: Model, env: "Environment", gamma1, b1, q2, k):
    """World-frame contact forces, shape (nc * ne,)."""
    return model.contact_forces(env, gamma1, b1, q2, k)


def velocity_stack(model: Model, env: "Environment", q1, q2, k, h):
    """Tangential contact-velocity stack, shape (nb,)."""
    return model.velocity_stack(env, q1, q2, k, h)


def _default_contact_forces(model: Model, env: "Environment",
                            gamma1, b1, q2, k):
    """Rotate per-contact surface-frame forces into the world frame; the
    contacts are a leading axis of every operand."""
    rot = env.rotation(k[:, : env.dim - 1])                   # (nc, ne, ne)
    b_per = b1.reshape(model.nc, -1)
    if env.cone == LINEARIZED_CONE:
        fm = model.const(("friction_mapping", env.dim),
                         lambda: env.friction_mapping(torch.float64), q2)
        f_tan = b_per @ fm.T
    else:
        f_tan = b_per
    f_surf = torch.cat([f_tan, gamma1[:, None]], dim=-1)       # (nc, ne)
    return torch.einsum("cji,cj->ci", rot, f_surf).reshape(-1)


def _default_velocity_stack(model: Model, env: "Environment", q1, q2, k, h):
    """Surface-frame tangential velocities via the contact Jacobian."""
    v = (model.contact_jacobian(q2) @ (q2 - q1) / h).reshape(model.nc, env.dim)
    rot = env.rotation(k[:, : env.dim - 1])
    vt = torch.einsum("cij,cj->ci", rot, v)[:, : env.dim - 1]
    if env.cone == LINEARIZED_CONE:
        return torch.cat([vt, -vt], dim=-1).reshape(-1)
    return vt.reshape(-1)

