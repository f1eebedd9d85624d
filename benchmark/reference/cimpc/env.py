"""Terrain environments: surface height fields, contact-frame rotations,
friction-cone metadata.

PyTorch counterpart of ``contactimplicitmpc_tpu/env.py``: every terrain of
its ``ENVIRONMENTS`` registry, under the same names. Surface functions take
horizontal coordinates with any leading batch shape ``(..., ne-1)`` and
return heights ``(...)``; a gradient not given is taken by ``torch.func``
(as the JAX package takes it by ``jax.grad``). Terrains whose declared
gradient differs from the derivative (the hard stairs report slope 0) or
is written out (the piecewise slopes) give it explicitly. Branches are
``torch.where`` chains with the JAX package's strict ``<`` boundaries.
The nonlinear-cone terrains (``*_nc``) select the second-order friction
cone in ``sim/residual.py`` and ``sim/interior_point.py``; the MPC's
linearized knot path has no branch for it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

LINEARIZED_CONE = "linearized"
NONLINEAR_CONE = "nonlinear"


_CONSTS = {}   # (name, dtype, device): the terrains' constant tensors


def _const(name, value, dtype, device=None) -> torch.Tensor:
    """A terrain constant as a tensor, made once per (name, dtype, device)
    and outside any ``torch.func`` transform (``Model.const``'s rule), so
    that a sim step copies nothing from the host."""
    device = torch.device(device or "cpu")
    key = (name, dtype, device)
    t = _CONSTS.get(key)
    if t is None:
        with torch._C._DisableFuncTorch():
            t = _CONSTS[key] = torch.tensor(
                np.array(value, dtype=np.float64), dtype=dtype).to(device)
    return t


@dataclasses.dataclass(frozen=True, eq=False)
class Environment:
    """Terrain + friction-cone description (environment.jl:12-23).

    ``surf`` maps horizontal coordinates ``(..., ne-1)`` to heights
    ``(...)``; ``surf_grad`` maps them to gradients ``(..., ne-1)``.
    """

    dim: int  # world dimension: 2 or 3
    surf: Callable
    surf_grad: Callable
    cone: str = LINEARIZED_CONE

    @property
    def friction_dim(self) -> int:
        """environment.jl:126-130."""
        if self.cone == LINEARIZED_CONE:
            return 2 if self.dim == 2 else 4
        return 1 if self.dim == 2 else 2

    def friction_mapping(self, dtype, device=None) -> torch.Tensor:
        """environment.jl:105-121; made once per (dtype, device)."""
        if self.cone == LINEARIZED_CONE:
            value = ([[1.0, -1.0]] if self.dim == 2 else
                     [[1.0, 0.0, -1.0, 0.0], [0.0, 1.0, 0.0, -1.0]])
        else:
            value = np.eye(self.dim - 1)
        return _const(("friction_mapping", self.dim, self.cone), value, dtype,
                      device)

    def rotation(self, x: torch.Tensor) -> torch.Tensor:
        """World→surface rotation at horizontal positions ``x`` (..., ne-1),
        shape (..., ne, ne) (2D: environment.jl:79-92; 3D:
        environment.jl:59-77, Rodrigues)."""
        if self.dim == 3:
            return _rotation_3d(self.surf_grad(x))
        sg = self.surf_grad(x)[..., 0]
        n = torch.stack([-sg, torch.ones_like(sg)], dim=-1)
        ns = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
        # ang = atan2(1, 0) - atan2(ns2, ns1)
        ang = 0.5 * math.pi - torch.atan2(ns[..., 1], ns[..., 0])
        c, s = torch.cos(ang), torch.sin(ang)
        return torch.stack([torch.stack([c, -s], dim=-1),
                            torch.stack([s, c], dim=-1)], dim=-2)


def _rotation_3d(sg: torch.Tensor) -> torch.Tensor:
    """The rotation taking the surface normal n = (−∇s, 1)/|·| to the z
    axis, from the gradients ``sg`` (..., 2): I + [v]ₓ + [v]ₓ² / (1 + c)
    with v = n × e_z and c = n · e_z."""
    n = torch.cat([-sg, torch.ones_like(sg[..., :1])], dim=-1)
    a = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    ax, ay, c = a.unbind(-1)
    o = torch.zeros_like(c)
    # v = a × (0, 0, 1) = (a_y, −a_x, 0)
    sk = torch.stack([torch.stack([o, o, -ax], dim=-1),
                      torch.stack([o, o, -ay], dim=-1),
                      torch.stack([ax, ay, o], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=sg.dtype, device=sg.device)
    return eye + sk + (sk @ sk) / (1.0 + c)[..., None, None]


def _autograd_surface(surf: Callable, nxy: int) -> Callable:
    """Gradient of a surface function by ``torch.func.grad`` over each
    horizontal position (environment.jl:25-51 derives it symbolically)."""
    one = torch.func.vmap(torch.func.grad(surf))

    def g(x):
        return one(x.reshape(-1, nxy)).reshape(x.shape)

    return g


def environment_2d(surf: Callable, surf_grad: Optional[Callable] = None,
                   cone: str = LINEARIZED_CONE) -> Environment:
    """environment.jl:25-37; the gradient by autodiff where not given."""
    return Environment(2, surf, surf_grad or _autograd_surface(surf, 1), cone)


def environment_3d(surf: Callable, surf_grad: Optional[Callable] = None,
                   cone: str = LINEARIZED_CONE) -> Environment:
    """environment.jl:39-51; the gradient by autodiff where not given."""
    return Environment(3, surf, surf_grad or _autograd_surface(surf, 2), cone)


def environment_2d_flat(cone: str = LINEARIZED_CONE) -> Environment:
    """environment.jl:17-19."""
    return Environment(2, lambda x: torch.zeros_like(x[..., 0]),
                       lambda x: torch.zeros_like(x), cone)


def environment_3d_flat(cone: str = LINEARIZED_CONE) -> Environment:
    """environment.jl:21-23."""
    return Environment(3, lambda x: torch.zeros_like(x[..., 0]),
                       lambda x: torch.zeros_like(x), cone)


# ---------------------------------------------------------------------------
# Terrain instances (src/simulation/environments/)
# ---------------------------------------------------------------------------

flat_2d_lc = environment_2d_flat()
flat_3d_lc = environment_3d_flat()
flat_2d_nc = environment_2d_flat(cone=NONLINEAR_CONE)
flat_3d_nc = environment_3d_flat(cone=NONLINEAR_CONE)

# slope.jl
_T_SS = 25.0
_M_SS10 = math.tan(math.radians(10.0))
_X_OFF = 0.5


def _slope_smooth(x):
    """A 10-degree slope from x = 0.5, its kink smoothed by log1p(exp(·))
    (not ``softplus``, whose threshold would change the value)."""
    return _M_SS10 / _T_SS * torch.log1p(torch.exp(_T_SS * (x[..., 0] - _X_OFF)))


slope_smooth_2d_lc = environment_2d(_slope_smooth)
# height 0.5 x
slope1_2d_lc = Environment(2, lambda x: 0.5 * x[..., 0],
                           lambda x: torch.full_like(x, 0.5))

# sinusoidal.jl
sine1_3d_lc = environment_3d(
    lambda x: torch.sin(x[..., 0]) + torch.sin(x[..., 1]))
sine2_3d_lc = environment_3d(
    lambda x: 0.075 * torch.sin(2 * math.pi * x[..., 0]))
sine3_3d_lc = environment_3d(
    lambda x: 0.075 * torch.sin(2 * math.pi * x[..., 0])
    * torch.sin(2 * math.pi * x[..., 1]))

sine1_2d_lc = environment_2d(
    lambda x: 0.05 * (torch.cos(math.pi * x[..., 0]) - 1.0))
sine2_2d_lc = environment_2d(
    lambda x: 0.10 * torch.sin(2 * math.pi * x[..., 0]))
sine3_2d_lc = environment_2d(
    lambda x: 0.03 * (torch.cos(math.pi * x[..., 0]) - 1.0))


# quadratic.jl
def _quadratic_bowl(x):
    return torch.sum(torch.square(x), dim=-1)


quadratic_bowl_3d_lc = environment_3d(_quadratic_bowl)
quadratic_bowl_3d_nc = environment_3d(_quadratic_bowl, cone=NONLINEAR_CONE)


def _circular_bowl(x):
    return -torch.sqrt(2.5 ** 2 - x[..., 0] ** 2 - x[..., 1] ** 2) + 2.5


circular_bowl_3d_nc = environment_3d(_circular_bowl, cone=NONLINEAR_CONE)


def _steps(x, edges, heights):
    """``heights[i]`` on ``x < edges[i]`` (the first edge that holds),
    ``heights[-1]`` past the last edge: the JAX package's nested
    ``jnp.where`` chain, innermost branch first."""
    out = heights[-1]
    for edge, h in zip(reversed(edges), reversed(heights[:-1])):
        out = torch.where(x < edge, h, out)
    return out


# stairs.jl:1-46 — hard 4-step staircase with declared slope 0.
def _stairs3(x):
    x = x[..., 0]
    z = torch.zeros_like(x)
    return _steps(x, (0.125, 0.375, 0.625, 0.875),
                  (z, z + 0.25, z + 0.5, z + 0.75, z))


stairs3_2d_lc = Environment(2, _stairs3, lambda x: torch.zeros_like(x))


def smoothed_stairs(x):
    """stairs.jl:27-46 — softmax-kernel smoothed staircase."""
    x = x[..., 0]
    c = _const("stairs_c", [0.0, 0.5, 1.0, 1.5, 2.0], x.dtype, x.device)
    a = _const("stairs_a", [0.0, 0.25, 0.5, 0.75, 0.0], x.dtype, x.device)
    r, s = 0.25, 3.0
    v = s * (1.0 - torch.square((x[..., None] - c) / r))
    w = torch.softmax(v, dim=-1)
    return w @ a


smoothed_stairs_2d_lc = environment_2d(smoothed_stairs)


# piecewise.jl — 10-degree slope-up-then-down with cubic-smoothed kinks.
def _cubic_fit(x1, y1, m1, x2, y2, m2):
    """The cubic's coefficients (x³, x², x, 1) through (x1, y1) and
    (x2, y2) with slopes m1 and m2."""
    amat = np.array([[x1 ** 3, x1 ** 2, x1, 1.0],
                     [x2 ** 3, x2 ** 2, x2, 1.0],
                     [3 * x1 ** 2, 2 * x1, 1.0, 0.0],
                     [3 * x2 ** 2, 2 * x2, 1.0, 0.0]])
    return [float(c) for c in np.linalg.solve(amat, np.array([y1, y2, m1, m2]))]


def _make_piecewise(m_ss: float):
    """(surf, grad): flat to 0.4, a cubic to 0.6, slope m_ss to 1.9, a
    cubic to 2.1, then slope −m_ss / 4; the gradient written out."""
    a1 = _cubic_fit(0.4, 0.0, 0.0, 0.6, m_ss * 0.1, m_ss)
    a2 = _cubic_fit(1.4, m_ss * 1.4, m_ss, 1.6, m_ss * 1.5 - 0.25 * m_ss * 0.1,
                    -0.25 * m_ss)
    edges = (0.4, 0.6, 1.9, 2.1)

    def poly(a, z):
        return a[3] + a[2] * z + a[1] * z ** 2 + a[0] * z ** 3

    def d_poly(a, z):
        return a[2] + 2 * a[1] * z + 3 * a[0] * z ** 2

    def surf(x):
        x = x[..., 0]
        return _steps(x, edges, (torch.zeros_like(x), poly(a1, x),
                                 m_ss * x - 0.5 * m_ss, poly(a2, x - 0.5),
                                 -0.25 * m_ss * (x - 2.0) + 1.5 * m_ss))

    def grad(x):
        x0 = x[..., 0]
        z = torch.zeros_like(x0)
        return _steps(x0, edges, (z, d_poly(a1, x0), z + m_ss,
                                  d_poly(a2, x0 - 0.5),
                                  z - 0.25 * m_ss))[..., None]

    return surf, grad


piecewise1_2d_lc = Environment(2, *_make_piecewise(math.tan(math.radians(10.0))))
piecewise2_2d_lc = Environment(2, *_make_piecewise(math.tan(math.radians(-10.0))))


ENVIRONMENTS = {
    "flat_2D_lc": flat_2d_lc,
    "flat_3D_lc": flat_3d_lc,
    "flat_2D_nc": flat_2d_nc,
    "flat_3D_nc": flat_3d_nc,
    "slope_smooth_2D_lc": slope_smooth_2d_lc,
    "slope1_2D_lc": slope1_2d_lc,
    "sine1_2D_lc": sine1_2d_lc,
    "sine2_2D_lc": sine2_2d_lc,
    "sine3_2D_lc": sine3_2d_lc,
    "sine1_3D_lc": sine1_3d_lc,
    "sine2_3D_lc": sine2_3d_lc,
    "sine3_3D_lc": sine3_3d_lc,
    "quadratic_bowl_3D_lc": quadratic_bowl_3d_lc,
    "quadratic_bowl_3D_nc": quadratic_bowl_3d_nc,
    "circular_bowl_3D_nc": circular_bowl_3d_nc,
    "stairs3_2D_lc": stairs3_2d_lc,
    "smoothed_stairs_2D_lc": smoothed_stairs_2d_lc,
    "piecewise1_2D_lc": piecewise1_2d_lc,
    "piecewise2_2D_lc": piecewise2_2d_lc,
}
