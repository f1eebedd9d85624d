"""Terrain environments: surface height fields, contact-frame rotations,
friction-cone metadata.

PyTorch counterpart of ``contactimplicitmpc_tpu/env.py`` for the planar
flat ground (``flat_2d_lc``), the planar 0.5-gradient slope
(``slope1_2d_lc``) and the 3D flat ground (``flat_3d_lc``), with the 3D
(Rodrigues) contact-frame rotation. Surface functions take horizontal
coordinates with any leading batch shape ``(..., ne-1)``. The other
terrains wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

LINEARIZED_CONE = "linearized"
NONLINEAR_CONE = "nonlinear"


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
        """environment.jl:105-121."""
        if self.cone == LINEARIZED_CONE:
            if self.dim == 2:
                return torch.tensor([[1.0, -1.0]], dtype=dtype, device=device)
            return torch.tensor([[1.0, 0.0, -1.0, 0.0], [0.0, 1.0, 0.0, -1.0]],
                                dtype=dtype, device=device)
        return torch.eye(self.dim - 1, dtype=dtype, device=device)

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


flat_2d_lc = environment_2d_flat()
flat_3d_lc = environment_3d_flat()

# slope.jl: height 0.5 x
slope1_2d_lc = Environment(2, lambda x: 0.5 * x[..., 0],
                           lambda x: torch.full_like(x, 0.5))
