"""Terrain environments: surface height fields, contact-frame rotations,
friction-cone metadata.

PyTorch counterpart of ``contactimplicitmpc_tpu/env.py`` for the planar
flat ground (``flat_2d_lc``) and the planar 0.5-gradient slope
(``slope1_2d_lc``). Surface functions take horizontal coordinates with any
leading batch shape ``(..., ne-1)``. The other terrains and the 3D rotation
wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

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
        """World→surface rotation at horizontal positions ``x`` (..., 1),
        shape (..., 2, 2) (2D: environment.jl:79-92)."""
        if self.dim != 2:
            raise NotImplementedError("3D terrains are not ported yet")
        sg = self.surf_grad(x)[..., 0]
        n = torch.stack([-sg, torch.ones_like(sg)], dim=-1)
        ns = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
        # ang = atan2(1, 0) - atan2(ns2, ns1)
        ang = 0.5 * math.pi - torch.atan2(ns[..., 1], ns[..., 0])
        c, s = torch.cos(ang), torch.sin(ang)
        return torch.stack([torch.stack([c, -s], dim=-1),
                            torch.stack([s, c], dim=-1)], dim=-2)


def environment_2d_flat(cone: str = LINEARIZED_CONE) -> Environment:
    """environment.jl:17-19."""
    return Environment(2, lambda x: torch.zeros_like(x[..., 0]),
                       lambda x: torch.zeros_like(x), cone)


flat_2d_lc = environment_2d_flat()

# slope.jl: height 0.5 x
slope1_2d_lc = Environment(2, lambda x: 0.5 * x[..., 0],
                           lambda x: torch.full_like(x, 0.5))
