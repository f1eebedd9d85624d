"""Tracking objectives for the horizon Newton solve.

PyTorch counterpart of ``contactimplicitmpc_tpu/control/objective.py``.
Weights are per-knot diagonal vectors stacked along the horizon.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..dims import Dims


class TrackingObjective(NamedTuple):
    """objective.jl:3-16. Diagonal weights, shape (H, n_*)."""

    q: torch.Tensor
    u: torch.Tensor
    gamma: torch.Tensor
    b: torch.Tensor


def tracking_objective(dims: Dims, horizon: int, q=None, u=None, gamma=None,
                       b=None, dtype=torch.float64,
                       device=None) -> TrackingObjective:
    """Weights given as (n,) or (horizon, n), zeros where left out, on
    ``device``, by default the GPU (``device.default_device``)."""
    device = resolve_device(device)

    def mk(x, n):
        if x is None:
            return torch.zeros((horizon, n), dtype=dtype, device=device)
        x = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        if x.ndim == 1:
            x = x[None, :].expand(horizon, n)
        return x

    return TrackingObjective(q=mk(q, dims.nq), u=mk(u, dims.nu),
                             gamma=mk(gamma, dims.nc), b=mk(b, dims.nb))
