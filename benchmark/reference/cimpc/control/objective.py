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


class TrackingVelocityObjective(NamedTuple):
    """objective.jl:18-47: adds a finite-difference velocity penalty
    ``vᵀ diag(v_w) v`` with targets."""

    q: torch.Tensor
    v: torch.Tensor
    u: torch.Tensor
    gamma: torch.Tensor
    b: torch.Tensor
    v_target: torch.Tensor
    q_target: torch.Tensor


def _weights(horizon: int, dtype, device):
    """Weights given as (n,) or (horizon, n), zeros where left out."""
    def mk(x, n):
        if x is None:
            return torch.zeros((horizon, n), dtype=dtype, device=device)
        x = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        if x.ndim == 1:
            x = x[None, :].expand(horizon, n)
        return x
    return mk


def tracking_objective(dims: Dims, horizon: int, q=None, u=None, gamma=None,
                       b=None, dtype=torch.float64,
                       device=None) -> TrackingObjective:
    """Weights given as (n,) or (horizon, n), zeros where left out, on
    ``device``, by default the GPU (``device.default_device``)."""
    mk = _weights(horizon, dtype, resolve_device(device))
    return TrackingObjective(q=mk(q, dims.nq), u=mk(u, dims.nu),
                             gamma=mk(gamma, dims.nc), b=mk(b, dims.nb))


def tracking_velocity_objective(dims: Dims, horizon: int, q=None, v=None,
                                u=None, gamma=None, b=None, v_target=None,
                                dtype=torch.float64,
                                device=None) -> TrackingVelocityObjective:
    """As ``tracking_objective``, with velocity weights ``v`` and targets;
    ``q_target`` is the cumulative sum of ``v_target``
    (objective.jl:36-45)."""
    mk = _weights(horizon, dtype, resolve_device(device))
    vt = mk(v_target, dims.nq)
    qt = torch.cat([torch.zeros_like(vt[:1]),
                    torch.cumsum(vt[:-1], dim=0)], dim=0)
    return TrackingVelocityObjective(
        q=mk(q, dims.nq), v=mk(v, dims.nq), u=mk(u, dims.nu),
        gamma=mk(gamma, dims.nc), b=mk(b, dims.nb), v_target=vt, q_target=qt)
