"""Carry state across from the JAX package ``contactimplicitmpc_tpu``.

The robots have no learned weights: their "parameters" are the reference
gait, the linearization data, the objective weights and the options. These
functions turn the JAX package's objects into the port's. Arrays arrive as
anything ``numpy.asarray`` takes (the caller converts JAX arrays on its
side), options as objects whose attributes are plain Python values; this
module never imports JAX. The tensors are made on ``device``, by default
the GPU (``device.default_device``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .control.linearized import LinearizedData
from .control.newton import NewtonOptions
from .control.objective import TrackingObjective, TrackingVelocityObjective
from .control.policy import CIMPCOptions
from .control.trajectory import ContactTraj
from .device import resolve_device
from .hotpath import HotPathConfig
from .sim.interior_point import IPOptions


def tensors(cls, src, dtype=torch.float64, device=None):
    """A NamedTuple of tensors ``cls`` from ``src``'s same-named fields."""
    device = resolve_device(device)
    return cls(**{k: torch.tensor(np.asarray(getattr(src, k)),
                                     dtype=dtype, device=device)
                  for k in cls._fields})


def options(cls, src):
    """A dataclass ``cls`` from ``src``'s same-named attributes; fields
    that ``src`` lacks keep the port's defaults, and attributes the port
    has no field for are dropped."""
    names = [f.name for f in dataclasses.fields(cls)]
    return cls(**{k: getattr(src, k) for k in names if hasattr(src, k)})


def contact_traj(src, dtype=torch.float64, device=None) -> ContactTraj:
    return tensors(ContactTraj, src, dtype, device)


def linearized_data(src, dtype=torch.float64, device=None) -> LinearizedData:
    return tensors(LinearizedData, src, dtype, device)


def tracking_objective(src, dtype=torch.float64,
                       device=None) -> TrackingObjective:
    return tensors(TrackingObjective, src, dtype, device)


def tracking_velocity_objective(src, dtype=torch.float64,
                                device=None) -> TrackingVelocityObjective:
    return tensors(TrackingVelocityObjective, src, dtype, device)


def objective(src, dtype=torch.float64, device=None):
    """The port's objective of ``src``'s kind (with or without the
    velocity terms)."""
    cls = (TrackingVelocityObjective if hasattr(src, "v_target")
           else TrackingObjective)
    return tensors(cls, src, dtype, device)


def ip_options(src) -> IPOptions:
    return options(IPOptions, src)


def newton_options(src) -> NewtonOptions:
    return options(NewtonOptions, src)


def cimpc_options(src) -> CIMPCOptions:
    return options(CIMPCOptions, src)


def hotpath_config(src) -> HotPathConfig:
    return options(HotPathConfig, src)
