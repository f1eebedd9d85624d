"""The device mesh of a Monte-Carlo sweep.

PyTorch counterpart of ``contactimplicitmpc_tpu/parallel/mesh.py``. The
JAX package lays a sweep over a 2D mesh of devices inside one program; the
port runs one process a device, so its mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, with the same axes:

* ``dp`` — Monte-Carlo rollouts (seeds / initial conditions), the primary
  axis;
* ``kn`` — a second batch axis for very large sweeps.

The horizon and knot dimensions stay inside a rank: the knot solves are
batched on its device and the Riccati sweep runs per lane.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import resolve_device
from .distributed import backend_for


def mesh_over_group(shape, axis_names: Sequence[str]):
    """A mesh of ``shape`` over the ranks of the running group, in rank
    order (the trailing axis fastest); its device type follows the group's
    backend."""
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "kn"), device=None):
    """A 2D mesh over the ranks of the process group, factoring their
    count as evenly as possible into (dp, kn). With no group running a
    group of one rank is started, held in memory (NCCL for a CUDA
    ``device``, gloo for the CPU; by default the GPU): a single process
    gets the (1, 1) mesh of the JAX package's single device and runs the
    same collectives as a multi-process sweep. ``n_devices`` must be the
    group's size when given: every rank is in the mesh."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(resolve_device(device)),
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the "
                         f"process group has {n} ranks (one a device)")
    kn = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            kn = cand
            break
    return mesh_over_group((n // kn, kn), axis_names)
