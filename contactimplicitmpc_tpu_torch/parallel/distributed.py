"""Multi-process sweeps: joining a ``torch.distributed`` process group, the
(dp, kn) mesh over it, and moving a rank's lanes to and from its device.

PyTorch counterpart of ``contactimplicitmpc_tpu/parallel/distributed.py``.
The JAX package runs one SPMD program over a multi-host device mesh; the
port runs one process a GPU, all of them this same program, joined by a
process group:

* ``initialize()`` joins the group from explicit arguments, from the
  ``CIMPC_COORDINATOR`` / ``CIMPC_NUM_PROCESSES`` / ``CIMPC_PROCESS_ID``
  variables the JAX package reads, or from the ``MASTER_ADDR`` /
  ``WORLD_SIZE`` / ``RANK`` variables ``torchrun`` sets. A plain single
  process (none of them) is left alone.
* Monte-Carlo lanes exchange only the sweep's scalar sums (one
  ``all_reduce`` a sweep, ``rollouts.py``), so the ``dp`` axis spans the
  processes; each process holds one device, so ``kn`` is 1.
* A batch laid out over the mesh is held, on each rank, as that rank's
  contiguous shard of the lanes: ``global_batch`` puts a rank's shard on
  its device, ``process_local_slice`` brings it back to the host.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def backend_for(device) -> str:
    """The process group's backend for lanes on ``device``: NCCL for a CUDA
    device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               device=None, backend: Optional[str] = None) -> bool:
    """Join the multi-process group; returns True if distributed.

    ``coordinator_address`` is ``host:port`` of rank 0 (``CIMPC_COORDINATOR``,
    else torchrun's ``MASTER_ADDR``/``MASTER_PORT``); ``num_processes`` and
    ``process_id`` default to ``CIMPC_NUM_PROCESSES``/``CIMPC_PROCESS_ID``,
    else ``WORLD_SIZE``/``RANK``. With none of them set this is a plain
    single process: nothing is done and False returned.

    The lanes live on ``device`` (by default the GPU, ``default_device``):
    a CUDA rank takes GPU ``local_device_ids[0]`` (default ``LOCAL_RANK``,
    else the process id modulo the GPUs). ``backend`` defaults to the
    device's (``backend_for``); gloo may be asked for on a GPU, where NCCL
    refuses two ranks on one card.
    """
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("CIMPC_COORDINATOR")
        if coordinator_address is None and "MASTER_ADDR" in env:
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num = env.get("CIMPC_NUM_PROCESSES", env.get("WORLD_SIZE"))
        num_processes = None if num is None else int(num)
    if process_id is None:
        pid = env.get("CIMPC_PROCESS_ID", env.get("RANK"))
        process_id = None if pid is None else int(pid)
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize: give the coordinator's address, the "
                         "number of processes and this process's id")

    device = resolve_device(device)
    if device.type == "cuda":
        if local_device_ids:
            index = int(local_device_ids[0])
        else:
            index = int(env.get("LOCAL_RANK",
                                process_id % torch.cuda.device_count()))
        torch.cuda.set_device(index)
    dist.init_process_group(backend or backend_for(device),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def make_global_mesh(axis_names: Sequence[str] = ("dp", "kn")):
    """The (processes, 1) mesh: ``dp`` spans the processes, ``kn`` each
    process's one device. Single process: ``make_mesh``'s (1, 1)."""
    from .mesh import mesh_over_group
    if not dist.is_initialized():
        from .mesh import make_mesh
        return make_mesh(1, axis_names)
    return mesh_over_group((dist.get_world_size(), 1), axis_names)


def global_batch(mesh, local_batch, device=None) -> torch.Tensor:
    """This rank's shard of a batch laid out over ``mesh`` (its lanes,
    e.g. seeds ``rank * n_local + i``), as a tensor on ``device`` (by
    default the GPU). The shards of all ranks together make the batch;
    no rank holds another's."""
    del mesh  # every rank holds its own shard; the mesh fixes their order
    return torch.as_tensor(np.asarray(local_batch),
                           device=resolve_device(device))


def process_local_slice(x) -> np.ndarray:
    """This rank's lanes of a laid-out batch (an output of the sharded
    sweeps) in host memory: the inverse of ``global_batch``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
