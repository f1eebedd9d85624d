"""Where the port's entry points put their tensors when the caller does
not say: on the NVIDIA GPU, never silently on the CPU."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``torch.device("cuda")``; raises where there is no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "contactimplicitmpc_tpu_torch runs on an NVIDIA GPU and found "
            "none (torch.cuda.is_available() is false); pass device=\"cpu\" "
            "to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, the default one for ``None``."""
    return default_device() if device is None else torch.device(device)
