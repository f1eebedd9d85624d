"""Where the reference puts a tensor when the caller does not say: the CPU."""

import torch


def resolve_device(device=None) -> torch.device:
    return torch.device("cpu" if device is None else device)
