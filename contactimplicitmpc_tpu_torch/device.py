"""Where the port's entry points put their tensors when the caller does
not say: on the NVIDIA GPU, never silently on the CPU."""

from __future__ import annotations

import subprocess
import time

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


def describe(device) -> str:
    """What to print beside a measurement taken on ``device``: a card's
    name and power limit as ``nvidia-smi`` gives them, or ``"cpu"``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={index}"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, device):
    """``fn()`` and its wall seconds on the host clock, with the queue of
    ``device`` drained before and after (the examples' timing)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.time() - t0
