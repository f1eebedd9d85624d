"""The program's own counters, read before and after a stretch of a run.

Each counter is a file ``counters/<name>.json`` whose ``read`` names a
module of the program and a path in it, ``"package.module:obj.attr"``: a
number is read as ``<name>``, a dict of numbers as ``<name>.<key>`` each
(the CUDA graphs' statistics). A later counter is a new file."""

from __future__ import annotations

import glob
import importlib
import os
import time
from contextlib import contextmanager

import torch
from torch.profiler import ProfilerActivity

from contactimplicitmpc_tpu_torch.utils import spans

from .spec import HERE, read_json


def _resolve(spec: str):
    module, _, path = spec.partition(":")
    obj = importlib.import_module(module)
    for key in path.split("."):
        obj = obj[key] if isinstance(obj, dict) else getattr(obj, key)
    return obj


def snapshot() -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "counters", "*.json"))):
        name = os.path.basename(path)[:-len(".json")]
        value = _resolve(read_json(path)["read"])
        if isinstance(value, dict):
            out.update({f"{name}.{k}": v for k, v in value.items()})
        else:
            out[name] = value
    return out


def difference(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


@contextmanager
def spans_on(into: dict):
    """The program's host-synchronised spans for the body; their totals,
    ``{name: (seconds, entries)}``, are put in ``into``."""
    spans.start()
    try:
        yield
    finally:
        into.update(spans.stop())


def sync(device) -> float:
    """Drain the device's queue; the host clock after."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def activities(device) -> list:
    """What the profiler records: the host, and the device where it is a
    GPU."""
    cuda = torch.device(device).type == "cuda"
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
