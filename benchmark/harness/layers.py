"""The per-layer metrics of a traced run: each is read by its own file,
``metrics/<name>.py``, whose ``read(ctx)`` returns the value, a dict with
``value`` and further keys to print beside it, or None where the run holds
nothing for it to read (the metric is then left out of the line)."""

from __future__ import annotations

import dataclasses

import torch

from .spec import load_module, part


@dataclasses.dataclass
class Context:
    """What a reader may read. ``layer`` is the driver's: ``trace`` (the
    profiled stretch, ``trace.Trace``), and from a sweep ``counters`` (the
    program's counters over the profiled rollout), ``traced`` (its lanes,
    steps, periods and each sim step's iterations summed over the lanes),
    ``spans`` (the program's spans over the window), ``window_s`` and
    ``window_counters`` (the counters over the window)."""

    cell: object
    layer: dict
    device: object
    dims: object = None

    def __getattr__(self, name):
        try:
            return self.layer[name]
        except KeyError:
            raise AttributeError(name) from None

    @property
    def power_limit(self) -> str:
        """The card's name and power limit, as ``nvidia-smi`` reads them."""
        if torch.device(self.device).type != "cuda":
            return "cpu"
        from contactimplicitmpc_tpu_torch.device import describe
        return describe(self.device)


def read_all(cell, ctx: Context) -> dict:
    out = {}
    for metric in cell.per_layer:
        reader = load_module(part("metrics", metric["name"], ".py"))
        got = reader.read(ctx)
        if got is None:
            continue
        entry = got if isinstance(got, dict) else {"value": got}
        out[metric["name"]] = {"value": float(entry.pop("value")),
                               "unit": metric["unit"], **entry}
    return out
