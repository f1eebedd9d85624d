"""Host-synchronised spans: where a rollout's wall time goes.

Off by default, and then ``span`` does nothing: no clock is read and the
device is never synchronised. Between ``start()`` and ``stop()`` every
``with span(name, tensor):`` adds the host time of its body to ``name``,
with ``torch.cuda.synchronize()`` before and after when ``tensor`` lies on
a GPU, so that the time is the device's work and not its enqueueing. The
synchronisation serialises host and device: a run with spans on is slower
than one without, and only the shares are read from it. Spans nest
(``newton`` holds ``kkt_solve`` and ``knot_ip``); each name also counts
its entries.
"""

from __future__ import annotations

import contextlib
import time

import torch

_totals = None


def start():
    """Turn the spans on, from zero."""
    global _totals
    _totals = {}


def stop() -> dict:
    """Turn the spans off; ``{name: (seconds, entries)}`` since ``start``."""
    global _totals
    out, _totals = _totals or {}, None
    return out


@contextlib.contextmanager
def span(name: str, like=None):
    if _totals is None:
        yield
        return
    sync = like is not None and like.is_cuda
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            torch.cuda.synchronize()
        seconds, entries = _totals.get(name, (0.0, 0))
        _totals[name] = (seconds + time.perf_counter() - t0, entries + 1)
