"""Host-synchronised spans: where a rollout's wall time goes.

Off by default, and then ``span`` does nothing: no clock is read and the
device is never synchronised. Between ``start()`` and ``stop()`` every
``with span(name, tensor):`` adds the host time of its body to ``name``,
with ``torch.cuda.synchronize()`` before and after when ``tensor`` lies on
a GPU, so that the time is the device's work and not its enqueueing. The
synchronisation serialises host and device: a run with spans on is slower
than one without, and only the shares are read from it. Spans nest
(``newton`` holds ``kkt_solve`` and ``knot_ip``); each name also counts
its entries. A span over CUDA tensors does nothing while the current
stream is capturing a CUDA graph (a synchronisation would break the
capture, and the body launches nothing then): inside the MPC's replayed
Newton solve (``control/graphs.py``) only the outer ``newton`` span, around
the replay, is timed.
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
    sync = like is not None and like.is_cuda
    if _totals is None or (sync and torch.cuda.is_current_stream_capturing()):
        yield
        return
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
