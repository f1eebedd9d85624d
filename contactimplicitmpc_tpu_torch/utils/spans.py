"""The port's spans: named stretches of host work at its layer boundaries.

``with span(name, like=None):`` marks its body in one of three modes.

* **Off** (the default): no clock is read, no profiler range is opened and
  the device is never synchronised; ``span`` returns one shared no-op
  context after two flag checks.
* **Totals**, between ``start()`` and ``stop()``: the body's host time is
  added to ``name`` and its entries counted, ``{name: (seconds,
  entries)}``. A span given a tensor ``like`` on a GPU calls
  ``torch.cuda.synchronize()`` before and after, so that the time is the
  device's work and not its enqueueing; that serialises host and device,
  so a run with totals on is slower than one without and only the shares
  are read from it. A span without ``like`` never synchronises.
* **Profiler**, whenever a ``torch.profiler`` records: the body is also a
  ``record_function`` range ``cimpc.<name>``, on the profiler's clock and
  nested by time in the span around it, so that the trace shows which
  layer the host was in while the device worked or waited. In this mode
  no span synchronises (a synchronisation would put idle time of its own
  into the trace it is read from), with totals on or off.

A span over CUDA tensors does nothing while the current stream is
capturing a CUDA graph (a synchronisation would break the capture, and the
body launches nothing then).

The spans, by layer: ``linearize`` (the gait's linearization),
``newton.capture`` and ``sim.capture`` (a graph set's warm-up and capture,
``utils/cuda_graphs.py``), ``rollout.prep`` (a control period's host work
before its Newton solve, ``control/rollout.py``), ``newton`` (a period's
Newton solve, in the rollout and the policy), ``newton.launch`` and
``sim.launch`` (a graph's replay, or the sim kernel's launch),
``newton.flag`` and ``sim.flag`` (the adaptive loops' read of their live
flag, one a trip), ``sim_ip`` (a sim step's solve) and ``policy.update``
(a control update of ``ci_mpc_policy``).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd.profiler import record_function

_totals = None
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def start():
    """Turn the totals on, from zero."""
    global _totals
    _totals = {}


def stop() -> dict:
    """Turn the totals off; ``{name: (seconds, entries)}`` since ``start``."""
    global _totals
    out, _totals = _totals or {}, None
    return out


def span(name: str, like=None):
    """A context over the body: the module's docstring."""
    if _totals is None and not _profiling():
        return _OFF
    return _on(name, like)


@contextlib.contextmanager
def _on(name: str, like):
    sync = like is not None and like.is_cuda
    if sync and torch.cuda.is_current_stream_capturing():
        yield
        return
    traced = _profiling()
    totals = _totals
    with record_function("cimpc." + name) if traced else _OFF:
        if totals is None:
            yield
            return
        sync = sync and not traced
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                torch.cuda.synchronize()
            seconds, entries = totals.get(name, (0.0, 0))
            totals[name] = (seconds + time.perf_counter() - t0, entries + 1)
