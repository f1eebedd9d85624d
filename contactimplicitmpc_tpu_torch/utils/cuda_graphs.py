"""Pieces of work captured as CUDA graphs and replayed by name, and the
linear-algebra routines such a capture can hold.

``Captured(label, pieces, warmup, device, stats)`` is the capture both
compiled solves of the port use: the sim step's (``sim/graphs.py``, label
``"sim"``) and the MPC's Newton solve (``control/graphs.py``,
``"newton"``). Each piece is a function of no
arguments over tensors the caller keeps (its static inputs and any carry);
what it returns stays in the graphs' memory and is read after a replay.

* ``warmup`` runs once eagerly on a side stream, outside any capture: the
  lazily made constants (a model's, an index table's), the libraries'
  handles and workspaces and the kernels' builds come into being there;
* each piece is then captured once on that stream, the pieces sharing one
  memory pool (they replay one after another on one stream), with the
  cyclic collector off (freeing another set's graphs inside a capture
  frees device memory, which invalidates it) and the capture mode
  ``thread_local`` (other threads, NCCL's watchdog on a sweep, may query
  the device meanwhile);
* a hand-written kernel's wrapper counts its launches where it launches
  (``knot_ip.launches``): a capture calls the wrapper but launches
  nothing, so the launches a piece's capture counted are taken back and
  added again on each replay of the piece (``counters``).

``stats`` gains the set (``sets``), its warm-up and capture seconds and
the device bytes its pool reserved. A capture that fails raises: there is
no eager path on the card. The whole construction is the span
``<label>.capture``, each replay's launch the span ``<label>.launch``
(``utils/spans.py``).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Iterable

import torch

from .spans import span


@contextlib.contextmanager
def capturable_linalg(like):
    """On the card, PyTorch's factorizations take cuSOLVER's and cuBLAS's
    routines for the duration of the block: for a batch of more than 8
    small matrices its default LU is MAGMA's, whose batched LU synchronises
    the device, which a CUDA graph cannot hold. Eager and captured solves
    take the same routines, so the two agree bit for bit. Nothing changes
    for CPU tensors."""
    if not like.is_cuda:
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


class Captured:
    """The CUDA graphs of ``pieces`` ({name: function}) on ``device``,
    captured at construction (the module's docstring); ``replay(name)``
    replays one and returns what its function returned. ``label`` names the
    owner in the spans; ``counters`` are kernel wrappers with a
    ``launches`` count."""

    def __init__(self, label: str, pieces: dict, warmup: Callable, device,
                 stats: dict, counters: Iterable = ()):
        self.launch_span = label + ".launch"
        with span(label + ".capture"):
            self._capture(pieces, warmup, device, stats, tuple(counters))

    def _capture(self, pieces, warmup, device, stats, counters):
        stream = torch.cuda.Stream(device)
        pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(device)
        t0 = time.perf_counter()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            warmup()
        current.wait_stream(stream)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t1 = time.perf_counter()
        self.graphs, self.outputs, self.launches = {}, {}, {}
        collecting = gc.isenabled()
        gc.disable()
        try:
            for name, fn in pieces.items():
                before = [c.launches for c in counters]
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.outputs[name] = fn()
                self.graphs[name] = g
                self.launches[name] = [(c, c.launches - n)
                                       for c, n in zip(counters, before)]
                for c, n in self.launches[name]:
                    c.launches -= n        # captured, not launched
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(device)
        stats["sets"] += 1
        stats["warmup_s"] += t1 - t0
        stats["capture_s"] += time.perf_counter() - t1   # and instantiation
        stats["pool_bytes"] += torch.cuda.memory_reserved(device) - reserved

    def replay(self, name: str):
        with span(self.launch_span):
            self.graphs[name].replay()
        for counter, n in self.launches[name]:
            counter.launches += n
        return self.outputs[name]
