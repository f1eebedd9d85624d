"""A device trace of part of a run, and what the metrics read from it.

``torch.profiler`` records the host's operations and the device's kernels,
copies and sets on one clock. The trace is exported once (a Chrome trace
in the run's temporary directory, deleted once read) and reduced here:

* ``busy``: the union of the device's intervals, so that overlapping
  kernels count once;
* ``busy_within``: that union inside given host ranges;
* ``breakdown``: the device operations with the most time, and the idle
  time between them by the host operation that was running at its middle.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Trace:
    """The events of one profiled stretch, in seconds on the trace's
    clock: ``device`` [(name, start, end)], ``host`` [(name, start, end)],
    and the stretch itself, ``start`` to ``end``."""

    def __init__(self, device, host, start, end):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = host
        self.start, self.end = start, end

    @classmethod
    def from_profiler(cls, prof, mark: str) -> "Trace":
        """Read ``prof`` (stopped); the stretch is the host annotation
        ``mark`` (a ``record_function`` around the profiled work)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        device, host, marks = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            span = (e["name"], 1e-6 * e["ts"], 1e-6 * (e["ts"] + e["dur"]))
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                device.append(span)
            elif cat in HOST_CATS:
                host.append(span)
                if e["name"] == mark:
                    marks.append(span)
        if not marks:
            raise RuntimeError(f"trace: no {mark!r} range in the trace")
        return cls(device, host, min(m[1] for m in marks),
                   max(m[2] for m in marks))

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def intervals(self, pattern: str = None):
        if pattern is None:
            return [(s, e) for _, s, e in self.device]
        regex = re.compile(pattern)
        return [(s, e) for n, s, e in self.device if regex.search(n)]

    def device_seconds(self, pattern: str) -> float:
        """The summed duration of the device operations named by
        ``pattern``; 0 where none ran."""
        return sum(e - s for s, e in self.intervals(pattern))

    def busy_s(self) -> float:
        return busy_within(self.intervals(), [(self.start, self.end)])

    def host_ranges(self, name: str):
        return [(s, e) for n, s, e in self.host if n == name]

    def breakdown(self, top: int = 10) -> dict:
        by_op = defaultdict(float)
        for name, s, e in self.device:
            by_op[name] += e - s
        idle, edge = [], self.start
        inside = [(s, e) for s, e in self.intervals() if s < self.end]
        for s, e in merged(inside + [(self.end, self.end)]):
            if s > edge:
                idle.append((0.5 * (edge + s), s - edge))
            edge = max(edge, e)
        gaps = defaultdict(float)
        for (_, length), name in zip(idle, self.host_at([m for m, _ in idle])):
            gaps[name] += length
        order = lambda d: sorted(([k, v] for k, v in d.items()),
                                 key=lambda kv: -kv[1])[:top]
        return {"device_ops": order(by_op), "idle_gaps": order(gaps)}

    def host_at(self, times):
        """For each of the sorted ``times``, the innermost host operation
        running then (host operations nest, so the last one started that
        has not ended)."""
        host = sorted(self.host, key=lambda h: h[1])
        names, stack, i = [], [], 0
        for t in times:
            while i < len(host) and host[i][1] <= t:
                while stack and stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            names.append(stack[-1][0] if stack else "host: nothing traced")
        return names


def merged(intervals):
    """The union of ``intervals`` as disjoint sorted (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_within(intervals, ranges) -> float:
    """The length of the union of ``intervals`` inside the union of
    ``ranges``."""
    total, union, j = 0.0, merged(intervals), 0
    for a, b in merged(ranges):
        while j < len(union) and union[j][1] <= a:
            j += 1
        k = j
        while k < len(union) and union[k][0] < b:
            total += min(union[k][1], b) - max(union[k][0], a)
            k += 1
    return total
