"""The host time a profiled control update spends launching the Newton's
graph (span ``newton.launch``): the median over the updates, the 95th
percentile beside it."""

import numpy as np

from benchmark.metrics import _idle


def read(ctx):
    t = ctx.trace
    ranges, _ = _idle.updates(t)
    launches = _idle.spans(t, "newton.launch")
    if not t.device or not ranges or not launches:
        return None
    ms = [1e3 * _idle.length(_idle.intersect(launches, [r])) for r in ranges]
    return {"value": float(np.percentile(ms, 50)),
            "p95": float(np.percentile(ms, 95))}
