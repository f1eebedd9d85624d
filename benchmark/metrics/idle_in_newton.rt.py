"""The share of the profiled control updates in which the device idled
while the host was in the policy's Newton solve (span ``newton``), over
the updates' summed length (``device_idle.rt``'s denominator)."""

from benchmark.metrics import _idle


def read(ctx):
    sets, total = _idle.rt_sets(ctx.trace)
    if not sets or not sets["newton"]:
        return None
    return 100.0 * _idle.idle_s(ctx.trace, sets["newton"]) / total
