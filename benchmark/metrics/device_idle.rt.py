"""The share of the profiled control updates in which no operation ran on
the device: one minus the union of the device's operations inside the
updates over their summed length."""

from benchmark.harness.trace import busy_within

UPDATE = "benchmark.update"


def read(ctx):
    ranges = ctx.trace.host_ranges(UPDATE)
    length = sum(e - s for s, e in ranges)
    if not length:
        return None
    return 100.0 * (1.0 - busy_within(ctx.trace.intervals(), ranges) / length)
