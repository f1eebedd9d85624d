"""A sim step's contact solve, for every lane at once: the program's
``sim_ip`` span over the window (seconds over entries; the span
synchronises the device before and after)."""


def read(ctx):
    seconds, entries = ctx.spans.get("sim_ip", (0.0, 0))
    return 1e3 * seconds / entries if entries else None
