"""A control period's Newton solve, for every lane at once: the program's
``newton`` span over the window (seconds over entries; the span
synchronises the device before and after)."""


def read(ctx):
    seconds, entries = ctx.spans.get("newton", (0.0, 0))
    return 1e3 * seconds / entries if entries else None
