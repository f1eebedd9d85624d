"""What the roofline readers share: the least time of a run of calls over
the kernel's device time in the trace, in percent, with the bound that
sets it and the card's power limit beside it."""

from benchmark.roofline import least_seconds


def share(ctx, pattern: str, calls) -> dict:
    """``calls``: [(operations, bytes, value bytes)], one a launch."""
    device_s = ctx.trace.device_seconds(pattern)
    if not calls or device_s <= 0:
        return None
    least, which = 0.0, {}
    for flops, nbytes, elem in calls:
        seconds, bound = least_seconds(flops, nbytes, elem)
        least += seconds
        which[bound] = which.get(bound, 0.0) + seconds
    return {"value": 100.0 * least / device_s,
            "bound_by": max(which, key=which.get),
            "power_limit": ctx.power_limit}


def newton_calls(ctx):
    """(lanes, knots a knot call, starts, trips, newton options) of the
    profiled rollout: every Newton solve, and every graph set's warm-up,
    makes one knot call on lanes × knots problems at its start and one on
    lanes × (max_ls + 1) × knots at each trip."""
    from benchmark.reference.cimpc.control.newton import NewtonOptions
    mpc = ctx.cell.config["mpc"]
    opts = NewtonOptions(**mpc["newton"])
    knots = mpc["h_mpc"] - (1 if mpc["newton_mode"] == "structure" else 0)
    starts = ctx.traced["periods"] + ctx.counters["newton.sets"]
    return ctx.traced["lanes"], knots, starts, opts
