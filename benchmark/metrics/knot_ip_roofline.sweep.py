"""The knot kernel's share of its roofline over the profiled rollout: the
least time of its calls at the cell's shapes (``roofline/knot_ip.py``,
all fixed iterations counted) over its device time in the trace."""

from benchmark.metrics._roofline import newton_calls, share
from benchmark.reference.mpc import ip_options
from benchmark.roofline import knot_ip


def read(ctx):
    lanes, knots, starts, opts = newton_calls(ctx)
    launches = ctx.counters["knot_ip.launches"]
    if launches < starts:
        return None
    ip = ip_options(ctx.cell.config["mpc"]["knot_ip"])
    d = ctx.dims
    dims = dict(nx=d.nx, ny=d.ny, nz=d.nz, ntheta=d.ntheta, nq=d.nq, nc=d.nc)

    def call(n):
        return knot_ip.work(dims, n, knots, opts.fixed_ip_iters, ip.refine,
                            ip.max_ls) + (4,)

    first, trip = call(lanes * knots), call(lanes * (opts.max_ls + 1) * knots)
    return share(ctx, knot_ip.KERNEL,
                 [first] * starts + [trip] * (launches - starts))
