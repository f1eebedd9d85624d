"""The sim kernel's share of its roofline over the profiled rollout: the
least time of each sim step's launch on every lane, at the iterations its
problems took (``roofline/sim_ip.py``), over its device time in the
trace."""

from benchmark.metrics._roofline import share
from benchmark.reference.mpc import ip_options
from benchmark.roofline import sim_ip


def read(ctx):
    trips = ctx.traced["sim_trips"]
    if ctx.counters["sim_ip.launches"] != len(trips):
        return None
    opts = ip_options(ctx.cell.config["mpc"]["sim_ip"])
    lanes = ctx.traced["lanes"]
    return share(ctx, sim_ip.KERNEL,
                 [sim_ip.work(lanes, t, opts.max_ls, opts.refine, 4) + (4,)
                  for t in trips])
