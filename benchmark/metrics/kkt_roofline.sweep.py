"""The Newton's KKT kernel's share of its roofline over the profiled
rollout: the structured solve (``roofline/structure_kkt.py``) in structure
mode, the LDLᵀ of the dense horizon KKT (``roofline/ldl.py``) in direct
mode; each launch solves every lane's system."""

from benchmark.metrics._roofline import share
from benchmark.reference.cimpc.control.implicit_dynamics import CONFIGURATION
from benchmark.reference.cimpc.control.newton import NewtonIndices
from benchmark.roofline import ldl, structure_kkt


def read(ctx):
    mpc, d = ctx.cell.config["mpc"], ctx.dims
    lanes, h = ctx.traced["lanes"], mpc["h_mpc"]
    if mpc["newton_mode"] == "structure":
        launches = ctx.counters["structure_kkt.launches"]
        call = structure_kkt.work(d.nq, d.nu, h, lanes, 4) + (4,)
        return share(ctx, structure_kkt.KERNEL, [call] * launches)
    launches = ctx.counters["ldl.launches"]
    n = NewtonIndices(d, h, CONFIGURATION).ntot
    return share(ctx, ldl.KERNEL, [ldl.work(n, lanes, 4) + (4,)] * launches)
