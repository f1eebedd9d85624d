"""The share of the profiled rollout in which the device idled while the
host was in a sim step's solve (span ``sim_ip``) outside the rollout's own
work and the Newton: the kernel's launch or the graphs' (``sim.launch``)
and the live flag's reads (``sim.flag``) apart beside it, and, where the
sim solve replays trip graphs, the trips (``sim.trips``) and the idle
microseconds a trip."""

from benchmark.metrics import _idle


def read(ctx):
    out = _idle.layer_split(ctx.trace, "sim")
    trips = ctx.counters.get("sim.trips")
    if out is not None and trips:
        out["trips"] = trips
        idle_s = out["value"] / 100.0 * ctx.trace.window_s
        out["idle_us_a_trip"] = 1e6 * idle_s / trips
    return out
