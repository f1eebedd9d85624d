"""The share of the profiled rollout in which the device idled while the
host was in the rollout's own work: the gait's linearization, the graphs'
warm-ups and captures, and each control period's preparation before its
Newton solve (spans ``linearize``, ``newton.capture``, ``sim.capture``,
``rollout.prep``), each apart beside it."""

from benchmark.metrics import _idle


def read(ctx):
    t = ctx.trace
    sets = _idle.sweep_sets(t)
    if sets is None or not any(sets[k] for k in _idle.ROLLOUT):
        return None
    parts = {k: _idle.sweep_share(t, sets[k]) for k in _idle.ROLLOUT}
    return {"value": sum(parts.values()), **parts}
