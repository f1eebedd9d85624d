"""The share of the profiled rollout in which the device idled while the
host was in a Newton solve (span ``newton``) outside the rollout's own work
(``idle_in_rollout.sweep``'s set): the graphs' launches
(``newton.launch``) and the live flag's reads (``newton.flag``) apart
beside it."""

from benchmark.metrics import _idle


def read(ctx):
    return _idle.layer_split(ctx.trace, "newton")
