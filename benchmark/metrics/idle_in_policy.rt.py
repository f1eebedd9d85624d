"""The share of the profiled control updates in which the device idled
while the host was in the policy's update (span ``policy.update``) outside
its Newton solve: the altitude update, the reference window, the warm
start and the shift after the solve; over the updates' summed length."""

from benchmark.metrics import _idle


def read(ctx):
    sets, total = _idle.rt_sets(ctx.trace)
    if not sets or not sets["policy"]:
        return None
    return 100.0 * _idle.idle_s(ctx.trace, sets["policy"]) / total
