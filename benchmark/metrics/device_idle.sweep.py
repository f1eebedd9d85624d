"""The share of the profiled rollout in which no operation ran on the
device: one minus the union of its kernels, copies and sets over the
rollout's length."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
