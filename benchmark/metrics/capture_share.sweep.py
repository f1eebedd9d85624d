"""The share of the window that the rollouts spent warming up and
capturing their CUDA graphs (the Newton's and the sim step's: the
``warmup_s`` and ``capture_s`` of ``control.graphs.stats`` and
``sim.graphs.stats``, counted over the window)."""


def read(ctx):
    c = ctx.window_counters
    seconds = sum(c[f"{side}.{key}"] for side in ("newton", "sim")
                  for key in ("warmup_s", "capture_s"))
    return 100.0 * seconds / ctx.window_s
