"""Every input a run draws, from ``--seed`` and nothing else.

Each stream is numpy's generator over the seed and a stream number, so
that the same seed gives the same inputs, whatever else a run draws and in
whatever order. A seed may be any whole number."""

from __future__ import annotations

import numpy as np

CHECK = 1 << 30     # the comparison's sample; rollouts use 0, 1, 2, ...


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)) % (1 << 63), stream,
                                  int(seed < 0)])


def draws(traffic: dict, seed: int, index: int) -> np.ndarray:
    """The ``index``-th rollout's (or episode's) draws, (lanes, columns):
    each column uniform between the mix's ``low`` and ``high``."""
    low = np.asarray(traffic["draw"]["low"], dtype=np.float64)
    high = np.asarray(traffic["draw"]["high"], dtype=np.float64)
    u = rng(seed, index).random((traffic["lanes"], low.shape[0]))
    return low + (high - low) * u


def operations(records, lost) -> tuple:
    """(attempted, failed) over the distinct draws that a window ran. A
    lane of a draw is one operation, however often the window repeats the
    draw, and it fails where any of its runs lost it (``lost(record)``:
    one flag a lane). A window that holds every draw of the mix so counts
    the same operations whatever number of rollouts (or episodes) fits in
    it, and the same seed the same failures."""
    by_draw = {}
    for r in records:
        flags = np.asarray(lost(r), dtype=bool)
        d = r["draw"]
        by_draw[d] = by_draw[d] | flags if d in by_draw else flags
    return (sum(f.size for f in by_draw.values()),
            int(sum(f.sum() for f in by_draw.values())))


def initial_states(reference_module, reference, traffic: dict, seed: int,
                   gait_lane):
    """[(q1, v1)] float64 arrays (lanes, nq), one for each of the mix's
    ``draws`` rollouts (or episodes); ``gait_lane(i)`` says whether lane 0
    of the ``i``-th starts from the gait's own initial state (the
    driver's rule)."""
    return [reference_module.initial_states(
        reference, draws(traffic, seed, i), gait_lane(i))
        for i in range(traffic["draws"])]
