"""Inputs come from the seed alone: the same seed gives the same draws and
initial states twice, another seed others, and any whole number serves."""

import os

import numpy as np
import pytest

from benchmark.harness import traffic
from benchmark.harness.spec import ROOT, load_cell, read_json

EVERY = lambda i: True

SEEDS = [0, 1, 2 ** 31 + 11, 2 ** 40 + 3, -5]


@pytest.mark.parametrize("name", ["quadruped-sweep", "centroidal-sweep",
                                  "quadruped-rt"])
def test_same_seed_same_inputs(name):
    cell = load_cell(name)
    refmod = cell.reference()
    ref = refmod.reference(cell.config)
    for seed in SEEDS:
        cell.traffic["draws"] = 3
        a = traffic.initial_states(refmod, ref, cell.traffic, seed, EVERY)
        b = traffic.initial_states(refmod, ref, cell.traffic, seed, EVERY)
        for (qa, va), (qb, vb) in zip(a, b):
            np.testing.assert_array_equal(qa, qb)
            np.testing.assert_array_equal(va, vb)
        assert np.isfinite(a[0][0]).all()
    one = traffic.draws(cell.traffic, SEEDS[2], 0)
    other = traffic.draws(cell.traffic, SEEDS[2] + 1, 0)
    assert not np.array_equal(one, other)
    low = np.asarray(cell.traffic["draw"]["low"])
    high = np.asarray(cell.traffic["draw"]["high"])
    assert ((one >= low) & (one <= high)).all()


def test_gait_start_lane():
    """Lane 0 of every sweep rollout, and the first episode of the real-time
    cell alone, start from the gait's own initial state."""
    for name, first_only in (("quadruped-sweep", False),
                             ("quadruped-rt", True)):
        cell = load_cell(name)
        cell.traffic["draws"] = 3
        refmod = cell.reference()
        ref = refmod.reference(cell.config)
        q1_gait = ref.gait_start()[0].numpy()
        states = traffic.initial_states(refmod, ref, cell.traffic, 3,
                                        cell.driver().gait_lane)
        np.testing.assert_array_equal(states[0][0][0], q1_gait)
        assert np.array_equal(states[1][0][0], q1_gait) != first_only


def test_a_drawn_lane_is_one_operation():
    """``attempted`` and ``failed`` count each drawn lane once, however
    often the window repeats its draw, so that a window holding one
    rollout more of the same draws counts the same; a lane lost in any
    repeat is failed."""
    conv = lambda *lost: np.array([[i not in lost] * 3 for i in range(4)])
    rollouts = [(0, conv(1)), (1, conv()), (0, conv(1)), (1, conv(2))]
    records = [{"draw": d, "conv": c} for d, c in rollouts]
    lost = lambda r: ~r["conv"].all(axis=1)
    assert traffic.operations(records[:2], lost) == (8, 1)
    assert traffic.operations(records[:3], lost) == (8, 1)
    assert traffic.operations(records, lost) == (8, 2)


@pytest.mark.parametrize("name", ["quadruped-sweep", "quadruped-rt"])
def test_every_draw_fits_in_a_window(name):
    """A mix whose lanes can be lost draws no more sets of initial states
    than a window holds rollouts (or episodes), with room for a program
    1.6 times as slow as today's on the card (PERF.md: a quadruped rollout
    3.7-4.6 s, an episode about 1.2 s)."""
    cell = load_cell(name)
    seconds = read_json(os.path.join(ROOT, "BENCHMARK.json"))["run_seconds"]
    per_draw_s = {"quadruped-sweep": 4.6, "quadruped-rt": 1.2}[name]
    assert cell.traffic["draws"] * per_draw_s * 1.6 <= seconds
