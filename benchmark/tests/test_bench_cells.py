"""Each cell's traffic, run through the whole harness on the CPU at a tiny
size (the program's plain path): the result line and what it holds."""

import json

import pytest

from benchmark.tests.tiny import tiny_cell, tiny_run

CELLS = ["quadruped-sweep", "centroidal-sweep", "quadruped-rt"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    cell = tiny_cell(name)
    line = tiny_run(cell)
    assert list(line)[0] == "correct" and list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["attempted"] == cell.traffic["lanes"] and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == set(cell.limits)
    assert line["device"]["platform"] == "cpu"
    json.dumps(line)


def test_traced_line_reads_the_layers_it_can():
    """With ``--trace 1`` the line carries the per-layer metrics instead:
    on the CPU the spans and counters read, the device's metrics (no
    device trace) are left out, not reported as 0."""
    cell = tiny_cell("quadruped-sweep")
    # a shorter rollout: the profiler records every operation on the CPU
    cell.traffic.update(lanes=2, steps=25)
    line = tiny_run(cell, trace=True)
    assert line["correct"]
    metrics = line["metrics"]
    assert metrics["newton_ms.sweep"]["value"] > 0
    assert metrics["sim_step_ms.sweep"]["value"] > 0
    assert "capture_share.sweep" in metrics
    for name in ("kkt_roofline.sweep", "knot_ip_roofline.sweep",
                 "sim_ip_roofline.sweep"):
        assert name not in metrics
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
