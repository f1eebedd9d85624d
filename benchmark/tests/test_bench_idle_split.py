"""The device's idle time split by the program's spans
(``metrics/_idle.py`` and its six readers): on a made-up trace whose
answers are known, each layer's share, its parts and the sums against
``device_idle.*``; on a traced CPU run, whose trace holds the spans but no
device operation, the six are left out of the line, not reported as 0."""

import pytest

from benchmark.harness import layers
from benchmark.harness.spec import load_module, part
from benchmark.harness.trace import Trace
from benchmark.tests.tiny import tiny_cell, tiny_run

SWEEP = ("idle_in_rollout.sweep", "idle_in_newton.sweep",
         "idle_in_sim.sweep")
RT = ("idle_in_newton.rt", "idle_in_policy.rt", "newton_launch_ms.rt")


def read(name, trace, **layer):
    reader = load_module(part("metrics", name, ".py"))
    return reader.read(layers.Context(None, dict(trace=trace, **layer),
                                      "cpu"))


def host(name, *ranges):
    return [(name, s, e) for s, e in ranges]


def device(*ranges):
    return [("kernel", s, e) for s, e in ranges]


def sweep_trace():
    """A rollout of 100 s: the linearization, a Newton solve that captures
    its graphs first, a sim step that captures its own, two preparations,
    and 10 s of harness at the end; 38 s of device work."""
    spans = (host("cimpc.linearize", (0, 10))
             + host("cimpc.rollout.prep", (10, 12), (40, 42))
             + host("cimpc.newton", (12, 40))
             + host("cimpc.newton.capture", (12, 20))
             + host("cimpc.newton.launch", (20, 22), (30, 31))
             + host("cimpc.newton.flag", (31, 33))
             + host("cimpc.sim_ip", (42, 90))
             + host("cimpc.sim.capture", (42, 50))
             + host("cimpc.sim.launch", (50, 51), (60, 61))
             + host("cimpc.sim.flag", (55, 56))
             + host("aten::add", (5, 6), (95, 96)))
    work = device((5, 8), (14, 16), (22, 30), (51, 55), (61, 80), (95, 97))
    return Trace(work, spans, 0.0, 100.0)


def test_sweep_split_is_exclusive_and_sums_to_the_idle_share():
    t = sweep_trace()
    counters = {"sim.trips": 4}
    got = {n: read(n, t, counters=counters) for n in SWEEP}
    # the rollout: linearize 10 − 3, the captures 8 − 2 and 8, prep 4
    assert got["idle_in_rollout.sweep"] == pytest.approx(
        {"value": 25.0, "linearize": 7.0, "capture": 14.0, "prep": 4.0})
    # the Newton less its capture: 20 s, 8 busy; launches 3, flag 2
    assert got["idle_in_newton.sweep"] == pytest.approx(
        {"value": 12.0, "launch": 3.0, "flag": 2.0})
    # the sim less its capture: 40 s, 23 busy; 17 s over 4 trips
    assert got["idle_in_sim.sweep"] == pytest.approx(
        {"value": 17.0, "launch": 2.0, "flag": 1.0, "trips": 4,
         "idle_us_a_trip": 17e6 / 4})
    idle = read("device_idle.sweep", t)
    assert idle == pytest.approx(62.0)
    # the 8 s of the harness are outside every span
    spanned = sum(got[n]["value"] for n in SWEEP)
    assert spanned <= idle and idle - spanned == pytest.approx(8.0)


def test_sweep_split_without_trip_counter_or_spans():
    """The parent's program: no trip counter, then no span at all."""
    t = sweep_trace()
    got = read("idle_in_sim.sweep", t, counters={})
    assert set(got) == {"value", "launch", "flag"}
    bare = Trace(t.device, [h for h in t.host if h[0] == "aten::add"],
                 t.start, t.end)
    for name in SWEEP:
        assert read(name, bare, counters={}) is None, name


def rt_trace():
    """Two profiled updates of 10 s: a policy update around a Newton solve
    that launches its graph; device work inside and between them."""
    spans = (host("benchmark.update", (0, 10), (20, 30))
             + host("cimpc.policy.update", (0.5, 9), (20.5, 29))
             + host("cimpc.newton", (2, 8), (22, 28))
             + host("cimpc.newton.launch", (2, 4), (22, 25)))
    work = device((4, 7), (12, 15), (25, 28.5))
    return Trace(work, spans, 0.0, 30.0)


def test_rt_split_is_exclusive_and_sums_to_the_idle_share():
    t = rt_trace()
    newton, policy = read("idle_in_newton.rt", t), read("idle_in_policy.rt", t)
    assert newton == pytest.approx(30.0)     # 6 of 20 s idle
    assert policy == pytest.approx(22.5)     # 2.5 + 2 of 20 s
    idle = read("device_idle.rt", t)
    assert idle == pytest.approx(67.5)
    assert newton + policy <= idle
    assert read("newton_launch_ms.rt", t) == pytest.approx(
        {"value": 2500.0, "p95": 2950.0})


def test_rt_readers_leave_out_what_they_cannot_read():
    t = rt_trace()
    no_device = Trace([], t.host, t.start, t.end)
    no_spans = Trace(t.device, host("benchmark.update", (0, 10)), 0.0, 30.0)
    for name in RT:
        assert read(name, no_device) is None, name
        assert read(name, no_spans) is None, name


@pytest.mark.parametrize("cell, names", [("quadruped-sweep", SWEEP),
                                         ("quadruped-rt", RT)])
def test_traced_cpu_run_leaves_the_split_out(monkeypatch, cell, names):
    """On the CPU the trace holds the program's spans and no device
    operation: the six are left out, not reported as 0."""
    seen = []
    read_all = layers.read_all

    def keep(cell, ctx):
        seen.append(ctx.trace)
        return read_all(cell, ctx)

    monkeypatch.setattr(layers, "read_all", keep)
    c = tiny_cell(cell)
    # one lane, a control period or two: the profiler records every CPU op
    c.traffic.update(lanes=1, steps=5 if cell.endswith("sweep") else 10)
    line = tiny_run(c, trace=True)
    assert line["correct"], line["checks"]
    assert {m["name"] for m in c.per_layer} >= set(names)
    spans = {n for n, _, _ in seen[0].host if n.startswith("cimpc.")}
    assert "cimpc.newton" in spans and not seen[0].device
    for name in names:
        assert name not in line["metrics"], name
