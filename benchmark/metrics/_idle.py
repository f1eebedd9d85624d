"""What the idle-split readers share: the device's idle time inside sets of
host ranges of the program's spans (``cimpc.<name>`` in the trace, where
the program's ``utils/spans.py`` puts them while a profiler records).

The sets of one split are made exclusive, each less the sets before it, so
that an idle instant counts in one layer at most and the layers' shares
sum to at most the device's idle share (``device_idle.*``). The rest of
the idle time is outside every program span: the harness and, in a sweep,
the rollout's statistics."""

from benchmark.harness.trace import busy_within, merged

PREFIX = "cimpc."
UPDATE = "benchmark.update"      # a real-time control update's range
# a sweep's sets, in the order they take their instants: the rollout's
# host work (the linearization, the graphs' captures, a period's
# preparation), then the Newton solves, then the sim steps
SWEEP = (("linearize", ("linearize",)),
         ("capture", ("newton.capture", "sim.capture")),
         ("prep", ("rollout.prep",)),
         ("newton", ("newton",)),
         ("sim", ("sim_ip",)))
ROLLOUT = ("linearize", "capture", "prep")


def spans(trace, *names):
    """The union of the host ranges of the program's spans ``names``."""
    return merged([r for n in names for r in trace.host_ranges(PREFIX + n)])


def length(ranges) -> float:
    return sum(e - s for s, e in merged(ranges))


def intersect(a, b):
    """The instants in both unions of ranges."""
    a, b, out, i, j = merged(a), merged(b), [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b):
    """The instants of the union ``a`` outside the union ``b``."""
    out, b, j = [], merged(b), 0
    for s, e in merged(a):
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def idle_s(trace, ranges) -> float:
    """The seconds of ``ranges`` in which no device operation ran."""
    return length(ranges) - busy_within(trace.intervals(), ranges)


def exclusive(trace, groups, inside):
    """{key: ranges} of ``groups`` ([(key, span names)]) inside the ranges
    ``inside``, each less the groups before it; None where the trace holds
    no device operation."""
    if not trace.device:
        return None
    out, taken = {}, []
    for key, names in groups:
        out[key] = subtract(intersect(spans(trace, *names), inside), taken)
        taken = merged(taken + out[key])
    return out


def sweep_sets(trace):
    """A sweep's profiled rollout split into ``SWEEP``'s sets."""
    return exclusive(trace, SWEEP, [(trace.start, trace.end)])


def sweep_share(trace, ranges) -> float:
    """Idle seconds in ``ranges`` over the profiled rollout, in percent."""
    return 100.0 * idle_s(trace, ranges) / trace.window_s


def layer_split(trace, layer: str):
    """The sweep metric of ``layer`` (``"newton"`` or ``"sim"``): the idle
    share of its set, with the shares inside its ``<layer>.launch`` and
    ``<layer>.flag`` spans beside it; None where the layer's span is
    absent."""
    sets = sweep_sets(trace)
    if sets is None or not sets[layer]:
        return None
    out = {"value": sweep_share(trace, sets[layer])}
    for part in ("launch", "flag"):
        out[part] = sweep_share(trace, intersect(
            sets[layer], spans(trace, f"{layer}.{part}")))
    return out


def updates(trace):
    """The real-time cell's profiled updates: their ranges and summed
    length (``device_idle.rt``'s denominator)."""
    ranges = trace.host_ranges(UPDATE)
    return ranges, sum(e - s for s, e in ranges)


def rt_sets(trace):
    """The profiled updates' Newton solves, and the rest of their policy
    updates; None where the trace holds no device operation or no update."""
    ranges, total = updates(trace)
    if not total:
        return None, total
    return exclusive(trace, (("newton", ("newton",)),
                             ("policy", ("policy.update",))), ranges), total
