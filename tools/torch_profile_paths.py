"""Where one control period of each of chip_smoke.py's MPC paths spends the
device's and the host's time, on the GPU.

    python3 tools/torch_profile_paths.py [--paths ABCDEFIK] [--steps N] [--repeats R] [--periods P]

``--paths`` picks the paths by letter (all eight by default). ``--steps N``
also times one unprofiled run of N sim steps of each picked path on the
host clock (``steps_wall_s``; N a multiple of the path's period, the
graphs' captures included), after its period's profile: ``--paths E
--steps 50`` gives path E's wall at 50 steps beside its kernels a period.

For path A (quadruped, structure-mode Newton), path B (2D hopper,
``simulate`` + ``ci_mpc_policy``, direct-mode Newton), path C (quadruped,
direct-mode Newton), path D (centroidal quadruped, ``mpc_rollout``
direct), path E (flamingo up the smooth slope, ``mpc_rollout`` direct),
path F (3D hopper, ``simulate`` + ``ci_mpc_policy`` direct), path I
(point-foot quadruped standing under a push, ``mpc_rollout`` direct; its
first periods, before the push) and path K (its box variant beside the
step), 16 lanes each, a period N_sample sim steps (5; the 3D hopper's 10).
A rollout captures its sim solve's and its Newton solve's CUDA graphs at
their first call (``sim/graphs.py``, ``control/graphs.py``; a policy's
Newton graphs once for the policy), so a period is measured as the
difference between a run of P + 1 periods (``--periods P``, 4) and a run
of one, over P: after a warm-up run of one period, the two runs in turn
R times (``--repeats R``, 3) on the host clock without a profiler (the
line gives each period, ``period_walls_s``, and their median,
``wall_s``), once under ``torch.profiler`` and once with the
host-synchronised spans of ``utils/spans.py`` on (sim IP and Newton; each
span waits for the device, so the spanned wall is longer than the plain
one). The captures' seconds, sim and Newton, are taken out of each run's
wall and of the ``sim_ip`` and ``newton`` spans before the difference.

One JSON line a path, a period's: the unprofiled wall, the device's busy
time (the sum of every kernel's self time) and its share of that wall,
the kernels that ran, the kernels launched from the host
(``cudaLaunchKernel``, ``cuLaunchKernel`` and their ``Ex`` forms, as the
profiler records those calls) against the graph replays
(``cudaGraphLaunch``) whose nodes ran the others, the knot kernel's
launches (prologue and solve counted apart) and device time, the sim
kernel's (``csrc/sim_ip.cu``, one a sim step of paths A and C), the KKT
kernels' (``csrc/structure_kkt.cu`` on A, ``csrc/ldl.cu`` on the direct
paths), the five kernels with the most device time, the spans (seconds and entries by
name) with their wall, the Newton replays and trip replays
(``control.graphs.stats``) and the longer run's sim and Newton captures
(sets, warm-up and capture seconds, pool bytes). No span times the KKT
solve inside a replayed Newton graph, so the KKT solve's time is taken
apart: the first KKT
a path's warm-up run solves is kept where the Newton calls the kernel's
wrapper (the direct mode's ``ops/ldl.py::ldl``, the structure mode's
``ops/structure_kkt.py::structure_kkt``), captured alone and its replays
timed with CUDA events, and its device time a solve times the period's
KKT solves (direct mode one a trip replayed, structure mode one a masked
trip) is ``kkt_solve_device_s``; the period's own trace gives the KKT
kernels' launches and device time beside it. Only the device's activity is traced;
the profiler still slows the host, so the busy share is taken against the
unprofiled wall.

With path A picked, a second line splits A's Newton replay by piece
(``newton_split``): the second Newton solve of a two-period run of A
(tests/test_torch_newton_graphs_cuda.py's ``path_call``) replayed under
``torch.profiler``, its device time a solve split into the structured KKT
kernel, the knot kernel, the residual assembly (``structure_residuals``,
captured alone at each shape the solve calls it with, 16 lanes and 16 × 7
trials, its replays timed with CUDA events, times its calls) and the rest (the masked update, the step's
application, the line search's selection, the knot solves' glue and the
inputs' copies).
"""

import argparse
import json
import os
import re
import sys
import time
from unittest import mock

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from contactimplicitmpc_tpu_torch.control import graphs as newton_graphs  # noqa: E402,E501
from contactimplicitmpc_tpu_torch.control import newton  # noqa: E402
from contactimplicitmpc_tpu_torch.control import structure_solver  # noqa: E402,E501
from contactimplicitmpc_tpu_torch.device import describe  # noqa: E402
from contactimplicitmpc_tpu_torch.hotpath import (  # noqa: E402
    HotPathConfig, conf_initial_states, make_quadruped_rollout)
from contactimplicitmpc_tpu_torch.sim import graphs  # noqa: E402
from contactimplicitmpc_tpu_torch.utils import spans  # noqa: E402
from contactimplicitmpc_tpu_torch.utils.cuda_graphs import Captured  # noqa: E402,E501


def quadruped_run(cfg, dev):
    """(run of n steps, steps a period) of a quadruped path."""
    def run(n):
        roll, ref, model, _, _ = make_quadruped_rollout(
            cfg, n, torch.float32, device=dev)
        q1s, v1s = conf_initial_states(model, ref)
        return lambda: roll(q1s, v1s)
    return run, cfg.n_sample


def general_run(rollout):
    """(run of n steps, steps a period) from one of chip_smoke's
    ``*_rollout`` tuples (roll, ref, n_sample, ...)."""
    roll, _, n_sample = rollout[:3]
    return (lambda n: (lambda: roll(n))), n_sample


def capture_seconds(stats):
    """Warm-up and capture seconds in graph ``stats`` since their last
    reset."""
    return stats["warmup_s"] + stats["capture_s"]


def reset():
    graphs.reset_stats()
    newton_graphs.reset_stats()


def spanned(fn):
    """Run ``fn`` with host-synchronised spans on: ({name: [s, n]}, wall),
    the sim and Newton graphs' warm-ups and captures taken out of the
    ``sim_ip`` and ``newton`` spans and the wall."""
    torch.cuda.synchronize()
    reset()
    spans.start()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {k: list(v) for k, v in spans.stop().items()}
    sim_s, newton_s = (capture_seconds(graphs.stats),
                       capture_seconds(newton_graphs.stats))
    out["sim_ip"][0] -= sim_s
    out["newton"][0] -= newton_s
    return out, wall - sim_s - newton_s


def timed(fn):
    """(host wall of ``fn``, the sim and Newton graphs' warm-ups and
    captures left out; the Newton graphs' counts of the run)."""
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (wall - capture_seconds(graphs.stats)
            - capture_seconds(newton_graphs.stats), dict(newton_graphs.stats))


def first_kkt(fn):
    """Run ``fn`` and keep the first KKT system its Newton solves outside a
    capture, through the direct mode's ``ldl`` or the structure mode's
    ``structure_kkt`` (the kernels' wrappers, the route the paths take):
    ((function, arguments) or None, the KKT solves made outside a
    capture)."""
    kept, calls = [], [0]

    def keeper(module, name):
        original = getattr(module, name)

        def keep(*args):
            if not torch.cuda.is_current_stream_capturing():
                calls[0] += 1
                if not kept:
                    kept.append((original, tuple(
                        a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args)))
            return original(*args)

        return mock.patch.object(module, name, keep)

    with keeper(newton, "ldl"), keeper(structure_solver, "structure_kkt"):
        fn()
    return (kept[0] if kept else None), calls[0]


def kkt_device_ms(kkt, reps=10):
    """Device ms of one call of ``kkt`` ((function, arguments), as
    ``first_kkt`` keeps a KKT solve), captured alone and its replays timed
    with CUDA events behind a device spin (``chip_smoke.cuda_ms``), and its
    kernels a call from ``reps`` replays under ``torch.profiler`` (whose
    trace of a one-kernel graph's replays has missed some of the
    hand-written kernels' records, so it gives the count, not the time)."""
    stats = dict.fromkeys(("sets", "warmup_s", "capture_s", "pool_bytes"), 0)
    fn, args = kkt
    solve = lambda: fn(*args)
    device = next(a for a in args if isinstance(a, torch.Tensor)).device
    captured = Captured("kkt", {"kkt": solve}, solve, device, stats)
    replay = lambda: captured.replay("kkt")
    ms = chip_smoke.cuda_ms(replay, reps, spin=True)
    kernels = device_kernels(replay, reps)
    return ms, sum(n for n, _ in kernels.values())


HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def profiled(fn):
    """Kernels of one run of ``fn`` under ``torch.profiler``: {kernel:
    (count, device µs)}, and {runtime call: count} for the launch calls."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = {e.key: (e.count, e.self_device_time_total) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA}
    calls = {e.key: e.count for e in events
             if e.key in HOST_LAUNCHES + GRAPH_LAUNCHES}
    return kernels, calls


def device_kernels(fn, reps):
    """{kernel: (count, device ms)} a call of ``fn``, over ``reps`` calls
    under ``torch.profiler``."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / reps, e.self_device_time_total * 1e-3 / reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def newton_split(dev, reps=10):
    """Path A's Newton replay split by piece (the module's docstring):
    device ms a solve."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_newton_graphs_cuda as newton_tests
    solve, args = newton_tests.path_call("A", dev)
    solve(*args)                                    # captures
    kernels = device_kernels(lambda: solve(*args), reps)
    by = lambda pattern: sum(ms for k, (_, ms) in kernels.items()
                             if re.search(pattern, k))
    total = sum(ms for _, ms in kernels.values())
    kkt, knot = by(r"structure_kkt_kernel"), by(r"knot_(ip|pack)")
    calls, original = {}, structure_solver.structure_residuals

    def keep(*a):
        lead = tuple(a[2].qa.shape[:-2])            # the state's batch
        calls.setdefault(lead, [a, 0])[1] += 1
        return original(*a)

    with mock.patch.object(structure_solver, "structure_residuals", keep):
        solve._eager(*args)
    shapes, residual = {}, 0.0
    for lead, (a, count) in calls.items():
        ms, n = kkt_device_ms((original, a), reps)
        shapes["x".join(map(str, lead))] = {"calls": count, "device_ms": ms,
                                            "kernels": n}
        residual += ms * count
    return {"newton_split": {
        "path": "A quadruped structure", "card": describe(dev),
        "replay_device_ms": total,
        "replay_kernels": sum(n for n, _ in kernels.values()),
        "structure_kkt_kernel_ms": kkt, "knot_kernel_ms": knot,
        "residual_assembly_ms": residual, "residual_assembly": shapes,
        "rest_ms": total - kkt - knot - residual}}


def minus(two, one, periods):
    """Per-key difference of two {key: (count, µs)} or {key: count}, over
    ``periods``."""
    sub = (lambda a, b: tuple((x - y) / periods for x, y in zip(a, b))
           if isinstance(a, tuple) else (a - b) / periods)
    zero = lambda a: (0, 0.0) if isinstance(a, tuple) else 0
    return {k: sub(v, one.get(k, zero(v))) for k, v in two.items()}


def main():
    parser = argparse.ArgumentParser(
        description="one profiled control period of chip_smoke's paths")
    parser.add_argument("--paths", default="ABCDEFIK")
    parser.add_argument("--steps", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--periods", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_paths: CUDA is not available")
    dev = torch.device("cuda")
    card = describe(dev)
    by_letter = {
        "A": ("A quadruped structure",
              lambda: quadruped_run(HotPathConfig(), dev)),
        "B": ("B hopper_2d simulate+ci_mpc_policy direct",
              lambda: general_run(chip_smoke.hopper_rollout(dev))),
        "C": ("C quadruped direct",
              lambda: quadruped_run(HotPathConfig(newton_mode="direct"),
                                    dev)),
        "D": ("D centroidal_quadruped mpc_rollout direct",
              lambda: general_run(chip_smoke.centroidal_rollout(dev))),
        "E": ("E flamingo mpc_rollout direct, slope",
              lambda: general_run(chip_smoke.flamingo_rollout(dev))),
        "F": ("F hopper_3d simulate+ci_mpc_policy direct",
              lambda: general_run(chip_smoke.hopper3d_rollout(dev))),
        "I": ("I point_foot_quadruped mpc_rollout direct, stand",
              lambda: general_run(chip_smoke.point_foot_rollout(dev))),
        "K": ("K centroidal_quadruped_box mpc_rollout direct, stand",
              lambda: general_run(chip_smoke.box_rollout(dev)))}
    for letter in args.paths:
        name, build = by_letter[letter]
        run, n_period = build()
        p = args.periods
        one, two = run(n_period), run((p + 1) * n_period)
        kkt, kkt_calls = first_kkt(one)
        periods = []
        for _ in range(args.repeats):
            (t1, n1), (t2, n2) = timed(one), timed(two)
            periods.append((t2 - t1) / p)
        walls = [t1, t2]                 # of the last repeat
        capture = dict(graphs.stats)     # of the longer run
        wall = sorted(periods)[len(periods) // 2]
        newton_period = {k: (n2[k] - n1[k]) / p for k in ("replays", "trips")}
        kkt_ms, kkt_kernels = kkt_device_ms(kkt) if kkt else (None, None)
        structure = kkt is not None and kkt[0] is not newton.ldl
        # a direct-mode trip solves one KKT; a structure-mode solve as many
        # as its masked trips, which the warm-up's eager solve counted
        kkt_solves = (newton_period["replays"] * kkt_calls if structure
                      else newton_period["trips"])
        (k1, c1), (k2, c2) = profiled(one), profiled(two)
        kernels, calls = minus(k2, k1, p), minus(c2, c1, p)
        busy = sum(us for _, us in kernels.values()) * 1e-6
        knot = [v for k, v in kernels.items()
                if re.search(r"knot_(ip|pack)(_wide)?_kernel", k)]
        sim = [v for k, v in kernels.items() if "sim_ip_kernel" in k]
        kkt_k = [v for k, v in kernels.items()
                 if re.search(r"structure_kkt_kernel|ldl_kernel", k)]
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
        (s1, w1), (s2, w2) = spanned(one), spanned(two)
        span_s = {k: [(v[0] - s1.get(k, (0.0, 0))[0]) / p,
                      (v[1] - s1.get(k, (0.0, 0))[1]) / p]
                  for k, v in s2.items()}
        steps_wall = None
        if args.steps:
            steps_wall, _ = timed(run(args.steps))
            steps_wall += (capture_seconds(graphs.stats)
                           + capture_seconds(newton_graphs.stats))
        host = sum(calls.get(k, 0) for k in HOST_LAUNCHES)
        print(json.dumps({
            "path": name, "card": card, "lanes": 16,
            "steps": n_period, "steps_run": args.steps or None,
            "steps_wall_s": steps_wall,
            "runs_wall_s": walls, "period_walls_s": periods,
            "wall_s": wall, "device_busy_s": busy,
            "device_busy_share_of_wall": busy / wall,
            "kernels_run": sum(n for n, _ in kernels.values()),
            "kernels_launched_from_host": host if calls else None,
            "graph_replays": (sum(calls.get(k, 0) for k in GRAPH_LAUNCHES)
                              if calls else None),
            "knot_kernel_launches": sum(n for n, _ in knot),
            "knot_kernel_device_ms": sum(us for _, us in knot) * 1e-3,
            "sim_kernel_launches": sum(n for n, _ in sim),
            "sim_kernel_device_ms": sum(us for _, us in sim) * 1e-3,
            "kkt_kernel_launches": sum(n for n, _ in kkt_k),
            "kkt_kernel_device_ms": sum(us for _, us in kkt_k) * 1e-3,
            "top_kernels_ms": [[k[:120], us * 1e-3] for k, (_, us) in top],
            "spans_wall_s": (w2 - w1) / p, "spans_s_entries": span_s,
            "newton_replays": newton_period["replays"],
            "newton_trip_replays": newton_period["trips"],
            "kkt": (None if kkt is None else "structure_kkt" if structure
                    else "ldl"),
            "kkt_n": (None if kkt is None or structure
                      else kkt[1][0].shape[-1]),
            "kkt_solves": kkt_solves,
            "kkt_solve_device_ms_a_solve": kkt_ms,
            "kkt_solve_kernels_a_solve": kkt_kernels,
            "kkt_solve_device_s": (None if kkt is None else
                                   kkt_ms * 1e-3 * kkt_solves),
            "graph_captures_longer_run": capture,
            "newton_captures_longer_run": n2}),
            flush=True)
        if letter == "A":
            print(json.dumps(newton_split(dev)), flush=True)


if __name__ == "__main__":
    main()
