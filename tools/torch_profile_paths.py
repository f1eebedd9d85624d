"""Where one control period of each of chip_smoke.py's MPC paths spends the
device's and the host's time, on the GPU.

    python3 tools/torch_profile_paths.py [--paths ABCDEFIK] [--steps N]

``--paths`` picks the paths by letter (all eight by default). ``--steps N``
also times one unprofiled run of N sim steps of each picked path on the
host clock (``steps_wall_s``; N a multiple of the path's period, the sim
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
Each rollout captures its sim solve's CUDA graphs at its first sim step
(``sim/graphs.py``), so a period is measured as the difference between a
run of two periods and a run of one: after a warm-up run of one period,
each of the two runs once on the host clock without a profiler, once under
``torch.profiler`` and once with the host-synchronised spans of
``utils/spans.py`` on (sim IP, Newton, of it the KKT solve and the knot
kernel; each span waits for the device, so the spanned wall is longer than
the plain one). One JSON line a path: the period's unprofiled wall, the
device's busy time (the sum of every kernel's self time) and its share of
that wall, the kernels that ran, the kernels launched from the host
(``cudaLaunchKernel``, ``cuLaunchKernel`` and their ``Ex`` forms, as the
profiler records those calls) against the graph replays (``cudaGraphLaunch``) whose
nodes ran the others, the knot kernel's launches (prologue and solve
counted apart) and device time, the sim kernel's (``csrc/sim_ip.cu``, one
a sim step of paths A and C), the five kernels with the most device
time, the spans (seconds and entries by name) with their wall, and the
two-period run's graph captures (``sim.graphs.stats``: sets, warm-up and
capture seconds, pool bytes). The captures' seconds are taken out of each
run's wall and ``sim_ip`` span before the difference: they vary from run
to run by more than a period costs. Only the device's activity is traced; the
profiler still slows the host, so the busy share is taken against the
unprofiled wall.
"""

import argparse
import json
import os
import re
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from contactimplicitmpc_tpu_torch.device import describe  # noqa: E402
from contactimplicitmpc_tpu_torch.hotpath import (  # noqa: E402
    HotPathConfig, conf_initial_states, make_quadruped_rollout)
from contactimplicitmpc_tpu_torch.sim import graphs  # noqa: E402
from contactimplicitmpc_tpu_torch.utils import spans  # noqa: E402


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


def capture_seconds():
    """Warm-up and capture seconds of the sim graphs since the last
    ``graphs.reset_stats()``."""
    return graphs.stats["warmup_s"] + graphs.stats["capture_s"]


def spanned(fn):
    """Run ``fn`` with host-synchronised spans on: ({name: [s, n]}, wall),
    the sim graphs' warm-up and capture taken out of the ``sim_ip`` span
    and the wall."""
    torch.cuda.synchronize()
    graphs.reset_stats()
    spans.start()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {k: list(v) for k, v in spans.stop().items()}
    out["sim_ip"][0] -= capture_seconds()
    return out, wall - capture_seconds()


def timed(fn):
    """Host wall of ``fn``, the sim graphs' warm-up and capture left out."""
    torch.cuda.synchronize()
    graphs.reset_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0 - capture_seconds()


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


def minus(two, one):
    """Per-key difference of two {key: (count, µs)} or {key: count}."""
    sub = (lambda a, b: tuple(x - y for x, y in zip(a, b))
           if isinstance(a, tuple) else a - b)
    zero = lambda a: (0, 0.0) if isinstance(a, tuple) else 0
    return {k: sub(v, one.get(k, zero(v))) for k, v in two.items()}


def main():
    parser = argparse.ArgumentParser(
        description="one profiled control period of chip_smoke's paths")
    parser.add_argument("--paths", default="ABCDEFIK")
    parser.add_argument("--steps", type=int, default=0)
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
        one, two = run(n_period), run(2 * n_period)
        one()
        walls = [timed(one), timed(two)]
        capture = dict(graphs.stats)     # of the two-period run
        wall = walls[1] - walls[0]
        (k1, c1), (k2, c2) = profiled(one), profiled(two)
        kernels, calls = minus(k2, k1), minus(c2, c1)
        busy = sum(us for _, us in kernels.values()) * 1e-6
        knot = [v for k, v in kernels.items()
                if re.search(r"knot_(ip|pack)(_wide)?_kernel", k)]
        sim = [v for k, v in kernels.items() if "sim_ip_kernel" in k]
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
        (s1, w1), (s2, w2) = spanned(one), spanned(two)
        span_s = {k: [v[0] - s1.get(k, (0.0, 0))[0],
                      v[1] - s1.get(k, (0.0, 0))[1]] for k, v in s2.items()}
        steps_wall = None
        if args.steps:
            steps_wall = timed(run(args.steps)) + capture_seconds()
        host = sum(calls.get(k, 0) for k in HOST_LAUNCHES)
        print(json.dumps({
            "path": name, "card": card, "lanes": 16,
            "steps": n_period, "steps_run": args.steps or None,
            "steps_wall_s": steps_wall,
            "runs_wall_s": walls, "wall_s": wall, "device_busy_s": busy,
            "device_busy_share_of_wall": busy / wall,
            "kernels_run": sum(n for n, _ in kernels.values()),
            "kernels_launched_from_host": host if calls else None,
            "graph_replays": (sum(calls.get(k, 0) for k in GRAPH_LAUNCHES)
                              if calls else None),
            "knot_kernel_launches": sum(n for n, _ in knot),
            "knot_kernel_device_ms": sum(us for _, us in knot) * 1e-3,
            "sim_kernel_launches": sum(n for n, _ in sim),
            "sim_kernel_device_ms": sum(us for _, us in sim) * 1e-3,
            "top_kernels_ms": [[k[:120], us * 1e-3] for k, (_, us) in top],
            "spans_wall_s": w2 - w1, "spans_s_entries": span_s,
            "graph_captures_two_period_run": capture}),
            flush=True)


if __name__ == "__main__":
    main()
