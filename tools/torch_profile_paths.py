"""Where one control period of each of chip_smoke.py's seven MPC paths
spends the device's and the host's time, on the GPU.

    python3 tools/torch_profile_paths.py [--paths ABCDEFI] [--steps N]

``--paths`` picks the paths by letter (all seven by default). ``--steps N``
also times one unprofiled run of N sim steps of each picked path on the
host clock (``steps_wall_s``; N a multiple of the path's period), after its
period's profile: ``--paths E --steps 50`` gives path E's wall at 50 steps
beside its kernels a period.

For path A (quadruped, structure-mode Newton), path B (2D hopper,
``simulate`` + ``ci_mpc_policy``, direct-mode Newton), path C (quadruped,
direct-mode Newton), path D (centroidal quadruped, ``mpc_rollout``
direct), path E (flamingo up the smooth slope, ``mpc_rollout`` direct),
path F (3D hopper, ``simulate`` + ``ci_mpc_policy`` direct) and path I
(point-foot quadruped standing under a push, ``mpc_rollout`` direct; its
first period, before the push), 16 lanes each, a period N_sample sim steps
(5; the 3D hopper's 10): warm up one period, time one period on the host
clock without a profiler, run one period under ``torch.profiler``, then one
period with the host-synchronised spans of ``utils/spans.py`` on (sim IP,
Newton, of it the KKT solve and the knot kernel; each span waits for the
device, so the spanned wall is longer than the plain one), and print one
JSON line a path: the unprofiled wall, the device's busy time (the sum of
every kernel's self time) and its share of that wall, the number of
kernels launched, the knot kernel's launches (prologue and solve counted
apart) and device time, the five kernels with the most device time, and
the spans (seconds and entries by name) with their wall. Only the device's
activity is traced (a period launches ~10⁵ kernels, and tracing the host's
side of each as well takes many minutes); the profiler still slows the
host, so the busy share is taken against the unprofiled wall.
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


def spanned(fn):
    """Run ``fn`` with host-synchronised spans on: ({name: [s, n]},
    wall)."""
    torch.cuda.synchronize()
    spans.start()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {k: list(v) for k, v in spans.stop().items()}, wall


def main():
    parser = argparse.ArgumentParser(
        description="one profiled control period of chip_smoke's paths")
    parser.add_argument("--paths", default="ABCDEFI")
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
              lambda: general_run(chip_smoke.point_foot_rollout(dev)))}
    for letter in args.paths:
        name, build = by_letter[letter]
        run, n_period = build()
        period = run(n_period)
        period()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        period()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            period()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) * 1e-6
        knot = [e for e in kernels
                if re.search(r"knot_(ip|pack)(_wide)?_kernel", e.key)]
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
        span_s, span_wall = spanned(period)
        steps_wall = None
        if args.steps:
            long_run = run(args.steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            long_run()
            torch.cuda.synchronize()
            steps_wall = time.perf_counter() - t0
        print(json.dumps({
            "path": name, "card": card, "lanes": 16,
            "steps": n_period, "steps_run": args.steps or None,
            "steps_wall_s": steps_wall,
            "wall_s": wall, "device_busy_s": busy,
            "device_busy_share_of_wall": busy / wall,
            "kernels_launched": sum(e.count for e in kernels),
            "knot_kernel_launches": sum(e.count for e in knot),
            "knot_kernel_device_ms": sum(e.self_device_time_total
                                         for e in knot) * 1e-3,
            "top_kernels_ms": [[e.key[:120], e.self_device_time_total * 1e-3]
                               for e in top],
            "spans_wall_s": span_wall, "spans_s_entries": span_s}),
            flush=True)


if __name__ == "__main__":
    main()
