"""Where one control period of each of chip_smoke.py's six paths spends
the device's time, on the GPU.

    python3 tools/torch_profile_paths.py

For path A (quadruped, structure-mode Newton), path B (2D hopper,
``simulate`` + ``ci_mpc_policy``, direct-mode Newton), path C (quadruped,
direct-mode Newton), path D (centroidal quadruped, ``mpc_rollout``
direct), path E (flamingo up the smooth slope, ``mpc_rollout`` direct) and
path F (3D hopper, ``simulate`` + ``ci_mpc_policy`` direct), 16 lanes each,
a period N_sample sim steps (5; the 3D hopper's 10): warm up one period,
time one period
on the host clock without a profiler, then run one period under
``torch.profiler`` and print one JSON line a path: the unprofiled wall, the
device's busy time (the sum of every kernel's self time) and its share of
that wall, the number of kernels launched, the knot kernel's launches
(prologue and solve counted apart) and device time, and the five kernels with the most device time. Only the
device's activity is traced (a period launches ~10⁵ kernels, and tracing
the host's side of each as well takes many minutes); the profiler still
slows the host, so the busy share is taken against the unprofiled wall.
"""

import json
import os
import re
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from contactimplicitmpc_tpu_torch.hotpath import (  # noqa: E402
    HotPathConfig, conf_initial_states, make_quadruped_rollout)


def quadruped_period(cfg, dev):
    roll, ref, model, _, _ = make_quadruped_rollout(cfg, cfg.n_sample,
                                                    torch.float32, device=dev)
    q1s, v1s = conf_initial_states(model, ref)
    return lambda: roll(q1s, v1s)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_paths: CUDA is not available")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    hopper_roll, _, n_sample, _ = chip_smoke.hopper_rollout(dev)
    centroidal_roll, _, n_sample_d, _ = chip_smoke.centroidal_rollout(dev)
    flamingo_roll, _, n_sample_e, _, _ = chip_smoke.flamingo_rollout(dev)
    hopper3d_roll, _, n_sample_f, _ = chip_smoke.hopper3d_rollout(dev)
    paths = {
        "A quadruped structure": quadruped_period(HotPathConfig(), dev),
        "B hopper_2d simulate+ci_mpc_policy direct":
            lambda: hopper_roll(n_sample),
        "C quadruped direct": quadruped_period(
            HotPathConfig(newton_mode="direct"), dev),
        "D centroidal_quadruped mpc_rollout direct":
            lambda: centroidal_roll(n_sample_d),
        "E flamingo mpc_rollout direct, slope":
            lambda: flamingo_roll(n_sample_e),
        "F hopper_3d simulate+ci_mpc_policy direct":
            lambda: hopper3d_roll(n_sample_f)}
    steps = {"E": n_sample_e, "F": n_sample_f}
    for name, period in paths.items():
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
        print(json.dumps({
            "path": name, "card": card, "lanes": 16,
            "steps": steps.get(name[0], 5),
            "wall_s": wall, "device_busy_s": busy,
            "device_busy_share_of_wall": busy / wall,
            "kernels_launched": sum(e.count for e in kernels),
            "knot_kernel_launches": sum(e.count for e in knot),
            "knot_kernel_device_ms": sum(e.self_device_time_total
                                         for e in knot) * 1e-3,
            "top_kernels_ms": [[e.key[:120], e.self_device_time_total * 1e-3]
                               for e in top]}), flush=True)


if __name__ == "__main__":
    main()
