"""A later PR adds a cell, a mix, a counter and a per-layer metric as new
files only: a copy of the benchmark with such files added, and none
changed, runs the new cell and reads the new metric from the new
counter."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RUN = """
import json, sys, time
sys.path.insert(0, '.')
import torch
torch.set_num_threads(1)
from benchmark.run import measure
from benchmark.tests.tiny import tiny_cell
cell = tiny_cell('quadruped-dummy', 'BENCHMARK.json')
cell.traffic.update(lanes=2, steps=25)   # traced: the profiler records every op
print(json.dumps(measure(cell, 5, 1.0, True, time.perf_counter(),
                         torch.device('cpu'))))
"""


def test_new_files_make_a_new_cell(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for package in ("contactimplicitmpc_tpu_torch", "contactimplicitmpc_tpu"):
        os.symlink(os.path.join(ROOT, package), root / package)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append(
        {"name": "quadruped-dummy", "config": "quadruped-flat",
         "traffic": "quadruped-dummy", "chips": 1,
         "why": "a test's cell: narrower poses, new files only"})
    bench["per_layer"].append(
        {"name": "knot_launches.dummy", "unit": "launches",
         "better": "lower", "source": "program_counter", "layer": "knot IP",
         "moves": "lane_steps_per_s", "workloads": ["quadruped-dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((root / "benchmark/traffic/quadruped-sweep.json")
                     .read_text())
    mix["draw"]["high"] = [x + 0.01 for x in mix["draw"]["low"]]
    (root / "benchmark/traffic/quadruped-dummy.json").write_text(
        json.dumps(mix))
    (root / "benchmark/limits/quadruped-dummy.json").write_text(
        (root / "benchmark/limits/quadruped-sweep.json").read_text())
    (root / "benchmark/counters/dummy_replays.json").write_text(json.dumps(
        {"read": "contactimplicitmpc_tpu_torch.sim.graphs:stats.replays"}))
    (root / "benchmark/metrics/knot_launches.dummy.py").write_text(
        "def read(ctx):\n    return ctx.counters['knot_ip.launches'] + 1"
        " + 0 * ctx.counters['dummy_replays']\n")

    out = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["metrics"]["knot_launches.dummy"]["value"] >= 1
    assert line["metrics"]["knot_launches.dummy"]["unit"] == "launches"
    for path, data in before.items():
        assert path.read_bytes() == data, path
