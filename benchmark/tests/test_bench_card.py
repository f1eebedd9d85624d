"""On the card: each cell's command, a short window, prints a line that is
correct and names the card (run with ``python -m pytest -m cuda
benchmark/tests/test_bench_card.py``)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["quadruped-sweep", "centroidal-sweep",
                                  "quadruped-rt"])
def test_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 21), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"].startswith("NVIDIA")
