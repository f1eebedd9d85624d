"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: the program's own name begins with the JAX package's), the
reference loads nothing of the program, and without a GPU the command
prints no result."""

import os
import subprocess
import sys

from benchmark.harness.imports import forbidden_loaded

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def test_names_compared_whole():
    assert forbidden_loaded(["contactimplicitmpc_tpu_torch",
                             "contactimplicitmpc_tpu_torch.ops.ldl",
                             "jaxtyping", "numpy"]) == []
    assert forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen",
                             "contactimplicitmpc_tpu.control"]) == \
        ["contactimplicitmpc_tpu", "flax", "jax", "jaxlib"]


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": ROOT}, timeout=600)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    names = loaded_after(
        "import benchmark.run, benchmark.harness.judge, "
        "benchmark.harness.layers, benchmark.harness.drivers.sweep, "
        "benchmark.harness.drivers.realtime\n"
        "from benchmark.harness.spec import load_cell\n"
        "for c in ('quadruped-sweep', 'centroidal-sweep', 'quadruped-rt'):\n"
        "    cell = load_cell(c); cell.program(); cell.reference()")
    assert not forbidden_loaded(names)
    assert "contactimplicitmpc_tpu_torch" in names


def test_reference_loads_nothing_of_the_program():
    names = loaded_after(
        "from benchmark.harness.spec import load_cell\n"
        "for c in ('quadruped-sweep', 'centroidal-sweep'):\n"
        "    cell = load_cell(c)\n"
        "    ref = cell.reference().reference(cell.config)\n"
        "    ref.lin")
    assert not forbidden_loaded(names)
    assert "contactimplicitmpc_tpu_torch" not in names


def test_no_gpu_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "quadruped-sweep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "GPU" in out.stderr
