"""The port's two tools on the CPU at a tiny size:
tools/torch_kkt_solver_bench.py (the LDLᵀ against ``solve_ex`` on synthetic
SQD KKTs: both backends solve, and agree) and tools/torch_scaling_report.py
(its leg of one gloo process under torchrun, a 2-lane, 5-step quadruped
sweep: it succeeds and the table has its row). The leg of two processes is
tests/test_torch_scaling_leg.py's, a file of its own so that each file's
processes stay short."""

import importlib.util
import os

import pytest
import torch

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every test here, and the module's fixtures, run PyTorch on one
    thread: a batched LAPACK factorization (the pivoted-LU KKT backend) does
    not return on some CPU builds under a thread count between 2 and the
    core count, and one thread a test process keeps the processes from
    competing for the cores. Set here, not at import: a test process
    imports every test file, and the last import would win."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_kkt_solver_bench(capsys):
    """Both backends at n = 60 (the signature's primal half), n = 300 (the
    quadruped's 190 primal rows) and n = 480 (the centroidal quadruped's
    300), batch 3: relative residuals and the backends' agreement under 1e-4
    (float32), times positive."""
    results = tool("torch_kkt_solver_bench").main(
        ["--cpu", "--n", "60,300,480", "--batch", "3", "--reps", "1"])
    out = capsys.readouterr().out
    assert "n=300 batch=3: ldl" in out and "[cpu]" in out
    assert '"kkt_solver_bench"' in out
    assert [(r["n"], r["batch"]) for r in results] == [
        (60, 3), (300, 3), (480, 3)]
    for r in results:
        assert r["ldl_ms"] > 0 and r["lu_ms"] > 0
        assert r["ldl_rel_residual"] < 1e-4 and r["lu_rel_residual"] < 1e-4
        assert r["agreement"] < 1e-4


def test_scaling_report(capsys):
    legs = tool("torch_scaling_report").main(
        ["--cpu", "--n", "1", "--batch", "2", "--steps", "5", "--reps", "1",
         "--timeout", "600"])
    out = capsys.readouterr().out
    assert list(legs) == [1]
    assert legs[1]["leg"] == 1 and legs[1]["success"] == 1.0
    assert legs[1]["solves_per_s"] > 0
    assert "| devices | solves/s | solves/s/device | parallel efficiency " \
           "| success |" in out
    assert "| 1 |" in out and "| 1.00 | 1.000 |" in out
    assert "CPU processes (gloo)" in out and "devices=1:" in out
