"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
at a tiny size: each ``main`` with ``--cpu``, two lanes or one, 5-10 sim
steps, its figure written to a temporary directory, and what it prints
checked for the JAX example's lines."""

import importlib.util
import os

import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples")


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


def example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_case(capsys, name, argv, lines, figures=(), tmp_path=None,
             cpu=True):
    """Run ``examples/<name>.py``'s ``main`` with ``argv`` (and ``--cpu``
    where ``cpu``; each ``(flag, file)`` of ``figures`` written into
    ``tmp_path`` where it is given) and check that every one of ``lines``,
    the JAX example's result lines, is in what it prints, with the
    device's tag; returns what it printed."""
    args = (["--cpu"] if cpu else []) + list(argv)
    for flag, file in figures if tmp_path is not None else ():
        args += [flag, str(tmp_path / file)]
    example(name).main(args)
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, (line, out)
    assert ("[cpu]" in out) == cpu, out
    if tmp_path is not None:
        for _, file in figures:
            assert (tmp_path / file).stat().st_size > 0, file
            assert f"wrote {tmp_path / file}" in out
    return out


def test_quadruped_monte_carlo(tmp_path, capsys):
    png = tmp_path / "runs.png"
    example("torch_quadruped_monte_carlo").main(
        ["--cpu", "--n", "2", "--steps", "5", "--png", str(png)])
    out = capsys.readouterr().out
    assert "(1 device(s), mesh (1, 1)) [cpu]" in out
    assert "runs: 2  success rate: 1.000" in out
    assert "MPC solves/s" in out and "tracking over successful runs" in out
    assert png.stat().st_size > 0
    assert not torch.distributed.is_initialized()


def test_hopper_monte_carlo(capsys):
    example("torch_hopper_monte_carlo").main(
        ["--cpu", "--runs", "2", "--steps", "5"])
    out = capsys.readouterr().out
    assert "2 runs x 5 steps in" in out and "[cpu]" in out
    assert "solver success rate: 1.00" in out


def test_point_foot_push(tmp_path, capsys):
    gif = tmp_path / "stand.gif"
    example("torch_point_foot_trot").main(
        ["--cpu", "--gait", "stand_v0", "--steps", "10", "--push", "--gif",
         str(gif)])
    out = capsys.readouterr().out
    assert "sim converged: 1.000" in out
    assert "x real time [cpu]" in out and "tracking: q=" in out
    assert gif.stat().st_size > 0
