"""The port's flamingo and 3D-hopper examples end to end on the CPU at a
tiny size (one lane, one or two control periods): the flamingo on flat
ground and up the slope, the 3D hopper on flat ground; each ``main`` with
``--cpu``, and what it prints checked for the JAX example's result lines."""

import pytest
import torch

from test_torch_examples import run_case


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


CASES = [
    pytest.param("torch_flamingo_flat", ["--steps", "5"],
                 ["first run:", "sim converged: 1.000", "tracking: q=",
                  "walked", "x real time"], [("--gif", "flamingo.gif")],
                 id="flamingo_flat"),
    pytest.param("torch_flamingo_slope", ["--steps", "5"],
                 ["sim converged: True", "(up the slope); min torso clearance",
                  "for 5 steps, float64"], (), id="flamingo_slope"),
    pytest.param("torch_hopper3d_flat", ["--steps", "10"],
                 ["status=True tracking: q=", "x: ", "speed ratio",
                  "x realtime, float64"],
                 [("--gif", "hopper3d.gif")], id="hopper3d_flat"),
]


@pytest.mark.parametrize("name,argv,lines,figures", CASES)
def test_example_on_cpu(name, argv, lines, figures, tmp_path, capsys):
    run_case(capsys, name, argv, lines, figures, tmp_path)
