"""The port's 2D/3D hopper terrain, parkour and Raibert examples end to end
on the CPU at a tiny size (one lane, or the five commands of the Raibert
sweep; 10-20 sim steps): each ``main`` with ``--cpu``, and what it prints
checked for the JAX example's result lines."""

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
    pytest.param("torch_hopper_terrain", ["--steps", "10"],
                 ["sine: steps=10 convergence=1.0000",
                  "piecewise: steps=10 convergence=1.0000",
                  "sine3d: steps=10 convergence=1.0000"],
                 [("--gif", "terrain.gif")], id="hopper_terrain"),
    pytest.param("torch_hopper_parkour", ["--steps", "20"],
                 ["first run:", "sim converged: 1.000", "hopper reached x="],
                 [("--gif", "parkour.gif")], id="hopper_parkour"),
    pytest.param("torch_hopper_raibert", ["--steps", "10"],
                 ["v0=+0.20: status=True", "v0=+0.40: status=True",
                  "5 rollouts x 10 steps in"], [("--gif", "raibert.gif")],
                 id="hopper_raibert"),
    pytest.param("torch_raibert_variants", ["--steps", "10"],
                 ["flat3d: steps=10 convergence=1.0000",
                  "sine2d: steps=10 convergence=1.0000",
                  "sine3d: steps=10 convergence=1.0000",
                  "piecewise: steps=10 convergence=1.0000", "avg v="],
                 [("--gif", "variants.gif")], id="raibert_variants"),
]


@pytest.mark.parametrize("name,argv,lines,figures", CASES)
def test_example_on_cpu(name, argv, lines, figures, tmp_path, capsys):
    run_case(capsys, name, argv, lines, figures, tmp_path)
