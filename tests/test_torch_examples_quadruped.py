"""The port's quadruped examples end to end on the CPU at a tiny size (one
lane, one control period of 5 sim steps): flat ground (with its mesh
animation), both terrains with altitude discovery, and the unmodeled
payload; each ``main`` with ``--cpu``, and what it prints checked for the
JAX example's result lines."""

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
    pytest.param("torch_quadruped_flat", ["--steps", "5"],
                 ["first run:", "sim converged: 1.000", "tracking: q=",
                  "sim steps/s)"], [("--mesh-gif", "mesh.gif")], id="flat"),
    pytest.param("torch_quadruped_terrain", ["--steps", "5"],
                 ["sim converged: 1.000",
                  "forward progress on piecewise:", "over 5 steps"],
                 [("--gif", "terrain.gif")], id="piecewise"),
    pytest.param("torch_quadruped_terrain", ["--steps", "5", "--terrain",
                                             "sine"],
                 ["sim converged: 1.000", "forward progress on sine:"], (),
                 id="sine"),
    pytest.param("torch_quadruped_payload", ["--steps", "5"],
                 ["sim converged: 1.000", "tracking under 3 kg payload: q=",
                  "x real time"], (), id="payload"),
]


@pytest.mark.parametrize("name,argv,lines,figures", CASES)
def test_example_on_cpu(name, argv, lines, figures, tmp_path, capsys):
    run_case(capsys, name, argv, lines, figures, tmp_path)
