"""The port's centroidal-quadruped examples end to end on the CPU at a tiny
size (one lane, 10 sim steps): the box push, the stand under a push, the
trot (with its mesh animation) and the wall slide (both walls, with its
animation); each ``main`` with ``--cpu``, and what it prints checked for the
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
    pytest.param("torch_centroidal_box_push", ["--steps", "10"],
                 ["first run:", "sim converged: 1.000", "tracking q_err:",
                  "min foot-to-box gap:", "x real time"], (), id="box_push"),
    pytest.param("torch_centroidal_stand", ["--steps", "10"],
                 ["first run:", "sim converged: 1.000",
                  "body drift after push: y=", "x real time"], (),
                 id="stand"),
    pytest.param("torch_centroidal_trot", ["--steps", "10"],
                 ["first run:", "sim converged: 1.000", "tracking: q=",
                  "newton iters/ctrl:", "ip iters/step:", "x real time"],
                 [("--mesh-gif", "mesh.gif")], id="trot"),
    pytest.param("torch_centroidal_wall_sim", ["--steps", "10"],
                 ["sim status: True", "wall at x = 0.25; max foot x = 0.2500",
                  "feet at rest: max |v_x| last step ="],
                 [("--gif", "wall.gif")], id="wall_sim"),
    pytest.param("torch_centroidal_wall_sim", ["--steps", "10", "--slanted"],
                 ["sim status: True", "wall at x = 1.0; max foot x ="], (),
                 id="wall_sim_slanted"),
]


@pytest.mark.parametrize("name,argv,lines,figures", CASES)
def test_example_on_cpu(name, argv, lines, figures, tmp_path, capsys):
    run_case(capsys, name, argv, lines, figures, tmp_path)
