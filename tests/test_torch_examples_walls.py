"""The port's walled-cartpole and pushbot push-recovery examples end to end
on the CPU at a tiny size (one lane, 10 sim steps, before the first
scripted impulse): each ``main`` with ``--cpu``, and what it prints checked
for the JAX example's result lines."""

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
    pytest.param("torch_cartpole_wall", ["--steps", "10"],
                 ["first run:", "sim converged: True", "max |cart x|:",
                  "max |pole angle|:", "x real time"], (), id="cartpole_wall"),
    pytest.param("torch_pushbot_push_recovery", ["--steps", "10"],
                 ["first run:", "sim converged: True", "max |angle|:",
                  "final |angle|:", "x real time"], (), id="pushbot"),
]


@pytest.mark.parametrize("name,argv,lines,figures", CASES)
def test_example_on_cpu(name, argv, lines, figures, tmp_path, capsys):
    run_case(capsys, name, argv, lines, figures, tmp_path)
