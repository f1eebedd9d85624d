"""tools/torch_scaling_report.py's leg of two gloo processes on the CPU
under torchrun: a 2-lane, 5-step quadruped sweep split over the two ranks
succeeds, and rank 0 reports the mesh's two ranks."""

import argparse

import pytest
import torch

from test_torch_tools import tool


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


def test_two_process_leg():
    args = argparse.Namespace(batch=2, steps=5, reps=1, cpu=True,
                              timeout=600.0)
    got = tool("torch_scaling_report").leg(2, args)
    assert got["leg"] == 2 and got["success"] == 1.0
    assert got["solves_per_s"] > 0
