"""The benchmark's own tests: CPU runs of the harness at a size a test run
holds, on the program's plain path. A test marked ``cuda`` needs the card
and decides so inside its fixture."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one thread in every test (a batched LAPACK LU does not
    return on some CPU builds under 2 to 4 threads), set here and not at
    import."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda", 0)
