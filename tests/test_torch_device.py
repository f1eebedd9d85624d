"""The port's entry points default to the GPU: with ``device`` left out
and no GPU they raise, and never carry on on the CPU; ``device="cpu"`` is
what a caller passes to run on the CPU."""

import collections

import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control.objective import (
    tracking_objective, tracking_velocity_objective)
from contactimplicitmpc_tpu_torch.control.trajectory import (
    contact_trajectory, from_gait)
from contactimplicitmpc_tpu_torch.hotpath import (HotPathConfig,
                                                  make_quadruped_rollout,
                                                  quadruped_tracking_weights)
from contactimplicitmpc_tpu_torch.models.base import dims_of
from contactimplicitmpc_tpu_torch.models.centroidal_quadruped import \
    relative_state_cost
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

DIMS = dims_of(quadruped, pt.flat_2d_lc)
Pair = collections.namedtuple("Pair", "a b")
Q = torch.zeros(2, DIMS.nq)


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


def played(pair, *args):
    """The first input a policy or disturbance gives two CPU lanes."""
    init_state, apply = pair
    return apply(init_state(2), *args)[0]


ENTRY_POINTS = {
    "make_quadruped_rollout": lambda **kw: make_quadruped_rollout(
        HotPathConfig(), 5, torch.float32, **kw)[1].q,
    "from_gait": lambda **kw: from_gait(
        quadruped, pt.flat_2d_lc, load_gait("quadruped", "gait2"),
        dtype=torch.float32, **kw).q,
    "tracking_objective": lambda **kw: tracking_objective(
        DIMS, 10, q=np.ones(DIMS.nq), **kw).q,
    "quadruped_tracking_weights": lambda **kw: quadruped_tracking_weights(
        DIMS, 10, torch.float32, **kw).q,
    "tracking_velocity_objective": lambda **kw: tracking_velocity_objective(
        DIMS, 10, v=np.ones(DIMS.nq), **kw).v,
    "contact_trajectory": lambda **kw: contact_trajectory(
        DIMS, 4, 0.01, **kw).theta,
    "relative_state_cost": lambda **kw: relative_state_cost(
        np.ones(3), np.ones(3), np.ones(3), **kw),
    "open_loop_policy": lambda **kw: played(pt.open_loop_policy(
        np.ones((3, DIMS.nu)), **kw), pt.PolicyObs(Q, Q, Q[:, :4], 0)),
    "open_loop_disturbances": lambda **kw: played(pt.open_loop_disturbances(
        np.ones((3, DIMS.nw)), **kw), Q, 0),
    "impulse_disturbances": lambda **kw: played(pt.impulse_disturbances(
        np.ones((1, DIMS.nw)), [0], **kw), Q, 0),
    "random_disturbances": lambda **kw: played(pt.random_disturbances(
        None, quadruped, 1.0, 3, **kw), Q, 0),
    "interop.tensors": lambda **kw: interop.tensors(
        Pair, Pair(a=np.zeros(3), b=np.ones(2)), **kw).a,
}


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        pt.default_device()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_gpu(no_gpu, name):
    """No GPU and no ``device``: the entry point raises and hands back no
    tensor made on the CPU."""
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_takes_cpu_when_asked(no_gpu, name):
    assert ENTRY_POINTS[name](device="cpu").device.type == "cpu"
