"""The MIQP wall-pendulum baseline on the port
(examples/torch_miqp_wallpendulum.py) against the JAX example's
(examples/miqp_wallpendulum.py), float64 on the CPU.

- ``make_wall_mpc`` at T = 20: the same number of mode sequences, and the
  same first control and cost for the same states to 1e-9 — the 50 states
  the JAX controller visits under each kick (from rest, the kick at t =
  20, through the wall contact and back). Not at arbitrary states: where the β-weighted hinge's active
  set is decided by rounding (states drawn at the domains' edges with large
  velocities), any change in the order of a sum picks another active set
  and moves u by up to ~0.5; the JAX example's own jitted and eager runs
  part there as far;
- tests/test_miqp.py's kick-rejection contract on the port, both kicks:
  ±15.5 at t = 20, 160 steps, |u| ≤ 4, max |θ| < 0.2, end |θ| < 0.06, end
  |θ̇| < 0.5;
- the example's ``main`` at T = 20 for 30 steps prints the JAX example's
  result lines.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

from miqp_wallpendulum import make_wall_mpc as jmake_wall_mpc  # noqa: E402
from torch_miqp_wallpendulum import main, make_wall_mpc  # noqa: E402

DT = 0.04


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


@pytest.fixture(scope="module")
def port():
    return make_wall_mpc(T=20, dt=DT, device="cpu")


def test_wall_mpc_matches_jax(port):
    """The same n_seq and threshold, and the same u (and cost) for the same
    states to 1e-9 (the cost relative to its scale)."""
    mpc_step, _, th, n_seq = port
    jmpc_step, jsim_step, jth, jn_seq = jmake_wall_mpc(T=20, dt=DT)
    assert n_seq == jn_seq and th == jth
    for kick in (-15.5, 15.5):
        x = jnp.array([0.0, 0.0])
        for t in range(50):
            if t == 20:
                x = x.at[1].add(kick * DT)
            u_want, cost_want = (float(v) for v in jmpc_step(x))
            u, cost = (float(v) for v in mpc_step(torch.tensor(np.asarray(x))))
            assert abs(u - u_want) <= 1e-9, (np.asarray(x), u, u_want)
            assert abs(cost - cost_want) <= 1e-9 * max(1.0, abs(cost_want)), \
                (np.asarray(x), cost, cost_want)
            x = jsim_step(x, u_want)


@pytest.mark.parametrize("kick", [-15.5, 15.5])
def test_wall_pendulum_rejects_kick(port, kick):
    """tests/test_miqp.py's contract, on the port."""
    mpc_step, sim_step, _, n_seq = port
    assert n_seq > 100
    x = torch.zeros(2, dtype=torch.float64)
    max_th = 0.0
    for t in range(160):
        if t == 20:
            x = x + torch.tensor([0.0, kick * DT], dtype=torch.float64)
        u, _ = mpc_step(x)
        assert abs(float(u)) <= 4.0 + 1e-9
        x = sim_step(x, float(u))
        max_th = max(max_th, abs(float(x[0])))
        assert bool(torch.isfinite(x).all()), t
    # stays inside the mode domains (walls at ±0.1, outer edge ±0.2) and
    # returns toward upright
    assert max_th < 0.2, max_th
    assert abs(float(x[0])) < 0.06, float(x[0])
    assert abs(float(x[1])) < 0.5, float(x[1])


def test_example_main(capsys):
    """The example's ``main`` at T = 20 through the first kick (30 steps)."""
    main(["--cpu", "--steps", "30", "--horizon", "20"])
    out = capsys.readouterr().out
    assert "wall pendulum MIQP: horizon 20, 729 mode sequences (≤2 " \
           "switches), dt=0.04 [cpu]" in out
    assert "solve time: mean" in out and "(control period 40 ms" in out
    assert "|θ| final" in out and "(wall at 0.10, domain edge 0.20)" in out
    assert "recovered upright through 5 pushes:" in out
